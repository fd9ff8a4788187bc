"""The torch port's speculative decode against the JAX reference and
against its own plain decode.

  * ``append_window`` / ``commit_window`` on the same ragged cache (the
    reference's ``PLENS`` rows, ``N_WARM`` appends so row 0's seed append
    flushes) leave every leaf byte-exact with the reference's, dense and
    paged (zero-points under the FMA rule).
  * ``verify_steps`` against the port's stepwise ``decode_step`` fed the
    same window: ``hat`` on every valid position and every live byte of
    the committed cache bitwise equal, over {packkv, none} x {dense, paged}
    x w in {2, 5} (backend ``fused``: the plain kernel versions on the
    CPU). The stepwise steps run at the window's height (``rows = w``) as
    the engine runs them.
  * ``verify_steps`` against the reference's ``xla`` verify on the port's
    warm cache: ``n_accept`` equal, ``hat`` equal wherever the stepwise
    logits' top-2 margin is at least LOGIT_ATOL, every integer leaf of the
    committed cache byte-exact.
  * ``SlotServer`` with speculation equals it without, per request
    bitwise, over {packkv, none} x {dense, paged, prefix}, under a drafter
    replaying the plain outputs with every third proposal corrupted (full,
    partial and zero acceptance); on dense packkv the speculative counters
    and tokens equal the reference ``SlotServer``'s.
  * ``NGramDrafter.draft`` and ``StragglerMonitor.observe`` equal the
    reference's; an injected monitor degrades the server without changing
    its outputs; ``spec_k = 0`` and a family without a verify pass are
    refused; ``launch/serve.py --spec-decode`` runs.

Mirrors ``tests/test_spec_decode.py``. The reference runs compiled without
excess precision (``torch_port_helpers.EXACT``)."""
import contextlib
import copy
import dataclasses
import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.data import synthetic_kv
from repro.distributed.fault import StragglerMonitor as JMonitor
from repro.serving import engine as je
from repro_torch.convert import layer_cache_to_numpy
from repro_torch.core import cache as tc
from repro_torch.distributed import StragglerMonitor
from repro_torch.models import get_model
from repro_torch.serving import engine as te
from torch_port_helpers import (
    EXACT,
    LOGIT_ATOL,
    assert_cache_equal,
    jit_exact,
    margin,
    ref_cache_arrays,
    ref_cache_to_torch,
    steps_before_tie,
)
from torch_threads import one_torch_thread  # noqa: F401

B, CAP, R = 3, 256, 96
PLENS = (191, 131, 156)  # post-prefill residuals 63 / 3 / 28
N_WARM = 33  # pushes row 0 to n_resid == R: the verify seed append flushes
PAGE = 128
H, D = 2, 64  # the cache-op tests' heads and head dim


# ---------------------------------------------------------------------------
# cache ops: append_window / commit_window
# ---------------------------------------------------------------------------


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _torch_bf16(a):
    return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)


@pytest.mark.parametrize("paged", [False, True])
def test_append_commit_window_byte_exact(paged):
    """The reference's ragged rows, N_WARM appends, then a w=5 window with
    lens (5, 2, 4): row 0's seed flushes (paged: pops a page), drafts land
    masked, and the commit of (4, 0, 1) leaves every leaf byte-exact."""
    jcfg = jc.PackKVConfig(residual=R, paged=paged, page_size=PAGE)
    k0 = _bf16(synthetic_kv(np.random.default_rng(7), 1, H, 128, D))
    jcfg = jc.calibrate_specs(jnp.asarray(k0), jnp.asarray(k0), jcfg)
    tcfg = tc.PackKVConfig(residual=R, paged=paged, page_size=PAGE,
                           k_spec_static=tc.TierSpec(*_spec(jcfg.k_spec_static)),
                           v_spec_static=tc.TierSpec(*_spec(jcfg.v_spec_static)))
    fma = ((jcfg.k_quant().max_q + 1) // 2, (jcfg.v_quant().max_q + 1) // 2)
    rng = np.random.default_rng(3)
    jcache = jc.alloc_layer_cache(jcfg, B, H, D, CAP)
    insert = jit_exact(jc.insert_prefill)
    for r, n in enumerate(PLENS):
        kv = jnp.asarray(_bf16(synthetic_kv(rng, 1, H, n, D))[0])
        jcache = insert(jcache, r, kv, kv[:, ::-1])
    tcache = ref_cache_to_torch(jcache, tcfg)
    append = jit_exact(jc.append_token)
    for _ in range(N_WARM):
        s = _bf16(rng.normal(size=(B, H, 1, D)))
        jcache = append(jcache, jnp.asarray(s), jnp.asarray(-s))
        tc.append_token(tcache, _torch_bf16(s), -_torch_bf16(s))
    assert int(tcache.n_resid[0]) == R
    assert_cache_equal(tcache, jcache, fma)

    w = 5
    lens = np.array([5, 2, 4], np.int32)
    kw = _bf16(rng.normal(size=(B, H, w, D)))
    jcache = jit_exact(jc.append_window)(jcache, jnp.asarray(kw), jnp.asarray(-kw),
                                         jnp.asarray(lens))
    tc.append_window(tcache, _torch_bf16(kw), -_torch_bf16(kw), torch.from_numpy(lens))
    assert int(tcache.n_comp[0]) == PLENS[0] // 64 * 64 + 64  # the seed flushed
    assert_cache_equal(tcache, jcache, fma)
    n_accept = np.array([4, 0, 1], np.int32)
    jcache = jit_exact(jc.commit_window)(jcache, jnp.asarray(n_accept))
    tc.commit_window(tcache, torch.from_numpy(n_accept))
    assert_cache_equal(tcache, jcache, fma)
    np.testing.assert_array_equal(tcache.n_resid.numpy(), [R - 64 + 1 + 4, 3 + N_WARM + 1,
                                                           28 + N_WARM + 1 + 1])


def _spec(s):
    return (s.widths, s.counts, s.pack_size)


# ---------------------------------------------------------------------------
# model level: verify_steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    from repro.configs import get_arch as j_get_arch
    from repro.models import get_model as j_get_model
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy

    cfg = j_get_arch("llama2-7b", smoke=True)
    # compiled: the reference's init op by op takes seconds
    jparams = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch("llama2-7b", smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


def _pack(policy, paged):
    return tc.PackKVConfig(policy=policy, residual=R, paged=paged, page_size=PAGE)


def _warm(tcfg, tparams, pack, w):
    """The reference test's ragged slot cache in the port, advanced N_WARM
    greedy steps at the window's height; returns (cache, last token [B])."""
    api = get_model(tcfg)
    rng = np.random.default_rng(0)
    cache = api.alloc_cache(tcfg, pack, B, CAP, "cpu")
    last = np.zeros((B,), np.int32)
    for i, plen in enumerate(PLENS):
        toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (1, plen)))
        lg, cache = api.prefill_into_slot(tparams, tcfg, pack, CAP, cache, i,
                                          {"tokens": toks})
        last[i] = int(lg[0].argmax())
    for _ in range(N_WARM):
        lg, cache = api.decode_step(tparams, tcfg, cache, torch.from_numpy(last[:, None]),
                                    rows=w)
        last = lg.argmax(-1).numpy().astype(np.int32)
    return cache, last


def _window(tcfg, tparams, cache, seed, w):
    """The reference test's window: row 0 every draft correct, row 1 its
    first draft wrong, row 2 one correct then wrong (w = 2: seed only).
    Returns (tokens [B, w], lens, the expected n_accept, the stepwise run
    fed those tokens: (hat [B, w], logits [w][B, V], cache after each
    step))."""
    api = get_model(tcfg)
    step = lambda c, t: api.decode_step(tparams, tcfg, c, torch.from_numpy(t[:, None]), rows=w)
    c, t, chain = copy.deepcopy(cache), seed, []
    for _ in range(w):
        lg, c = step(c, t)
        t = lg.argmax(-1).numpy().astype(np.int32)
        chain.append(t)
    wrong = (np.stack(chain, 1) + 1) % tcfg.vocab  # never the greedy pick
    toks = np.zeros((B, w), np.int32)
    toks[:, 0] = seed
    for j in range(w - 1):
        toks[0, 1 + j] = chain[j][0]
        toks[1, 1 + j] = wrong[1, j]
        toks[2, 1 + j] = chain[j][2] if j == 0 else wrong[2, j]
    lens = np.array([w, 2, min(4, w) if w > 2 else 1], np.int32)
    want_accept = np.array([w - 1, 0, 1 if w > 2 else 0], np.int32)
    hat, logits, snaps, c = np.zeros((B, w), np.int32), [], [], copy.deepcopy(cache)
    for j in range(w):
        lg, c = step(c, toks[:, j])
        hat[:, j] = lg.argmax(-1).numpy()
        logits.append(lg.numpy())
        snaps.append(copy.deepcopy(c))
    return toks, lens, want_accept, (hat, logits, snaps)


def _assert_row_equal(got, want, i):
    """Row ``i`` of two per-layer caches bitwise equal over all LIVE state:
    counters, the compressed region (paged: the row's pages and the
    ledger) and the residual up to ``n_resid`` (rejected drafts are dead
    bytes past it, which the stepwise run never wrote)."""
    for g, w_ in zip(got, want):
        assert int(g.n_comp[i]) == int(w_.n_comp[i]) and int(g.n_resid[i]) == int(w_.n_resid[i])
        ga, wa = layer_cache_to_numpy(g), layer_cache_to_numpy(w_)
        for name in ("k", "v"):
            if ga[name] is None:
                continue
            for key in ("chan_perm", "scale", "zero"):
                _eq(ga[name][key], wa[name][key], g.pages, i, name + key)
            for tg, tw in zip(ga[name]["tiers"], wa[name]["tiers"]):
                for key in ("payload", "mins", "shifts"):
                    _eq(tg[key], tw[key], g.pages, i, name + key)
        for name in ("raw_k", "raw_v"):
            if ga[name] is not None:
                _eq(ga[name], wa[name], g.pages, i, name)
        if g.pages is not None:
            for key in ("page_table", "free", "n_free", "ref"):
                np.testing.assert_array_equal(ga["pages"][key], wa["pages"][key], key)
        r = int(g.n_resid[i])
        for name in ("resid_k", "resid_v"):
            np.testing.assert_array_equal(ga[name][i, :, :r].view(np.uint16),
                                          wa[name][i, :, :r].view(np.uint16), name)


def _eq(a, b, pages, i, what):
    """Row ``i``'s leaf (paged: the whole pool, whose pages only this
    test's rows write) bitwise equal."""
    a, b = (a, b) if pages is not None or a.ndim < 2 else (a[i], b[i])
    np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                  np.atleast_1d(b).view(np.uint8), what)


@pytest.mark.parametrize("w", [2, 5])
@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_verify_matches_stepwise_decode(smoke, policy, mode, w):
    """hat on every valid position and the committed cache equal the
    stepwise decode_step run fed the same tokens, bit for bit."""
    _, _, tcfg, tparams = smoke
    pack = _pack(policy, mode == "paged")
    cache, seed = _warm(tcfg, tparams, pack, w)
    assert int(cache[0].n_resid[0]) == R  # the seed append flushes row 0
    toks, lens, want_accept, (ref_hat, _, snaps) = _window(tcfg, tparams, cache, seed, w)
    hat, n_accept, committed = get_model(tcfg).decode_verify(
        tparams, tcfg, cache, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.ones(B, dtype=torch.bool))
    np.testing.assert_array_equal(n_accept.numpy(), want_accept)
    for i in range(B):
        np.testing.assert_array_equal(hat[i, :lens[i]].numpy(), ref_hat[i, :lens[i]],
                                      err_msg=f"row {i}")
        _assert_row_equal(committed, snaps[int(n_accept[i])], i)


def _to_ref(tcache, jtmpl):
    """The port's per-layer caches as the reference's stacked cache (the
    structure of ``jtmpl``)."""
    arrs = [layer_cache_to_numpy(layer) for layer in tcache]
    st = lambda get: jnp.asarray(np.stack([get(a) for a in arrs]))

    def tiered(jt, key):
        if jt is None:
            return None
        tiers = tuple(dataclasses.replace(t, **{
            f: st(lambda a, j=j, f=f: a[key]["tiers"][j][f])
            for f in ("payload", "mins", "shifts")}) for j, t in enumerate(jt.tiers))
        return dataclasses.replace(jt, tiers=tiers, **{
            f: st(lambda a, f=f: a[key][f]) for f in ("chan_perm", "scale", "zero")})

    opt = lambda f: None if arrs[0][f] is None else st(lambda a: a[f])
    pages = jtmpl.pages
    if pages is not None:
        pages = dataclasses.replace(pages, **{
            f: st(lambda a, f=f: a["pages"][f]) for f in ("page_table", "free", "n_free", "ref")})
    return dataclasses.replace(
        jtmpl, k=tiered(jtmpl.k, "k"), v=tiered(jtmpl.v, "v"), raw_k=opt("raw_k"),
        raw_v=opt("raw_v"), pages=pages,
        **{f: st(lambda a, f=f: a[f]) for f in ("resid_k", "resid_v", "n_comp", "n_resid")})


@pytest.mark.parametrize("paged", [False, True])
def test_verify_matches_reference(smoke, paged):
    """The port's warm cache carried into the reference, the same w=5
    window verified by both: n_accept equal, hat equal wherever the
    stepwise logits' top-2 margin is at least LOGIT_ATOL, every integer
    leaf of the committed cache byte-exact (the float residual bytes are
    each package's own K/V, an ulp apart past layer 0)."""
    from repro.models import get_model as j_get_model

    cfg, jparams, tcfg, tparams = smoke
    w = 5
    pack = _pack("packkv", paged)
    cache, seed = _warm(tcfg, tparams, pack, w)
    toks, lens, want_accept, (_, logits, _) = _window(tcfg, tparams, cache, seed, w)
    japi = j_get_model(cfg)
    jtmpl = japi.alloc_cache(cfg, jc.PackKVConfig(residual=R, paged=paged, page_size=PAGE),
                             B, CAP)
    jcache = _to_ref(cache, jtmpl)
    verify = jit_exact(partial(japi.decode_verify, cfg=cfg, backend="xla"),
                       static_argnames=("n_bucket",))
    jhat, jn, jcommitted = verify(jparams, cache=jcache, tokens=jnp.asarray(toks),
                                  lens=jnp.asarray(lens), active=jnp.ones((B,), bool),
                                  n_bucket=None)
    hat, n_accept, committed = get_model(tcfg).decode_verify(
        tparams, tcfg, cache, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.ones(B, dtype=torch.bool))
    np.testing.assert_array_equal(n_accept.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(n_accept.numpy(), want_accept)
    compared = 0
    for i in range(B):
        for j in range(lens[i]):
            if margin(logits[j][i]) >= LOGIT_ATOL:
                assert int(hat[i, j]) == int(np.asarray(jhat)[i, j]), (i, j)
                compared += 1
    assert compared >= 8, compared
    want = ref_cache_arrays(jcommitted)
    for li, layer in enumerate(committed):
        got = layer_cache_to_numpy(layer)
        for name in ("k", "v"):
            for key in ("chan_perm",):
                np.testing.assert_array_equal(got[name][key], want[name][key][li])
            for tg, tw in zip(got[name]["tiers"], want[name]["tiers"]):
                for key in ("payload", "mins", "shifts"):
                    np.testing.assert_array_equal(tg[key], tw[key][li], f"{name}.{key}")
        for key in ("n_comp", "n_resid"):
            np.testing.assert_array_equal(got[key], want[key][li], key)
        if paged:
            for key in ("page_table", "free", "n_free", "ref"):
                np.testing.assert_array_equal(got["pages"][key], want["pages"][key][li], key)


# ---------------------------------------------------------------------------
# serving: spec == plain
# ---------------------------------------------------------------------------


class _CorruptReplay:
    """Test drafter: replays a plain run's outputs but corrupts every third
    proposal, so verify passes see full accepts, partial accepts and full
    rejections (draft content moves only the acceptance rate)."""

    def __init__(self, ref: dict, vocab: int):
        self._ref = ref  # {tuple(prompt): plain-run output tokens}
        self._vocab = vocab
        self._pos: dict[int, list] = {}

    def seed(self, slot, tokens):
        toks = [int(t) for t in tokens]
        self._pos[slot] = [self._ref.get(tuple(toks[:-1]), []), 1]

    def extend(self, slot, tokens):
        self._pos[slot][1] += len(tuple(tokens))

    def drop(self, slot):
        self._pos.pop(slot, None)

    def draft(self, slot, k):
        stream, cur = self._pos[slot]
        return [(t + 1) % self._vocab if (cur + j) % 3 == 0 else int(t)
                for j, t in enumerate(stream[cur:cur + k])]


def _reqs(cls, vocab):
    r = np.random.default_rng(5)
    shared = r.integers(0, vocab, PAGE)  # one full page for the prefix index
    mk = lambda rid, n, mn: cls(rid=rid, max_new=mn,
                                tokens=np.concatenate([shared, r.integers(0, vocab, n)]))
    return [mk(0, 70, 10), mk(1, 40, 8), mk(2, 100, 12)]


def _serve(eng, reqs, **kw):
    srv = (te.SlotServer if isinstance(eng, te.Engine) else je.SlotServer)(eng, **kw)
    for r in reqs:
        srv.submit(r)
    srv.run()
    return srv


KW = dict(capacity=512, max_batch=2, calib_tokens=128, decode_chunk=4, bucketed=True,
          bucket_unit=64, page_size=PAGE, spec_k=3, spec_backoff=0)


def _engines(smoke, policy, mode):
    """(plain, speculative) port engines at the same spec_k (the decode
    GEMMs' height) and calibrated specs."""
    _, _, tcfg, tparams = smoke
    paged = mode != "dense"
    ecfg = te.EngineConfig(device="cpu", paged=paged, prefix_cache=mode == "prefix",
                           debug_invariants=paged, **KW)
    plain = te.Engine(tcfg, tparams, tc.PackKVConfig(policy=policy), ecfg)
    spec = te.Engine(tcfg, tparams, plain.pack_cfg,
                     dataclasses.replace(ecfg, calibrate=False, spec_decode=True))
    return plain, spec


def _replay(srv, vocab):
    return _CorruptReplay({tuple(int(t) for t in r.tokens): r.output
                           for r in srv.done.values()}, vocab)


@pytest.mark.parametrize("mode", ["dense", "paged", "prefix"])
@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_spec_serving_matches_plain(smoke, policy, mode):
    tcfg = smoke[2]
    plain, spec = _engines(smoke, policy, mode)
    a = _serve(plain, _reqs(te.Request, tcfg.vocab))
    assert a.stats.spec_launches == 0
    b = _serve(spec, _reqs(te.Request, tcfg.vocab), drafter=_replay(a, tcfg.vocab))
    s = b.stats
    assert s.spec_launches > 0 and 0 < s.spec_accepted < s.spec_drafted
    assert s.tokens_out == a.stats.tokens_out and s.decode_steps < a.stats.decode_steps
    for rid in a.done:
        np.testing.assert_array_equal(a.done[rid].output, b.done[rid].output,
                                      err_msg=f"rid {rid}")
    if mode != "dense":
        for layer in b.cache:  # every page is back, but the index's
            held = b._index.n_held if b._index is not None else 0
            assert int(layer.pages.n_free) == layer.pages.n_pool_pages - held


def _spec_stats(s):
    return (s.spec_launches, s.spec_drafted, s.spec_accepted, s.decode_steps,
            s.chunk_launches, s.tokens_out, s.completed)


class _NoDraft(_CorruptReplay):
    """Never proposes: every launch of a speculative server runs plain."""

    def __init__(self):
        super().__init__({}, 1)


def test_spec_scheduler_matches_reference(smoke):
    """Dense packkv, each package's replay drafter fed its own plain
    outputs (its speculative server with a drafter that never proposes):
    acceptance depends only on which proposals are corrupted, so the
    reference SlotServer's verify passes, drafts, acceptances, steps and
    token counts equal the port's, and the tokens are equal until the
    port's first near-tie (the margin rule)."""
    cfg, jparams, tcfg, _ = smoke
    plain, spec = _engines(smoke, "packkv", "dense")
    a = _serve(spec, _reqs(te.Request, tcfg.vocab), drafter=_NoDraft())
    assert a.stats.spec_launches == 0
    b = _serve(spec, _reqs(te.Request, tcfg.vocab), drafter=_replay(a, tcfg.vocab))
    ts = spec.pack_cfg
    jspec = lambda s: jc.TierSpec(s.widths, s.counts, s.pack_size)
    jpack = jc.PackKVConfig(k_spec_static=jspec(ts.k_spec_static),
                            v_spec_static=jspec(ts.v_spec_static))

    def lane_jit(self, fn, *, static=(), donate=()):
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.Engine, "_lane_jit", lane_jit)
        jeng = je.Engine(cfg, jparams, jpack, je.EngineConfig(
            backend="xla", calibrate=False, spec_decode=True, **KW))
    c0 = _serve(jeng, _reqs(je.Request, cfg.vocab), drafter=_NoDraft())
    c = _serve(jeng, _reqs(je.Request, cfg.vocab), drafter=_replay(c0, cfg.vocab))
    assert _spec_stats(a.stats) == _spec_stats(c0.stats)
    assert _spec_stats(b.stats) == _spec_stats(c.stats)
    assert 0 < b.stats.spec_accepted < b.stats.spec_drafted
    compared = 0
    for r in _reqs(te.Request, tcfg.vocab):
        _, n = steps_before_tie(plain, r.tokens, r.max_new)
        np.testing.assert_array_equal(b.done[r.rid].output[:n],
                                      np.asarray(c.done[r.rid].output)[:n])
        compared += n
    assert compared >= 8, compared


# ---------------------------------------------------------------------------
# drafter, watchdog, refusals, CLI
# ---------------------------------------------------------------------------


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(200):
        seq = rng.integers(0, int(rng.integers(2, 12)), int(rng.integers(0, 40))).tolist()
        n, k = int(rng.integers(1, 5)), int(rng.integers(0, 6))
        got, want = te.NGramDrafter(n), je.NGramDrafter(n)
        for d in (got, want):
            d.seed(0, seq[:len(seq) // 2])
            d.extend(0, seq[len(seq) // 2:])
        assert got.draft(0, k) == want.draft(0, k), (trial, seq, n, k)
        assert got.draft(1, k) == want.draft(1, k) == []


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(1)
    for trial in range(20):
        kw = dict(window=int(rng.integers(4, 16)), threshold=float(rng.uniform(1.5, 4)),
                  patience=int(rng.integers(1, 4)))
        got, want = StragglerMonitor(**kw), JMonitor(**kw)
        times = rng.lognormal(0, 0.8, 80)
        assert [got.observe(t) for t in times] == [want.observe(t) for t in times]
        assert got.flagged_steps == want.flagged_steps


def test_watchdog_degrades_without_changing_outputs(smoke):
    """A monitor that flags every launch once it holds four (threshold 0,
    patience 1) turns speculation off at the fourth launch: the rest run
    plain and count as degraded, the tokens stay the plain run's."""
    tcfg = smoke[2]
    plain, spec = _engines(smoke, "packkv", "dense")
    a = _serve(plain, _reqs(te.Request, tcfg.vocab))
    mon = StragglerMonitor(threshold=0.0, patience=1)
    b = _serve(spec, _reqs(te.Request, tcfg.vocab), drafter=_replay(a, tcfg.vocab),
               straggler=mon)
    assert b._spec_degraded and b.stats.degraded_steps > 0
    assert 0 < b.stats.spec_launches <= 4 and mon.flagged_steps == [4]
    for rid in a.done:
        np.testing.assert_array_equal(a.done[rid].output, b.done[rid].output)


def test_spec_config_refused(smoke):
    _, _, tcfg, tparams = smoke
    ecfg = te.EngineConfig(capacity=256, max_batch=2, calibrate=False, device="cpu",
                           spec_decode=True)
    with pytest.raises(ValueError, match="spec_k"):
        te.Engine(tcfg, tparams, tc.PackKVConfig(), dataclasses.replace(ecfg, spec_k=0))
    api = dataclasses.replace(get_model(tcfg), decode_verify=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "get_model", lambda cfg: api)
        with pytest.raises(ValueError, match="spec-decode"):
            te.Engine(tcfg, tparams, tc.PackKVConfig(), ecfg)


def test_serve_cli_spec_decode():
    from repro_torch.launch import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                           "--spec-decode", "--spec-k", "3", "--requests", "3",
                           "--max-new", "24", "--prompt-len", "96", "--batch", "2",
                           "--capacity", "256"]) == 0
    text = out.getvalue()
    assert "speculative decode:" in text and "verify passes" in text, text
