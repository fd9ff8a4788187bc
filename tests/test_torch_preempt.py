"""The torch port's preemption (swap-out, resume, deadlines, cancellation,
fault plans, priority aging) against the JAX reference and against its
own uninterrupted runs.

  * ``evacuate_row`` / ``restore_row`` on the same ragged cache: the minis
    and the freed and restored caches are byte-exact with the reference's
    (dense and paged, zero-points under the FMA rule; the shared-prefix
    case is in ``tests/test_torch_session.py``), a restore into another
    slot and other pages included; evacuating the restored row again gives the first mini
    bitwise (the round trip), and a dense mini is a copy that an
    admission into the freed slot cannot reach.
  * ``SlotServer`` with preemption, port against itself on backend
    ``fused`` (the plain kernel versions on the CPU), over {packkv, none}
    x {dense, paged, prefix}: every resumed request bitwise equal to the
    uninterrupted control; page pressure; deadlines (refused at submit,
    expired within one step); a cancel mid-prefill-chunk leaks nothing; a
    cancel of a swapped-out request; the four edges of
    ``tests/test_swap_edges.py`` over the reference's host stub engine.
  * Port against reference: dense packkv, the preemption traffic through
    both ``SlotServer``s gives equal counters, ``n_preempts`` and
    statuses and tokens equal under the margin rule; ``FaultPlan`` and
    ``_head`` under aging 0 and 4 equal the reference's.
  * ``launch/serve.py --preempt --priority-every 2`` runs.

Mirrors ``tests/test_preempt.py`` and ``tests/test_swap_edges.py``. The
reference runs compiled without excess precision
(``torch_port_helpers.EXACT``)."""
import contextlib
import dataclasses
import functools
import io
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.data import synthetic_kv
from repro.distributed import fault as jfault
from repro.serving import engine as je
from repro_torch.core import cache as tc
from repro_torch.distributed import FaultEvent, FaultPlan
from repro_torch.serving import engine as te
from repro_torch.utils import tree_flatten, tree_map
from test_scheduler_property import _StubEngine
from torch_port_helpers import (
    EXACT,
    assert_cache_equal,
    jit_exact,
    ref_cache_to_torch,
    steps_before_tie,
)

torch.set_num_threads(2)

B, H, D, R = 3, 2, 64, 96
PAGE = 128


# ---------------------------------------------------------------------------
# cache ops: evacuate_row / restore_row against the reference
# ---------------------------------------------------------------------------


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)


def _spec(s):
    return (s.widths, s.counts, s.pack_size)


@functools.lru_cache(maxsize=None)
def _calibrated() -> jc.PackKVConfig:
    k0 = _bf16(synthetic_kv(np.random.default_rng(7), 1, H, 128, D))
    return jc.calibrate_specs(jnp.asarray(k0), jnp.asarray(k0),
                              jc.PackKVConfig(residual=R, page_size=PAGE))


def _configs(policy, paged, cap):
    jcfg = jc.PackKVConfig(policy=policy, residual=R, paged=paged, page_size=PAGE)
    if policy == "none":
        return jcfg, tc.PackKVConfig(policy=policy, residual=R, paged=paged,
                                     page_size=PAGE), (0, 0)
    jcfg = dataclasses.replace(_calibrated(), paged=paged)
    tcfg = tc.PackKVConfig(policy=policy, residual=R, paged=paged, page_size=PAGE,
                           k_spec_static=tc.TierSpec(*_spec(jcfg.k_spec_static)),
                           v_spec_static=tc.TierSpec(*_spec(jcfg.v_spec_static)))
    fma = ((jcfg.k_quant().max_q + 1) // 2, (jcfg.v_quant().max_q + 1) // 2)
    return jcfg, tcfg, fma


_append = jit_exact(jc.append_token)
_insert = jit_exact(jc.insert_prefill)
_evacuate = jit_exact(jc.evacuate_row, static_argnames=("n_pages", "n_shared"))
_restore = jit_exact(jc.restore_row, static_argnames=("n_pages", "n_shared"))


def _appends(jcache, tcache, rng, n):
    for _ in range(n):
        s = _bf16(rng.normal(size=(B, H, 1, D)))
        jcache = _append(jcache, jnp.asarray(s), jnp.asarray(-s))
        tc.append_token(tcache, _torch_bf16(s), -_torch_bf16(s))
    return jcache


def _n_pages(cache, slot, paged):
    return -(-int(cache.n_comp[slot]) // PAGE) if paged else 0


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_evacuate_restore_byte_exact(policy, paged):
    """Ragged rows (191 / 131 / 156 tokens) and 33 appends (row 0's
    residual full); rows 0 and 1 evacuated, then each restored into the
    other's slot (paged: into the pages the free stack hands back), and 40
    more appends (two rows flush, paged: into fresh pages): every mini and
    cache byte-exact with the reference's after
    every operation. Evacuating a restored row again gives its first mini
    back bitwise."""
    jcfg, tcfg, fma = _configs(policy, paged, 256)
    rng = np.random.default_rng(3)
    jcache = jc.alloc_layer_cache(jcfg, B, H, D, 256)
    for r, n in enumerate((191, 131, 156)):
        kv = jnp.asarray(_bf16(synthetic_kv(rng, 1, H, n, D))[0])
        jcache = _insert(jcache, r, kv, kv[:, ::-1])
    tcache = ref_cache_to_torch(jcache, tcfg)
    jcache = _appends(jcache, tcache, rng, 33)
    assert int(tcache.n_resid[0]) == R  # row 0's next append flushes
    assert_cache_equal(tcache, jcache, fma)
    minis = {}
    for slot in (0, 1):
        n = _n_pages(tcache, slot, paged)
        jcache, jmini = _evacuate(jcache, slot, n_pages=n)
        tcache, tmini = tc.evacuate_row(tcache, slot, n)
        assert_cache_equal(tmini, jmini, fma)
        assert_cache_equal(tcache, jcache, fma)
        minis[slot] = (tmini, jmini, n)
    if paged:  # both rows' pages are back on the stack
        assert int(tcache.pages.n_free) == tcache.pages.n_pool_pages - 1
    for slot, src in ((1, 0), (0, 1)):  # each into the other's slot
        tmini, jmini, n = minis[src]
        jcache = _restore(jcache, slot, jmini, None, n_pages=n)
        tc.restore_row(tcache, slot, tmini, None, n)
        assert_cache_equal(tcache, jcache, fma)
    for slot, src in ((1, 0), (0, 1)):  # the round trip, port only
        _, again = tc.evacuate_row(tree_map(torch.clone, tcache), slot,
                                   _n_pages(tcache, slot, paged))
        _port_equal(again, minis[src][0])
    jcache = _appends(jcache, tcache, rng, 40)  # later flushes, other pages
    assert int(tcache.n_comp[1]) == 192
    assert_cache_equal(tcache, jcache, fma)


def _port_equal(a, b):
    """Two port caches bitwise equal, leaf by leaf."""
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                           y.view(torch.uint8) if y.dim() else y)


def test_dense_mini_is_a_copy():
    """The dense mini is the row's copy, not a view of it: admitting
    another prompt into the freed slot leaves it untouched."""
    _, tcfg, _ = _configs("packkv", False, 256)
    rng = np.random.default_rng(4)
    cache = tc.alloc_layer_cache(tcfg, B, H, D, 256, device="cpu")
    for r, n in enumerate((191, 131, 156)):
        kv = _torch_bf16(_bf16(synthetic_kv(rng, 1, H, n, D))[0])
        tc.insert_prefill(cache, r, kv, kv.flip(1))
    _, mini = tc.evacuate_row(cache, 1)
    before = tree_map(torch.clone, mini)
    kv = _torch_bf16(_bf16(synthetic_kv(rng, 1, H, 250, D))[0])
    tc.insert_prefill(cache, 1, kv, kv)
    _port_equal(mini, before)


# ---------------------------------------------------------------------------
# serving: preempted == uninterrupted (the port against itself)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    from repro.configs import get_arch as j_get_arch
    from repro.models import get_model as j_get_model
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy

    cfg = j_get_arch("llama2-7b", smoke=True)
    jparams = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch("llama2-7b", smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


KW = dict(capacity=512, calib_tokens=128, decode_chunk=4, bucketed=True, bucket_unit=64,
          page_size=PAGE, prefill_chunk_pages=1)
_ENGINES: dict = {}


def _engine(smoke, policy, mode, max_batch=2, pool_pages=None, **kw):
    """A port engine (calibrated once per policy, module-wide)."""
    _, _, tcfg, tparams = smoke
    key = (policy, mode, max_batch, pool_pages, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        paged = mode != "dense"
        ecfg = te.EngineConfig(device="cpu", max_batch=max_batch, paged=paged,
                               pool_pages=pool_pages, prefix_cache=mode == "prefix",
                               debug_invariants=paged, **{**KW, **kw})
        calib = _ENGINES.get(("calib", policy))
        pack = tc.PackKVConfig(policy=policy) if calib is None else calib
        _ENGINES[key] = te.Engine(tcfg, tparams, pack, dataclasses.replace(
            ecfg, calibrate=calib is None))
        if calib is None:
            # a calibrated paged config keeps only its specs for the others
            _ENGINES[("calib", policy)] = dataclasses.replace(
                tc.PackKVConfig(policy=policy),
                k_spec_static=_ENGINES[key].pack_cfg.k_spec_static,
                v_spec_static=_ENGINES[key].pack_cfg.v_spec_static)
    return _ENGINES[key]


def _traffic(cls, vocab):
    """The reference test's traffic: two long class-1 requests sharing a
    2-page prefix (they fill the table) and a short class-0 arrival."""
    r = np.random.default_rng(11)
    sys = r.integers(0, vocab, 2 * PAGE)
    lows = [cls(rid=i, max_new=40, priority=1,
                tokens=np.concatenate([sys, r.integers(0, vocab, 40 + 13 * i)]))
            for i in range(2)]
    return [*lows, cls(rid=2, max_new=6, priority=0, tokens=r.integers(0, vocab, 100))]


def _preempted(srv, vocab, cls=te.Request):
    reqs = _traffic(cls, vocab)
    srv.submit(reqs[0])
    srv.submit(reqs[1])
    for _ in range(8):  # both lows admitted and several tokens deep
        srv.step()
    srv.submit(reqs[2])  # the table is full: a swap-out
    srv.run()
    return srv


def _control(eng, vocab):
    ctl = te.SlotServer(eng)
    for r in _traffic(te.Request, vocab):
        ctl.submit(r)
    ctl.run()
    return ctl


def _assert_drained(srv):
    """Every page back but the index's, the swap store empty."""
    assert srv._swap is None or len(srv._swap) == 0
    if srv.engine.ecfg.paged:
        held = srv._index.n_held if srv._index is not None else 0
        for layer in srv.cache:
            assert int(layer.pages.n_free) == layer.pages.n_pool_pages - held


@pytest.mark.parametrize("mode", ["dense", "paged", "prefix"])
@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_preempt_resume_bit_identical(smoke, policy, mode):
    tcfg = smoke[2]
    srv = _preempted(te.SlotServer(_engine(smoke, policy, mode, preempt=True)), tcfg.vocab)
    s = srv.stats
    assert s.preemptions >= 1 and s.completed == 3
    assert sum(r.n_preempts for r in srv.done.values()) == s.preemptions
    if mode != "dense":
        assert s.swapped_pages == s.restored_pages
    _assert_drained(srv)
    ctl = _control(_engine(smoke, policy, mode), tcfg.vocab)
    assert ctl.stats.preemptions == 0
    for rid in srv.done:
        np.testing.assert_array_equal(srv.done[rid].output, ctl.done[rid].output,
                                      err_msg=f"rid {rid}")


def test_preempt_on_page_pressure(smoke):
    """A free slot but no reservable pages: the class-0 arrival swaps a
    class-1 victim out for its pages; every output equals the control's."""
    tcfg = smoke[2]
    srv = te.SlotServer(_engine(smoke, "packkv", "paged", 3, 6, preempt=True))
    reqs = _traffic(te.Request, tcfg.vocab)  # the lows reserve all 6 pages
    srv.submit(reqs[0])
    srv.submit(reqs[1])
    for _ in range(8):
        srv.step()
    assert srv.n_occupied == 2 and srv._pages_avail == 0
    srv.submit(reqs[2])
    srv.run()
    assert srv.stats.preemptions >= 1 and srv.stats.completed == 3
    _assert_drained(srv)
    ctl = _control(_engine(smoke, "packkv", "paged", 3, 6), tcfg.vocab)
    for rid in srv.done:
        np.testing.assert_array_equal(srv.done[rid].output, ctl.done[rid].output)


def test_deadline_rejected_at_submit(smoke):
    srv = te.SlotServer(_engine(smoke, "none", "dense"))
    toks = np.arange(8, dtype=np.int64)
    for bad in (0.0, -5.0):
        with pytest.raises(ValueError, match="deadline_ms"):
            srv.submit(te.Request(rid=0, max_new=4, tokens=toks, deadline_ms=bad))
    with pytest.raises(ValueError, match="priority"):
        srv.submit(te.Request(rid=0, max_new=4, tokens=toks, priority=-1))


def test_deadline_expires_within_one_step(smoke):
    eng = _engine(smoke, "none", "dense")
    srv = te.SlotServer(eng)
    req = te.Request(rid=0, max_new=200, deadline_ms=1e9,
                     tokens=np.random.default_rng(5).integers(0, smoke[2].vocab, 70))
    srv.submit(req)
    for _ in range(3):
        srv.step()
    assert req.status == "active" and srv.n_occupied == 1
    n_before = len(srv.slots[0].out)
    req.deadline_ms = 1e-6  # long past: the next step retires it
    out = srv.step()
    assert out and out[0] is req and req.status == "expired"
    assert srv.n_occupied == 0 and srv._reserved == {}
    assert n_before <= len(req.output) <= n_before + eng.ecfg.decode_chunk
    assert srv.stats.expired == 1 and srv.stats.completed == 0
    assert req.t_first is not None and len(req.token_times) == len(req.output)


def test_cancel_mid_prefill_chunk_leaks_nothing(smoke):
    """A cancel between prefill chunks hands back the claimed slot's
    reservation and leaves the pool whole; the server still serves."""
    eng = _engine(smoke, "packkv", "prefix", preempt=True)
    srv = te.SlotServer(eng)
    toks = np.random.default_rng(6).integers(0, smoke[2].vocab, 3 * PAGE + 50)
    req = te.Request(rid=0, max_new=4, tokens=toks)
    srv.submit(req)
    srv.step()  # the task started: one chunk done, more to go
    assert srv._task is not None and not srv._task.done and 0 in srv._reserved
    req.cancel()
    srv.step()
    assert srv._task is None and req.status == "cancelled"
    assert srv.stats.cancelled == 1 and srv._reserved == {} and srv.n_occupied == 0
    assert len(req.output) == 0
    for layer in srv.cache:
        assert int(layer.pages.n_free) == eng.pack_cfg.pool_pages
        assert int(layer.pages.ref.sum()) == 0
    nxt = te.Request(rid=1, max_new=4, tokens=toks[:PAGE + 30])
    srv.submit(nxt)
    srv.run()
    assert nxt.status == "done" and len(nxt.output) == 4


def test_cancel_swapped_out_request(smoke):
    """A request cancelled while swapped out retires from the SwapStore
    with its tokens so far; the store drains."""
    tcfg = smoke[2]
    srv = te.SlotServer(_engine(smoke, "packkv", "paged", preempt=True))
    reqs = _traffic(te.Request, tcfg.vocab)
    srv.submit(reqs[0])
    srv.submit(reqs[1])
    for _ in range(8):
        srv.step()
    srv.submit(reqs[2])
    for _ in range(30):
        srv.step()
        if len(srv._swap):
            break
    assert len(srv._swap) == 1 and srv._swap.peak_bytes > 0
    victim = next(r for r in reqs[:2] if r.rid in srv._swap)
    victim.cancel()
    srv.run()
    assert victim.status == "cancelled" and len(victim.output) > 0
    assert len(srv._swap) == 0
    assert srv.stats.completed == 2 and srv.stats.cancelled == 1
    _assert_drained(srv)


# ---------------------------------------------------------------------------
# the reference's swap edges, over its host stub engine
# ---------------------------------------------------------------------------


class _TorchStub(_StubEngine):
    """The reference's host-only stub engine, its logits as tensors."""

    def __init__(self, ecfg, pool_pages):
        super().__init__(ecfg, pool_pages)
        self.released = []

    def insert_request(self, cache, slot, tokens):
        logits, cache = super().insert_request(cache, slot, tokens)
        return torch.from_numpy(logits), cache

    def chunk_step(self, scratch, tokens, n_ctx):
        logits, scratch = super().chunk_step(scratch, tokens, n_ctx)
        return torch.from_numpy(logits), scratch

    def decode(self, cache, tok, n_bucket=None):
        logits, cache = super().decode(cache, tok, n_bucket)
        return torch.from_numpy(logits), cache

    def index_release(self, cache, ids):
        cache["free"] += len(ids)
        self.released += [int(p) for p in ids]
        return cache


def test_swapstore_duplicate_rid():
    st = tc.SwapStore()
    mini = {"pages": np.zeros((4, 8), np.uint8)}
    st.put(7, mini, {"shared": ()})
    with pytest.raises(AssertionError):
        st.put(7, mini, {"shared": ()})
    got, meta = st.pop(7)
    assert 7 not in st and meta == {"shared": ()}
    assert np.array_equal(got["pages"], mini["pages"])
    st.put(7, mini, {"shared": ()})  # a second swap-out after a resume
    st.drop(7)
    st.drop(7)
    assert len(st) == 0 and st.swapped_out == 2 and st.swapped_in == 1
    assert st.nbytes == 0 and st.peak_bytes == 32


def test_live_shared_pin_survives_index_eviction():
    ecfg = te.EngineConfig(capacity=256, max_batch=2, paged=True, page_size=64,
                           pool_pages=4, calibrate=False, prefill_chunk_pages=0,
                           decode_chunk=1, preempt=True, device="cpu")
    eng = _TorchStub(ecfg, 4)
    srv = te.SlotServer(eng)
    srv.cache = eng.alloc_slot_cache()
    srv._index = te.PrefixIndex(ecfg.page_size)
    chunks = srv._index.chunks(np.arange(2 * ecfg.page_size))
    srv._index.insert(None, chunks[0], 5)
    srv._index.insert(None, chunks[1], 3)
    srv.cache["free"] -= 2
    srv._swap.put(9, {"toks": 64}, {"shared": (5,), "n_pages": 1, "n_shared": 1,
                                   "out": [1], "last_tok": 1, "forced": [],
                                   "base": (64, 0, 64, 1)})
    assert srv._live_shared() == {5}
    assert srv._evict_to_fit(3, set())
    assert eng.released == [3] and srv._index.pages == {5}
    assert not srv._evict_to_fit(4, set()), "evicted a pinned shared page"
    srv._swap.drop(9)
    assert srv._live_shared() == set()
    assert srv._evict_to_fit(4, set())
    assert eng.released == [3, 5] and srv._index.n_held == 0
    assert srv.stats.prefix_evictions == 2 and srv.cache["free"] == 4


def test_evacuation_overlaps_chunked_prefill():
    page, pool = 64, 5
    ecfg = te.EngineConfig(capacity=192, max_batch=2, paged=True, page_size=page,
                           pool_pages=pool, calibrate=False, prefill_chunk_pages=1,
                           decode_chunk=1, preempt=True, aging_steps=0, device="cpu")
    srv = te.SlotServer(_TorchStub(ecfg, pool))
    srv.submit(te.Request(rid=0, max_new=100, tokens=np.zeros((64,), np.int64), priority=2))
    srv.step()
    assert srv.n_occupied == 1 and not srv._swap
    srv.submit(te.Request(rid=1, max_new=62, tokens=np.ones((130,), np.int64), priority=0))
    overlap = 0
    while srv.queue or srv.n_occupied or srv._task is not None:
        srv.step()
        overlap += srv._task is not None and len(srv._swap) > 0
        assert srv.cache["free"] + sum(srv.cache["rows"]) == pool
        assert sum(srv._reserved.values()) <= pool
    assert overlap >= 2 and srv.stats.preemptions == 1 and len(srv._swap) == 0
    a, b = srv.done[0], srv.done[1]
    assert a.status == "done" and len(a.output) == 100 and a.n_preempts == 1
    assert b.status == "done" and len(b.output) == 62 and srv.cache["free"] == pool


def test_session_restore_into_smaller_reservation():
    page, pool = 64, 6
    ecfg = te.EngineConfig(capacity=256, max_batch=1, paged=True, page_size=page,
                           pool_pages=pool, calibrate=False, prefill_chunk_pages=0,
                           decode_chunk=1, session_cache=True, device="cpu")
    srv = te.SlotServer(_TorchStub(ecfg, pool), eos_id=1)
    prompt = np.zeros((70,), np.int64)
    srv.submit(te.Request(rid=0, max_new=100, tokens=prompt))
    srv.run()
    out1 = list(srv.done[0].output)
    assert len(out1) == 2 and srv.stats.session_parks == 1 and srv.cache["free"] == pool
    trace = np.concatenate([prompt, np.asarray(out1, np.int64)])
    srv.submit(te.Request(rid=0, max_new=1, tokens=np.concatenate([trace, [5]])))
    srv.step()
    assert srv.stats.session_hits == 1
    new_res = srv._reserved.get(0)
    assert new_res is not None and new_res < 3
    assert srv.cache["rows"][0] <= new_res
    while srv.queue or srv.n_occupied or srv._task is not None:
        srv.step()
        assert srv.cache["free"] + sum(srv.cache["rows"]) == pool
    assert srv.done[0].status == "done" and len(srv.done[0].output) == 1
    assert srv.cache["free"] == pool


# ---------------------------------------------------------------------------
# against the reference: the scheduler's decisions, FaultPlan, aging
# ---------------------------------------------------------------------------


def _jengine(smoke, port_engine, **kw):
    """The reference engine at the port engine's calibrated specs."""
    cfg, jparams, _, _ = smoke
    ts = port_engine.pack_cfg
    jspec = lambda s: jc.TierSpec(s.widths, s.counts, s.pack_size)
    jpack = jc.PackKVConfig(k_spec_static=jspec(ts.k_spec_static),
                            v_spec_static=jspec(ts.v_spec_static))

    def lane_jit(self, fn, *, static=(), donate=()):
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.Engine, "_lane_jit", lane_jit)
        return je.Engine(cfg, jparams, jpack, je.EngineConfig(
            backend="xla", calibrate=False, max_batch=2, **{**KW, **kw}))


def _sched_stats(s):
    return (s.preemptions, s.swapped_pages, s.restored_pages, s.completed, s.admitted,
            s.cancelled, s.expired, s.slot_reuses, s.tokens_out, s.prefill_chunks,
            s.session_lookups, s.session_parks, s.session_hits, s.session_evictions,
            s.session_restored_pages)


def test_preempt_scheduler_matches_reference(smoke):
    """Dense packkv, monolithic admission (one reference compile a prompt
    length): the preemption traffic through both SlotServers gives equal
    counters, n_preempts and statuses, and tokens equal until the port's
    first near-tie (the margin rule)."""
    cfg, _, tcfg, _ = smoke
    kw = dict(preempt=True, prefill_chunk_pages=0)
    eng = _engine(smoke, "packkv", "dense", **kw)
    a = _preempted(te.SlotServer(eng), tcfg.vocab)
    b = _preempted(je.SlotServer(_jengine(smoke, eng, **kw)), cfg.vocab, je.Request)
    assert _sched_stats(a.stats) == _sched_stats(b.stats)
    assert a.stats.preemptions >= 1
    compared = 0
    for r in _traffic(te.Request, tcfg.vocab):
        ra, rb = a.done[r.rid], b.done[r.rid]
        assert (ra.status, ra.n_preempts) == (rb.status, rb.n_preempts)
        _, n = steps_before_tie(eng, r.tokens, r.max_new)
        np.testing.assert_array_equal(ra.output[:n], np.asarray(rb.output)[:n])
        compared += n
    assert compared >= 8, compared


def test_fault_plan_matches_reference():
    events = [(7, "cancel", 2.0), (3, "park", 1.0), (3, "pool_squeeze", 4.0),
              (12, "session_expire", 1.0), (0, "resume", 3.0)]
    got = FaultPlan([FaultEvent(*e) for e in events])
    want = jfault.FaultPlan([jfault.FaultEvent(*e) for e in events])
    tup = lambda evs: [(e.step, e.kind, e.arg) for e in evs]
    assert tup(got.events) == tup(want.events)
    for step in range(14):
        assert tup(got.at(step)) == tup(want.at(step))
    storm = FaultPlan.storm("deadline", 5, 4, every=3, arg=2.0) + got
    jstorm = jfault.FaultPlan.storm("deadline", 5, 4, every=3, arg=2.0) + want
    assert tup(storm.events) == tup(jstorm.events)
    assert FaultPlan.KINDS == jfault.FaultPlan.KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan([FaultEvent(1, "meteor")])
    assert te.FaultPlan is FaultPlan


def _stub(cls_cfg, aging):
    return SimpleNamespace(cfg=SimpleNamespace(input_mode="tokens"),
                           ecfg=cls_cfg(max_batch=2, aging_steps=aging, calibrate=False),
                           pack_cfg=SimpleNamespace(pool_pages=8, block=64, residual=96))


@pytest.mark.parametrize("aging", [0, 4])
def test_head_aging_matches_reference(aging):
    """A scripted flood: three class-2 and two class-1 requests, then one
    class-0 arrival every step; each step pops ``_head``. The same
    sequence of request ids in both packages (with aging, the class-2
    requests get their turn; without it they wait for the flood)."""
    seqs = []
    for mod, cfg_cls in ((te, te.EngineConfig), (je, je.EngineConfig)):
        srv = mod.SlotServer(_stub(cfg_cls, aging))
        toks = np.zeros((4,), np.int64)
        for rid, prio in enumerate((2, 2, 1, 2, 1)):
            srv.submit(mod.Request(rid=rid, max_new=1, tokens=toks, priority=prio))
        order = []
        for step in range(24):
            srv._step_no += 1
            if step < 16:
                srv.submit(mod.Request(rid=100 + step, max_new=1, tokens=toks))
            head = srv._head()
            if head is not None and step % 3 != 2:  # every third step blocks
                order.append(srv._pop_head(head).rid)
        seqs.append(order)
    assert seqs[0] == seqs[1]
    first_low = min((seqs[0].index(r) for r in range(5) if r in seqs[0]),
                    default=len(seqs[0]))
    assert (first_low < 8) == (aging > 0), seqs[0]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_serve_cli_preempt():
    from repro_torch.launch import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu", "--preempt",
                           "--priority-every", "2", "--requests", "5", "--max-new", "12",
                           "--prompt-len", "96", "--batch", "2", "--capacity", "256"]) == 0
    text = out.getvalue()
    assert "preemption:" in text and "swap-outs" in text, text
