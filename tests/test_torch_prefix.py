"""The torch port's shared-prefix page cache against the JAX reference.

  * The page ledger: the reference's ``test_share_release_refcounts``
    sequence (insert, pin, share, donor reset, recipient release, unpin,
    sentinel ids) and random pop / share / pin / unpin sequences (the
    reference's refcount-sequence property, from numpy seeds) leave the
    page tables, ``ref``, the free stack and ``n_free`` byte-exact with the
    reference's after every operation.
  * ``PrefixIndex``: the same lookups, inserts and LRU evictions give the
    same pages in both packages.
  * A hit row's cache ops (``prefill_append`` segments, the donor's
    insert, ``seed_prefix_from_pages``, ``insert_row_paged`` with shared
    pages) on the same K/V leave every leaf byte-exact with the
    reference's (zero-points under the FMA rule).
  * Serving (the reference's ``test_prefix_hit_bit_identical_to_cold``
    setup: llama2-7b smoke, pages of 128, a 2-page system prompt): in the
    port, 3 lookups, 2 hits, 4 pages shared, the reservation peak within
    the suffix-only bound and every warm output bitwise equal to a cold
    run on a fresh server (policies packkv and none); against the
    reference (packkv, xla) the prefix statistics are equal and the
    tokens equal under the margin rule; the eviction-under-pressure and
    index-cap cases give the reference's statistics.

Mirrors ``tests/test_prefix_cache.py``. The reference runs compiled
without excess precision (``torch_port_helpers.EXACT``)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.data import synthetic_kv
from repro.serving import engine as je
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import cache as tc
from repro_torch.serving import engine as te
from torch_port_helpers import (
    EXACT,
    LOGIT_ATOL,
    assert_cache_equal,
    jit_exact,
    margin,
    ref_cache_to_torch,
)

torch.set_num_threads(2)

B, H, D = 3, 2, 64
CAP, PAGE, R = 1024, 256, 96
LEDGER = ("page_table", "free", "n_free", "ref")


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _kv(rng, n):
    return _bf16(synthetic_kv(rng, 1, H, n, D)), _bf16(synthetic_kv(rng, 1, H, n, D))


def _pair(policy="packkv", pool_pages=None):
    """A paged cache in each package, the same config."""
    jcfg = jc.PackKVConfig(policy=policy, residual=R, paged=True, page_size=PAGE,
                           pool_pages=pool_pages)
    tcfg = tc.PackKVConfig(policy=policy, residual=R, paged=True, page_size=PAGE,
                           pool_pages=pool_pages)
    return (jc.alloc_layer_cache(jcfg, B, H, D, CAP),
            tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu"))


def _ledger_equal(tpool, jpool, what=""):
    for key in LEDGER:
        np.testing.assert_array_equal(getattr(tpool, key).numpy(),
                                      np.asarray(getattr(jpool, key)),
                                      err_msg=f"{what}: {key}")


def _conserved(pool):
    """free <=> ref == 0, both ways."""
    ref = pool.ref.numpy()
    nf = int(pool.n_free)
    assert int((ref == 0).sum()) == nf and int((ref > 0).sum()) + nf == len(ref)
    assert (ref[pool.free.numpy()[:nf]] == 0).all()


# ---------------------------------------------------------------------------
# the page ledger
# ---------------------------------------------------------------------------


def test_share_release_refcounts_match_reference():
    jcache, tcache = _pair("none")  # the ledger does not depend on the policy
    k0, v0 = _kv(np.random.default_rng(0), 2 * PAGE)
    jcache = jit_exact(jc.insert_prefill)(jcache, 0, jnp.asarray(k0[0]), jnp.asarray(v0[0]))
    tc.insert_prefill(tcache, 0, tensor_from_numpy(k0[0], "cpu"),
                      tensor_from_numpy(v0[0], "cpu"))
    _ledger_equal(tcache.pages, jcache.pages, "insert")
    phys = tcache.pages.page_table[0, :2].clone()
    jphys = jnp.asarray(phys.numpy())
    steps = (
        ("pin", lambda c: jc.acquire_pages(c, jphys), lambda c: tc.acquire_pages(c, phys), 2),
        ("share", lambda c: jc.share_pages(c, 2, jphys),
         lambda c: tc.share_pages(c, 2, phys), 3),
        ("donor reset", lambda c: jc.reset_slot(c, 0), lambda c: tc.reset_slot(c, 0), 2),
        ("recipient release",
         lambda c: dataclasses.replace(c, pages=jc.pool_release_row(c.pages, 2, jnp.int32(2))),
         lambda c: (tc.pool_release_row(c.pages, 2, 2), c)[1], 1),
        ("unpin", lambda c: jc.release_pages(c, jphys), lambda c: tc.release_pages(c, phys), 0),
    )
    nf = int(tcache.pages.n_free)
    for what, jop, top, want_ref in steps:
        jcache, tcache = jop(jcache), top(tcache)
        _ledger_equal(tcache.pages, jcache.pages, what)
        assert (tcache.pages.ref[phys.long()] == want_ref).all(), what
        _conserved(tcache.pages)
    assert int(tcache.pages.n_free) == nf + 2
    P = tcache.pages.n_pool_pages  # sentinel ids are ignored
    jcache = jc.acquire_pages(jcache, jnp.asarray([P, P + 3], jnp.int32))
    tc.acquire_pages(tcache, torch.tensor([P, P + 3], dtype=torch.int32))
    _ledger_equal(tcache.pages, jcache.pages, "sentinels")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refcount_sequences_match_reference(seed):
    """The reference's refcount-sequence property (pop an n-page request
    into a slot, share another slot's pages, pin, unpin), its operations
    drawn from a numpy seed: both ledgers byte-exact after every
    operation, and each page's count equal to the model's."""
    n_slots, pool_pages, max_pages = 4, 8, 4
    rng = np.random.default_rng(seed)
    jpool = jc.alloc_page_pool(batch=n_slots, capacity=max_pages * PAGE,
                               page_size=PAGE, pool_pages=pool_pages)
    tpool = tc.alloc_page_pool(n_slots, max_pages * PAGE, PAGE, pool_pages, "cpu")
    held = {s: [] for s in range(n_slots)}
    pinned: list[int] = []
    model = np.zeros(pool_pages, np.int64)

    def release(slot):
        nonlocal jpool
        jpool = jc.pool_release_row(jpool, slot, jnp.int32(len(held[slot])))
        tc.pool_release_row(tpool, slot, len(held[slot]))
        for p in held[slot]:
            model[p] -= 1
        held[slot] = []

    for _ in range(40):
        op, slot, n = int(rng.integers(4)), int(rng.integers(n_slots)), \
            int(rng.integers(max_pages + 1))
        if op == 0:  # a new n-page request in ``slot``
            release(slot)
            if n > int((model == 0).sum()):
                continue  # oversubscription is the scheduler's to avoid
            jpool, jphys = jc.pool_pop_prefix(jpool, slot, n)
            tphys = tc.pool_pop_prefix(tpool, slot, n)
            np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))
            held[slot] = tphys.tolist()
            model[held[slot]] += 1
        elif op == 1:  # share the next slot's pages by reference
            src = held[(slot + 1) % n_slots]
            k = min(n, len(src))
            if k == 0:
                continue
            share = src[:k]
            release(slot)
            jpool = jc.pool_map_prefix(jpool, slot, jnp.asarray(share, jnp.int32))
            tc.pool_map_prefix(tpool, slot, torch.tensor(share, dtype=torch.int32))
            held[slot] = list(share)
            model[share] += 1
        elif op == 2:  # the index pins a held page
            if not held[slot]:
                continue
            p = held[slot][n % len(held[slot])]
            jpool = jc.pool_acquire_ids(jpool, jnp.asarray([p], jnp.int32))
            tc.pool_acquire_ids(tpool, torch.tensor([p], dtype=torch.int32))
            pinned.append(p)
            model[p] += 1
        else:  # the index drops its oldest pin
            if not pinned:
                continue
            p = pinned.pop(0)
            jpool = jc._pool_release_ids(jpool, jnp.asarray([p], jnp.int32))
            tc._pool_release_ids(tpool, torch.tensor([p], dtype=torch.int32))
            model[p] -= 1
        _ledger_equal(tpool, jpool, f"seed {seed}")
        np.testing.assert_array_equal(tpool.ref.numpy(), model)
        _conserved(tpool)


def test_prefix_index_matches_reference():
    """Inserts along three prompts sharing pages, lookups (LRU bumps) and
    evictions under protected sets: the same pages in both packages."""
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(0, 512, 2 * 128)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, 512, n)]) for n in (300, 130, 10)]
    prompts.append(rng.integers(0, 512, 400))
    idx = {"ref": je.PrefixIndex(128), "port": te.PrefixIndex(128)}
    seen = {name: [] for name in idx}
    page = iter(range(1000))
    pages_of = [[next(page) for _ in range(len(p) // 128)] for p in prompts]
    for name, ix in idx.items():
        for p, ids in zip(prompts, pages_of):
            got, _ = ix.lookup(p, (len(p) - 1) // 128)
            seen[name].append(list(got))
            parent = None
            for d, chunk in enumerate(ix.chunks(p)):
                node = ix.descend(parent, chunk)
                node = ix.insert(parent, chunk, ids[d]) if node is None else node
                parent = node
        for p in prompts[::-1]:
            seen[name].append(ix.lookup(p, 8)[0])
        for protected in ({1}, set(), {6, 7}, set(), set()):
            seen[name].append(ix.evict_lru(protected))
        seen[name].append((ix.n_held, sorted(ix.pages)))
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] == pages_of[0][:2]  # the system prompt hit


@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_hit_row_cache_ops_byte_exact(policy):
    """A donor admitted by page segments (page 0 calibrates), its first two
    pages pinned, and a recipient seeded from them that appends its own
    segments and maps them by reference: every leaf of both caches
    byte-exact with the reference's, then the donor's reset."""
    jcache, tcache = _pair(policy)
    dense_j = jc.PackKVConfig(policy=policy, residual=R)
    dense_t = tc.PackKVConfig(policy=policy, residual=R)
    fma = None if policy == "none" else (
        (dense_j.k_quant().max_q + 1) // 2, (dense_j.v_quant().max_q + 1) // 2)
    rng = np.random.default_rng(7)
    shared = _kv(rng, 2 * PAGE)
    rows = [[np.concatenate([a, b], axis=2) for a, b in zip(shared, _kv(rng, n))]
            for n in (230, 100)]
    append = jit_exact(jc.prefill_append, static_argnames=("calibrate",))
    insert = jit_exact(jc.insert_row_paged, static_argnames=("n_pages", "n_shared"))
    seed = jit_exact(jc.seed_prefix_from_pages, static_argnames=("n_prefix",))

    def admit(slot, k, v, n_prefix):
        S = k.shape[2]
        _, cap, n_pages = tc.paged_mini_spec(tcache.cfg, S)
        jm = jc.alloc_layer_cache(dense_j, 1, H, D, cap)
        tm = tc.alloc_layer_cache(dense_t, 1, H, D, cap, device="cpu")
        phys = tcache.pages.page_table[0, :n_prefix // PAGE].clone()
        if n_prefix:
            perms = (None, None) if policy == "none" else (
                jcache.k.chan_perm[0], jcache.v.chan_perm[0])
            jm = seed(jcache, jm, jnp.asarray(phys.numpy()), n_prefix=n_prefix,
                      k_perm=perms[0], v_perm=perms[1])
            tperms = (None, None) if policy == "none" else (
                tcache.k.chan_perm[0], tcache.v.chan_perm[0])
            tc.seed_prefix_from_pages(tcache, tm, phys, n_prefix, *tperms)
        bounds = list(range(n_prefix, S // 64 * 64 // PAGE * PAGE + 1, PAGE)) + [S]
        for s0, s1 in zip(bounds, bounds[1:]):
            kj, vj = (jnp.asarray(x[..., s0:s1, :]) for x in (k, v))
            jm = append(jm, kj, vj, calibrate=s0 == 0)
            tc.prefill_append(tm, tensor_from_numpy(k[..., s0:s1, :], "cpu"),
                              tensor_from_numpy(v[..., s0:s1, :], "cpu"), s0 == 0)
        assert_cache_equal(tm, jm, fma)
        return insert(jcache, slot, jm, n_pages=n_pages, n_shared=n_prefix // PAGE,
                      shared_phys=jnp.asarray(phys.numpy())), \
            tc.insert_row_paged(tcache, slot, tm, n_pages, n_prefix // PAGE, phys)

    jcache, _ = admit(0, *rows[0], 0)
    assert_cache_equal(tcache, jcache, fma)
    pin = tcache.pages.page_table[0, :2].clone()
    jcache = jc.acquire_pages(jcache, jnp.asarray(pin.numpy()))
    tc.acquire_pages(tcache, pin)
    jcache, _ = admit(1, *rows[1], 2 * PAGE)
    assert_cache_equal(tcache, jcache, fma)
    assert tcache.pages.page_table[1, :2].tolist() == pin.tolist()
    assert (tcache.pages.ref[pin.long()] == 3).all()
    jcache = jit_exact(jc.reset_slot)(jcache, 0)
    tc.reset_slot(tcache, 0)
    assert_cache_equal(tcache, jcache, fma)
    _conserved(tcache.pages)


# ---------------------------------------------------------------------------
# serving
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


KW = dict(capacity=512, max_batch=2, calib_tokens=128, decode_chunk=4, bucketed=True,
          bucket_unit=64, paged=True, page_size=128, prefix_cache=True,
          debug_invariants=True)
SYS = np.random.default_rng(11).integers(0, 512, 300)  # 2 full 128-token pages


def _shared_reqs(cls):
    r = np.random.default_rng(5)
    mk = lambda rid, n, mn: cls(rid=rid, max_new=mn,
                                tokens=np.concatenate([SYS, r.integers(0, 512, n)]))
    return [mk(0, 40, 6), mk(1, 60, 5), mk(2, 25, 7)]


def _serve(engine, reqs, server=None):
    srv = server or (te.SlotServer if isinstance(engine, te.Engine) else je.SlotServer)(engine)
    for r in reqs:
        srv.submit(r)
    srv.run()
    return srv


def _port_engine(smoke, policy="packkv", **kw):
    _, _, tcfg, tparams = smoke
    return te.Engine(tcfg, tparams, tc.PackKVConfig(policy=policy),
                     te.EngineConfig(device="cpu", **{**KW, **kw}))


def _ref_engine(smoke, port_engine, **kw):
    """The reference engine at the port's calibrated specs (equal to the
    reference's own calibration, tests/test_torch_serving.py), every
    dispatch compiled by EXACT."""
    cfg, jparams, _, _ = smoke
    ts = port_engine.pack_cfg
    spec = lambda s: None if s is None else jc.TierSpec(s.widths, s.counts, s.pack_size)
    pack = jc.PackKVConfig(policy=ts.policy, k_spec_static=spec(ts.k_spec_static),
                           v_spec_static=spec(ts.v_spec_static))

    def lane_jit(self, fn, *, static=(), donate=()):
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.Engine, "_lane_jit", lane_jit)
        return je.Engine(cfg, jparams, pack, je.EngineConfig(
            backend="xla", calibrate=False, **{**KW, **kw}))


def _prefix_stats(s):
    return (s.prefix_lookups, s.prefix_hits, s.prefix_pages_shared, s.prefix_evictions,
            s.admission_blocks, s.pages_reserved_peak, s.prefill_chunks,
            s.decode_steps, s.completed)


@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_prefix_hit_bit_identical_to_cold(smoke, policy):
    """Requests sharing a 2-page system prompt: the later two hit the
    index, reserve only their suffix, and give a cold run's tokens on a
    fresh server (the index lives in the server)."""
    eng = _port_engine(smoke, policy)
    warm = _serve(eng, _shared_reqs(te.Request))
    s = warm.stats
    assert (s.prefix_lookups, s.prefix_hits, s.prefix_pages_shared) == (3, 2, 4)
    assert 0 < s.prefix_hit_rate < 1
    needs = [-(-min(512, len(r.tokens) + r.max_new) // 128)
             for r in _shared_reqs(te.Request)]
    assert s.pages_reserved_peak <= needs[0] + needs[1] - 2
    for r in _shared_reqs(te.Request):
        cold = _serve(eng, [r])
        np.testing.assert_array_equal(warm.done[r.rid].output, cold.done[r.rid].output)
    layer = warm.cache[0].pages  # the index still pins the 2 system pages
    assert int(layer.n_free) == layer.n_pool_pages - warm._index.n_held


def _steps_before_tie(engine, tokens, n):
    """The port's greedy run of one cold prefix admission up to its first
    near-tie: (tokens, steps whose top-2 margin is at least LOGIT_ATOL)."""
    cache = engine.alloc_slot_cache()
    logits, cache = engine.insert_request_prefix(cache, 0, tokens, [], None)
    out = []
    for i in range(n):
        row = logits.numpy()
        if margin(row) < LOGIT_ATOL:
            return out, i
        out.append(int(row.argmax()))
        tok = np.full((engine.ecfg.max_batch, 1), out[-1], np.int32)
        logits, cache = engine.decode(cache, tok)
        logits = logits[0]
    return out, n


def test_prefix_serving_matches_reference(smoke):
    """The shared-prefix traffic, an identical prompt resubmitted, the
    eviction-under-pressure case (a 5-page pool) and the index-cap case
    (one page): the port's prefix statistics equal the reference's; the
    shared traffic's tokens are equal until the port's first near-tie."""
    port = _port_engine(smoke)
    ref = _ref_engine(smoke, port)
    runs = {}
    for name, eng, cls in (("port", port, te.Request), ("ref", ref, je.Request)):
        srv = _serve(eng, _shared_reqs(cls))
        stats, held = _prefix_stats(srv.stats), srv._index.n_held
        out = {r: np.asarray(q.output) for r, q in srv.done.items()}
        # the same prompt again on the same server: a hit on both pages
        _serve(eng, [cls(rid=9, max_new=3, tokens=_shared_reqs(cls)[1].tokens)],
               server=srv)
        capped = _with_ecfg(eng, dataclasses.replace(eng.ecfg, prefix_cache_pages=1))
        cap = _serve(capped, _shared_reqs(cls))
        runs[name] = dict(stats=stats, held=held, again=_prefix_stats(srv.stats),
                          cap=_prefix_stats(cap.stats), cap_held=cap._index.n_held,
                          out=out)
    assert runs["port"]["stats"][:3] == (3, 2, 4)
    assert runs["port"]["again"][:3] == (4, 3, 6)
    assert runs["port"]["cap_held"] <= 1
    for key in ("stats", "held", "again", "cap", "cap_held"):
        assert runs["port"][key] == runs["ref"][key], key
    compared = 0
    for r in _shared_reqs(te.Request):
        _, n = _steps_before_tie(port, r.tokens, r.max_new)
        np.testing.assert_array_equal(runs["port"]["out"][r.rid][:n],
                                      runs["ref"]["out"][r.rid][:n])
        compared += n
    assert compared >= 8, compared

    # a tight pool: cold index pages are evicted to admit a large request
    runs = {}
    tight = _port_engine(smoke, pool_pages=5)
    r = np.random.default_rng(13)
    small, big = r.integers(0, 512, 300), r.integers(0, 512, 500)
    for name, eng, cls in (("port", tight, te.Request),
                           ("ref", _with_ecfg(ref, dataclasses.replace(ref.ecfg, pool_pages=5),
                                              pool_pages=5), je.Request)):
        srv = _serve(eng, [cls(rid=0, max_new=4, tokens=small)])
        held = srv._index.n_held
        _serve(eng, [cls(rid=1, max_new=8, tokens=big)], server=srv)
        runs[name] = (held, _prefix_stats(srv.stats), srv._index.n_held)
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == 2 and runs["port"][1][3] >= 1 and runs["port"][1][4] == 0


def _with_ecfg(engine, ecfg, pool_pages=None):
    """A shallow copy of a reference engine with another ``EngineConfig``
    and pool size, sharing its compiled dispatches: the index's page cap
    is read by the scheduler alone, and the pool size by the scheduler
    and the cache allocation (the dispatches take it from the cache's
    shapes), so the twin behaves as a fresh engine without compiling
    again what the two share."""
    import copy

    twin = copy.copy(engine)
    twin.ecfg = ecfg
    if pool_pages is not None:
        twin.pack_cfg = dataclasses.replace(engine.pack_cfg, pool_pages=pool_pages)
    return twin
