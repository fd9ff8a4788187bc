"""The torch port's paged storage (page pool, page ledger, K5's plain
version) against the JAX reference and against the port's
own dense storage.

  * Ledger: the same operations (whole-batch prefill, appends whose
    flushes cross page boundaries, reset, re-insert, a masked free row, a
    copy-on-write flush through ``pool_acquire_ids``, the capacity cap)
    leave the page table, free stack, ``n_free``, ``ref`` and every pool
    leaf byte-exact with the reference's.
  * Reads: ``gather_paged`` equals the dense cache's bytes; K5's plain
    version is within rtol 1e-5 / atol 1e-4 of the reference's
    ``paged_decode_attention(backend="xla")`` and bitwise equal to K2's
    plain version on the gathered view, at page sizes 64, 256 and 512.
  * Release: a shared page released twice in one call, an over-release
    and sentinels leave the ledger byte-exact with the reference's.

Paged serving is in tests/test_torch_paged_serving.py.

The reference runs compiled without excess precision
(``torch_port_helpers.EXACT``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.data import synthetic_kv
from repro.kernels import ops as jops
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import cache as tc
from repro_torch.kernels import ops
from repro_torch.kernels.packed_attention import (
    fused_packed_attention_paged,
    fused_packed_attention_paged_torch,
    fused_packed_attention_torch,
)
from torch_port_helpers import assert_cache_equal, jit_exact, ref_cache_to_torch
from torch_threads import one_torch_thread  # noqa: F401

B, H, D = 3, 2, 32
# the reference's paged read, compiled (f32 math: compiling changes no
# rounding these tolerances could see; op by op it takes seconds)
j_paged_attention = jax.jit(
    lambda q, c, sm, n_bucket: jops.paged_decode_attention(
        q, c, sm, n_bucket=n_bucket, backend="xla"),
    static_argnames=("sm", "n_bucket"))
TOL = dict(rtol=1e-5, atol=1e-4)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _configs(policy="packkv", **paged):
    """(reference config, port config) with the same fields, calibrated
    specs for packkv."""
    jcfg = jc.PackKVConfig(policy=policy, **paged)
    if policy == "packkv":
        k = _bf16(synthetic_kv(np.random.default_rng(7), 1, H, 128, D))
        jcfg = jc.calibrate_specs(jnp.asarray(k), jnp.asarray(k), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tc.PackKVConfig)}
    for name in ("k_spec_static", "v_spec_static"):
        s = fields[name]
        if s is not None:
            fields[name] = tc.TierSpec(s.widths, s.counts, s.pack_size)
    return jcfg, tc.PackKVConfig(**fields)


def _fma_c(cfg):
    return ((cfg.k_quant().max_q + 1) // 2, (cfg.v_quant().max_q + 1) // 2)


def _conserved(pool):
    """free <=> ref == 0, both ways (the reference's invariant)."""
    ref = pool.ref.numpy()
    nf = int(pool.n_free)
    assert int((ref == 0).sum()) == nf and int((ref > 0).sum()) + nf == len(ref)
    assert (ref[pool.free.numpy()[:nf]] == 0).all()


# ---------------------------------------------------------------------------
# the ledger and the pool bytes after identical operations
# ---------------------------------------------------------------------------

CAP, PAGE, POOL = 256, 128, 8


def _page_bytes(cache, page):
    """Every pool leaf's bytes of one physical page."""
    return [np.asarray(a)[:, page] for a in jax.tree_util.tree_leaves(
        (cache.k, cache.v, cache.raw_k, cache.raw_v))
        if np.ndim(a) >= 3 and np.shape(a)[1] == POOL]


@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_pool_ledger_byte_exact(policy):
    jcfg, tcfg = _configs(policy, paged=True, page_size=PAGE, pool_pages=POOL)
    fma = _fma_c(jcfg) if policy != "none" else None
    rng = np.random.default_rng(11)
    T = lambda a: tensor_from_numpy(a, "cpu")
    prompt = _bf16(synthetic_kv(rng, B, H, 150, D))
    row1 = _bf16(synthetic_kv(rng, 1, H, 70, D))[0]
    row2 = _bf16(synthetic_kv(rng, 1, H, 40, D))[0]
    steps = _bf16(rng.normal(size=(260, B, H, 1, D)) * 2.0)

    prefill = jit_exact(jc.prefill_cache)
    insert = jit_exact(jc.insert_prefill)
    append = jit_exact(jc.append_token)
    reset = jit_exact(jc.reset_slot)
    mask = jit_exact(jc.mask_free_slots)
    pool_op = lambda c, f, ids: dataclasses.replace(
        c, pages=f(c.pages, jnp.asarray(ids, jnp.int32)))

    jcache = prefill(jc.alloc_layer_cache(jcfg, B, H, D, CAP),
                     jnp.asarray(prompt), jnp.asarray(prompt[:, ::-1]))
    tcache = tc.prefill_cache(tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu"),
                              T(prompt), T(np.ascontiguousarray(prompt[:, ::-1])))
    assert_cache_equal(tcache, jcache, fma)
    jcache = insert(reset(jcache, 2), 2, jnp.asarray(row2), jnp.asarray(row2))
    tc.insert_prefill(tc.reset_slot(tcache, 2), 2, T(row2), T(row2))
    active = np.ones(B, bool)
    cow_page = None
    for i in range(len(steps)):
        if i == 80:  # recycle slot 1 with a new request
            jcache = insert(reset(jcache, 1), 1, jnp.asarray(row1), jnp.asarray(row1))
            tc.insert_prefill(tc.reset_slot(tcache, 1), 1, T(row1), T(row1))
        if i == 140:  # slot 2 retires; its free row rides along, re-zeroed
            jcache, active[2] = reset(jcache, 2), False
            tc.reset_slot(tcache, 2)
        if i == 200:  # ... and takes a new request
            jcache, active[2] = insert(jcache, 2, jnp.asarray(row1), jnp.asarray(row1)), True
            tc.insert_prefill(tcache, 2, T(row1), T(row1))
        n0 = int(jcache.n_comp[0])
        if cow_page is None and n0 % PAGE and int(jcache.n_resid[0]) == 100:
            # another holder pins row 0's half-full page: its next flush
            # must copy it to a private page (copy-on-write)
            cow_page = int(jcache.pages.page_table[0, n0 // PAGE])
            jcache = pool_op(jcache, jc.pool_acquire_ids, [cow_page])
            tc.pool_acquire_ids(tcache.pages, torch.tensor([cow_page]))
            pinned = _page_bytes(jcache, cow_page)
        k, v = steps[i], steps[(i * 7) % len(steps)]
        jcache = append(jcache, jnp.asarray(k), jnp.asarray(v))
        tc.append_token(tcache, T(k), T(v))
        if not active.all():
            jcache = mask(jcache, jnp.asarray(active))
            tc.mask_free_slots(tcache, torch.from_numpy(active))
        if i in (79, 139, 199):
            assert_cache_equal(tcache, jcache, fma)
            _conserved(tcache.pages)
    assert cow_page is not None
    # the pinned page kept its bytes and is now held by the pin alone
    assert int(tcache.pages.ref[cow_page]) == 1
    assert cow_page not in tcache.pages.page_table[0].tolist()
    for a, b in zip(pinned, _page_bytes(jcache, cow_page)):
        np.testing.assert_array_equal(a, b)
    jcache = pool_op(jcache, jc._pool_release_ids, [cow_page, POOL])
    tc._pool_release_ids(tcache.pages, torch.tensor([cow_page, POOL]))
    assert_cache_equal(tcache, jcache, fma)
    _conserved(tcache.pages)
    # row 0 reached capacity and stopped flushing (the paged cap)
    assert int(tcache.n_comp[0]) == CAP and int(tcache.n_resid[0]) > tcfg.residual


# ---------------------------------------------------------------------------
# reads: the gathered view and K5's plain version
# ---------------------------------------------------------------------------


def _paged_pair(page, lengths, cap=1024, G=2):
    """A reference paged cache with rows of ``lengths`` tokens (0 = an
    empty row), inserted in shuffled slot order so page ids are not in
    row order, and its port twin."""
    jcfg, tcfg = _configs(paged=True, page_size=page)
    rng = np.random.default_rng(page)
    jcache = jc.alloc_layer_cache(jcfg, B, H, D, cap)
    insert = jit_exact(jc.insert_prefill)
    for r in (2, 0, 1):
        if lengths[r]:
            kv = jnp.asarray(_bf16(synthetic_kv(rng, 1, H, lengths[r], D))[0])
            jcache = insert(jcache, r, kv, kv[:, ::-1])
    q = rng.normal(size=(B, H * G, D)).astype(np.float32)
    return jcache, ref_cache_to_torch(jcache, tcfg), q


@pytest.mark.parametrize("page,n_bucket", [(64, None), (256, 512), (512, None)])
def test_k5_plain_matches_reference_and_k2_on_gathered_view(page, n_bucket):
    """Ragged rows (one empty), full-capacity and bucketed reads."""
    lengths = (1000, 0, 300)
    jcache, tcache, q = _paged_pair(page, lengths)
    sm = D ** -0.5
    want = j_paged_attention(jnp.asarray(q), jcache, sm, n_bucket=n_bucket)
    got = ops.paged_decode_attention(torch.from_numpy(q), tcache, sm,
                                     n_bucket=n_bucket, backend="fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref_path = ops.paged_decode_attention(torch.from_numpy(q), tcache, sm,
                                          n_bucket=n_bucket, backend="ref")
    np.testing.assert_allclose(ref_path.numpy(), np.asarray(want), **TOL)
    n_tok = n_bucket or tcache.capacity
    n = torch.clamp(tcache.n_comp, max=n_tok)
    paged = fused_packed_attention_paged(
        torch.from_numpy(q), tcache.k, tcache.v, tcache.pages.page_table, n,
        n_tok, sm, page_size=page)
    view = tc.gather_paged(tcache, n_bucket)
    dense = fused_packed_attention_torch(torch.from_numpy(q), view.k, view.v,
                                         n, sm, tile_l=min(256, page))
    for a, b in zip(paged, dense):  # K5's tile is min(256, page_size)
        assert torch.equal(a, b)
    # the empty row: zero partials and m = -1e30
    o, m, l = paged
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()


def test_gather_paged_equals_dense_bytes():
    """The same inserts and appends into a dense and a paged cache: the
    gathered view holds the dense bytes on every live token."""
    _, tcfg = _configs(paged=True, page_size=PAGE)
    dcfg = dataclasses.replace(tcfg, paged=False)
    rng = np.random.default_rng(3)
    dense = tc.alloc_layer_cache(dcfg, B, H, D, CAP, device="cpu")
    paged = tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu")
    for r, n in enumerate((200, 64, 10)):
        kv = torch.from_numpy(np.ascontiguousarray(
            _bf16(synthetic_kv(rng, 1, H, n, D))[0]).view(np.uint16)).view(torch.bfloat16)
        for c in (dense, paged):
            tc.insert_prefill(c, r, kv, kv.flip(1))
    steps = torch.from_numpy(rng.normal(size=(150, B, H, 1, D)).astype(np.float32))
    for s in steps.to(torch.bfloat16):
        for c in (dense, paged):
            tc.append_token(c, s, -s)
    assert torch.equal(dense.n_comp, paged.n_comp) and int(paged.n_comp.max()) > PAGE
    for n_bucket in (None, 256):
        view, ref_view = tc.gather_paged(paged, n_bucket), tc.slice_compressed(dense, n_bucket)
        for r in range(B):
            n = int(dense.n_comp[r])
            for a, b in ((view.k, ref_view.k), (view.v, ref_view.v)):
                assert torch.equal(a.chan_perm, b.chan_perm)
                assert torch.equal(a.scale[r, :, :n], b.scale[r, :, :n])
                assert torch.equal(a.zero[r, :, :n], b.zero[r, :, :n])
                for ta, tb in zip(a.tiers, b.tiers):
                    w, P0 = ta.width, n // ta.pack_size
                    assert torch.equal(ta.payload[r, ..., : n * w // 32],
                                       tb.payload[r, ..., : n * w // 32])
                    assert torch.equal(ta.mins[r, ..., :P0], tb.mins[r, ..., :P0])
                    assert torch.equal(ta.shifts[r, ..., : P0 // 4],
                                       tb.shifts[r, ..., : P0 // 4])
        assert torch.equal(view.resid_k, ref_view.resid_k)


def test_release_with_duplicates_and_sentinels_matches_reference():
    """``_pool_release_ids`` with a shared page released twice in one call,
    an over-release (clamped), sentinels, and pops after it: the ledger
    byte-exact with the reference's at every step."""
    jpool = jc.alloc_page_pool(batch=3, capacity=4 * 64, page_size=64, pool_pages=9)
    tpool = tc.alloc_page_pool(3, 4 * 64, 64, 9, device="cpu")
    ops_seq = [
        ("pop_rows", [True, False, True], [0, 0, 0]),
        ("pop_prefix", 1, 3),
        ("acquire", [4, 4, 9, 0]),
        ("release", [4, 4, 9, 4, 0, 0, 0, 2]),  # 4 thrice, 0 thrice (held once)
        ("pop_rows", [True, True, True], [1, 3, 2]),
        ("release_row", 1, 2),
        ("pop_all", 1),
    ]
    for op, *a in ops_seq:
        if op == "pop_rows":
            jpool = jc.pool_pop_rows(jpool, jnp.asarray(a[0]), jnp.asarray(a[1]))
            tc.pool_pop_rows(tpool, torch.tensor(a[0]), torch.tensor(a[1]))
        elif op == "pop_prefix":
            jpool, _ = jc.pool_pop_prefix(jpool, a[0], a[1])
            tc.pool_pop_prefix(tpool, a[0], a[1])
        elif op == "pop_all":
            jpool, _ = jc.pool_pop_all_rows(jpool, a[0])
            tc.pool_pop_all_rows(tpool, a[0])
        elif op == "acquire":
            jpool = jc.pool_acquire_ids(jpool, jnp.asarray(a[0], jnp.int32))
            tc.pool_acquire_ids(tpool, torch.tensor(a[0]))
        elif op == "release":
            jpool = jc._pool_release_ids(jpool, jnp.asarray(a[0], jnp.int32))
            tc._pool_release_ids(tpool, torch.tensor(a[0]))
        else:
            jpool = jc.pool_release_row(jpool, a[0], jnp.int32(a[1]))
            tc.pool_release_row(tpool, a[0], a[1])
        for key in ("page_table", "free", "n_free", "ref"):
            np.testing.assert_array_equal(getattr(tpool, key).numpy(),
                                          np.asarray(getattr(jpool, key)),
                                          err_msg=f"{op}: {key}")
        _conserved(tpool)
