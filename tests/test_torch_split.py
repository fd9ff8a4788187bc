"""The split structure of the CUDA kernel of K2/K5, in plain PyTorch:
SPAN-token windows, each with one max and one sum, merged in window
order (``fused_packed_attention_split_torch`` and its paged form).

  * against the unsplit plain version (the reference's tile loop) and,
    merged with the residual buffer, against the reference's oracle
    ``ref.packed_decode_attention_ref``: ragged rows with an empty one,
    G = 1 and G = 4;
  * bitwise the same partials over two buckets (a 1024-token view and
    the 2048-token capacity, every count within 1024) and over the page
    pool at pages 64 and 256 as over the dense cache.

Tolerance rtol=1e-5, atol=1e-4 on m, l and o / l: f32 throughout, summed
in another order (the unnormalized o reaches ~1e2 over long rows)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.core.tiered import TierSpec as JTierSpec
from repro.data import synthetic_kv
from repro.kernels import ref as jref
from repro_torch.core import cache as tc
from repro_torch.core import tiered as tt
from repro_torch.kernels import ops
from repro_torch.kernels.packed_attention import (
    fused_packed_attention_paged_split_torch,
    fused_packed_attention_split_torch,
    fused_packed_attention_torch,
)
from torch_port_helpers import ref_cache_to_torch
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-4)
j_attention = jax.jit(jref.packed_decode_attention_ref)


def _norm(o, l):
    return o / torch.clamp(l, min=1e-30)[..., None]


def _assert_partials_close(got, want):
    (o, m, l), (wo, wm, wl) = got, want
    torch.testing.assert_close(m, wm, **TOL)
    torch.testing.assert_close(l, wl, **TOL)
    torch.testing.assert_close(_norm(o, l), _norm(wo, wl), **TOL)


@pytest.mark.parametrize("G,widths,counts", [
    (1, (4,), (64,)),
    (4, (2, 4, 8), (16, 32, 16)),
])
def test_split_matches_unsplit_and_reference(G, widths, counts):
    """Three ragged rows (one empty) over a 1024-token cache: four
    windows merged in order give the tile loop's partials and, with the
    residual merged in, the reference oracle's attention."""
    B, Hkv, D, L = 3, 2, 64, 1024
    lengths = (1000, 0, 600)
    rng = np.random.default_rng(G)
    spec = JTierSpec(widths, counts, 8)
    n0 = max(lengths)
    k = jnp.asarray(synthetic_kv(rng, B, Hkv, n0, D))
    v = jnp.asarray(synthetic_kv(rng, B, Hkv, n0, D))
    cfg = jc.PackKVConfig(k_spec_static=spec, v_spec_static=spec)
    jcache = jax.jit(jc.prefill_cache)(jc.alloc_layer_cache(cfg, B, Hkv, D, L), k, v)
    n_comp = [(n // 64) * 64 for n in lengths]
    n_resid = [min(n - c, n0 - (n0 // 64) * 64) for n, c in zip(lengths, n_comp)]
    jcache = dataclasses.replace(jcache, n_comp=jnp.asarray(n_comp, jnp.int32),
                                 n_resid=jnp.asarray(n_resid, jnp.int32))
    cache = ref_cache_to_torch(jcache, tc.PackKVConfig(pack_size=8))
    qn = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    q = torch.from_numpy(qn)
    sm = 1.0 / np.sqrt(D)

    split = fused_packed_attention_split_torch(q, cache.k, cache.v, cache.n_comp, sm)
    _assert_partials_close(split, fused_packed_attention_torch(
        q, cache.k, cache.v, cache.n_comp, sm))
    o, m, l = split
    assert not o[1].any() and (m[1] == -1e30).all() and not l[1].any()

    resid = ops._residual_partials(q, cache.resid_k, cache.resid_v, cache.n_resid, sm)
    got = ops.merge_partials(*split, *resid)
    want = j_attention(jnp.asarray(qn), jcache.k, jcache.v, jcache.resid_k,
                       jcache.resid_v, jcache.n_comp, jcache.n_resid, sm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _to_pool(cache, page: int, gen: torch.Generator):
    """The dense cache's pages scattered into a pool of B * L / page pages
    under a shuffled page table."""
    B, h_kv, L = cache.k.scale.shape
    cfg = dataclasses.replace(cache.cfg, paged=True, page_size=page)
    paged = tc.alloc_layer_cache(cfg, B, h_kv, cache.k.spec.head_dim, L, device="cpu")
    phys = torch.randperm(B * (L // page), generator=gen).to(torch.int32)
    phys = phys.reshape(B, L // page)
    for pool, dense in ((paged.k, cache.k), (paged.v, cache.v)):
        tc._scatter_pages_tiered(pool, dense, phys)
        pool.chan_perm.copy_(dense.chan_perm)
    paged.pages.page_table.copy_(phys)
    paged.n_comp.copy_(cache.n_comp)
    return paged


def test_split_bitwise_over_buckets_and_pages():
    """The windows depend on token indices only: a 1024-token bucket view
    and the 2048-token capacity give the same bits when every count fits
    the bucket, and so do pools of 64- and 256-token pages."""
    gen = torch.Generator().manual_seed(5)
    spec = tt.TierSpec((4, 8), (48, 16), 8)
    cfg = tc.PackKVConfig(k_spec_static=spec, v_spec_static=spec)
    B, Hkv, D, L = 3, 2, 64, 2048
    cache = tc.alloc_layer_cache(cfg, B, Hkv, D, L, device="cpu")
    for r, n in enumerate((1024, 0, 704)):
        if n:
            kv = [(torch.randn((Hkv, n, D), generator=gen) * 2 + 1).to(torch.bfloat16)
                  for _ in range(2)]
            tc.insert_prefill(cache, r, *kv)
    q = torch.randn((B, Hkv * 2, D), generator=gen)
    n = torch.clamp(cache.n_comp, max=1024)
    full = fused_packed_attention_split_torch(q, cache.k, cache.v, n, 0.1)
    view = tc.slice_compressed(cache, 1024)
    sliced = fused_packed_attention_split_torch(q, view.k, view.v, n, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(sliced, full))
    for page in (64, 256):
        paged = _to_pool(cache, page, gen)
        got = fused_packed_attention_paged_split_torch(
            q, paged.k, paged.v, paged.pages.page_table, n, L, 0.1, page_size=page)
        assert all(torch.equal(a, b) for a, b in zip(got, full)), page
