"""The plain version of K3/K6 that the CUDA kernel is held against on the
card. The kernel sums each token's score over the tier's channels: each
consumer warp over its own channels in channel order, then the warps'
partials in warp order, so its sum order differs from the plain
version's ``torch.bmm`` only within a token's channel sum; what is held
here is that the plain version is right:

  * against an exact f64 sum and the reference's Pallas kernel run as its
    own tests run it (interpret mode): widths 1, 4 and 16, packs 8 and 16,
    G = 1 and 4, ragged rows with an empty one and one cut mid-chunk;
  * bitwise the same result over the page pool at pages 64 and 256 as
    over the gathered dense rows at the same tile.

(The reference's paged Pallas kernel does not run on this JAX: no
``pl.load``; the paged plain version is held bitwise to the dense one.)

Tolerance: both sides sum f32 products in their own order, so a score is
off by at most about ``n * 2^-24 * M`` (n terms, M their absolute sum);
the bound used is ``2 (n + 2) 2^-24 M`` with n the tier's channels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kpack_matvec import kpack_tier_scores as j_kpack
from repro_torch.core import tiered as tt
from repro_torch.kernels.kpack_matvec import (
    kpack_tier_scores_paged_torch,
    kpack_tier_scores_torch,
)
from repro_torch.kernels.packed_attention import SPAN

torch.set_num_threads(2)

EPS = 2.0 ** -24


def _rand_tier(rng, BH, C, L, width, pack):
    """Random tier leaves over L tokens: u32 words, int8 mins, shift bytes."""
    words = rng.integers(0, 2 ** 32, size=(BH, C, L * width // 32), dtype=np.uint32)
    mins = rng.integers(-60, 60, size=(BH, C, L // pack)).astype(np.int8)
    shifts = rng.integers(0, 256, size=(BH, C, -(-L // pack // 4))).astype(np.uint8)
    return words, mins, shifts


def _torch_leaves(words, mins, shifts):
    return (torch.from_numpy(words.view(np.int32)), torch.from_numpy(mins),
            torch.from_numpy(shifts))


def _close(got, want, mag, n: int, msg: str):
    diff = np.abs(np.array(got, np.float64) - np.array(want, np.float64))
    excess = diff - (2 * (n + 2) * EPS * mag.numpy() + 1e-30)
    assert excess.max() <= 0, f"{msg}: {excess.max()} past the bound"


@pytest.mark.parametrize("width,pack,G", [(1, 8, 1), (1, 16, 4), (4, 8, 4), (4, 16, 1),
                                          (16, 8, 1), (16, 16, 4)])
def test_plain_k3_matches_exact_and_pallas_interpret(width, pack, G):
    """Two spans of four rows (one empty, one cut mid-chunk): the plain K3
    within the f32 bound of the exact f64 sum and of the reference's
    Pallas kernel in interpret mode; every score at or past a row's count
    exactly zero."""
    rng = np.random.default_rng(width * 100 + pack + G)
    BH, C, L = 4, 24, 512
    words, mins, shifts = _rand_tier(rng, BH, C, L, width, pack)
    q = rng.normal(size=(BH, G, C)).astype(np.float32)
    nv = np.asarray([300, 0, 512, 77], np.int32)
    leaves = _torch_leaves(words, mins, shifts)
    tq, tnv = torch.from_numpy(q), torch.from_numpy(nv)
    kw = dict(width=width, pack_size=pack)
    got = kpack_tier_scores_torch(*leaves, tq, n_valid=tnv, **kw)
    ints = tt.unpack_tier(tt.TierBuffer(*leaves, width, pack), L).to(torch.float64)
    mask = torch.arange(L)[None, None, :] < tnv[:, None, None]
    exact = torch.where(mask, torch.einsum("rgc,rcl->rgl", tq.double(), ints), 0.0)
    mag = torch.einsum("rgc,rcl->rgl", tq.double().abs(), ints.abs())
    _close(got, exact, mag, C, "exact sum")
    want = j_kpack(jnp.asarray(words), jnp.asarray(mins), jnp.asarray(shifts), jnp.asarray(q),
                   n_valid=jnp.asarray(nv), interpret=True, **kw)
    _close(got, want, mag, C, "pallas interpret")
    for r, n in enumerate(nv):
        assert not got[r, :, n:].any()


def _scatter_to_pool(leaf, table, h_kv, page_units):
    """Dense leaf [B * H_kv, C, L units] -> pool [H_kv, P, C, page units]
    with page j of batch row b at physical page table[b, j]."""
    BH, C, units = leaf.shape
    B, n_pages = table.shape
    pool = torch.zeros((h_kv, B * n_pages, C, page_units), dtype=leaf.dtype)
    rows = leaf.reshape(B, h_kv, C, n_pages, page_units)
    for b in range(B):
        for j in range(n_pages):
            pool[:, int(table[b, j])] = rows[b, :, :, j]
    return pool


@pytest.mark.parametrize("page", [64, 256])
def test_paged_plain_k6_bitwise_equals_dense_k3(page):
    """The pool's pages under a shuffled table give the dense rows' bits
    at the same tile (the paged plain version, like the reference's, tiles
    within a page: 64 tokens at page 64, the kernel's span at page 256),
    zeros at and past each row's count included."""
    rng = np.random.default_rng(page + 1)
    B, h_kv, C, L, width, pack, G = 3, 2, 8, 1024, 4, 8, 2
    words, mins, shifts = _rand_tier(rng, B * h_kv, C, L, width, pack)
    leaves = _torch_leaves(words, mins, shifts)
    q = torch.from_numpy(rng.normal(size=(B * h_kv, G, C)).astype(np.float32))
    nv = torch.tensor([1024, 1024, 0, 0, 700, 700], dtype=torch.int32)
    table = torch.from_numpy(rng.permutation(B * (L // page)).astype(np.int32)).reshape(B, -1)
    units = [page * width // 32, page // pack, page // pack // 4]
    pool = [_scatter_to_pool(x, table, h_kv, u) for x, u in zip(leaves, units)]
    kw = dict(width=width, pack_size=pack)
    dense = kpack_tier_scores_torch(*leaves, q, n_valid=nv, tile_l=min(SPAN, page), **kw)
    paged = kpack_tier_scores_paged_torch(*pool, q, table, nv, L, page_size=page, **kw)
    assert torch.equal(paged, dense)
    assert dense[4:].abs().sum() > 0 and not dense[2:4].any() and not dense[4:, :, 700:].any()
