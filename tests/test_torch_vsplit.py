"""The split structure of the CUDA kernel of K4/K7, in plain PyTorch. The
kernel sums each SPAN-token span of a row in token order and the span
partials in span order; the plain versions' tile loop
(``vpack_tier_out_torch`` and its paged form) does the same at its default
tile of SPAN tokens, so there is no separate split version to hold.

  * the default tile is the kernel's span;
  * the plain version against an exact f64 sum and the reference's Pallas
    kernel run as its own tests run it (interpret mode): widths 1, 4 and
    16, packs 8 and 16, G = 1 and 4, ragged rows with an empty one;
  * bitwise the same result over the page pool at pages 64 and 256 as
    over the gathered dense rows at the same tile, and over a 1024-token
    bucket as over the 2048-token capacity when every count fits the
    bucket.

Tolerance: both sides sum f32 products in their own order, so a result is
off by at most about ``n * 2^-24 * M`` (n terms, M their absolute sum);
the bound used is ``2 (n + 2) 2^-24 M`` with n the row's tokens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vpack_matvec import vpack_tier_out as j_vpack
from repro_torch.core import tiered as tt
from repro_torch.kernels.kpack_matvec import DEFAULT_TILE_L
from repro_torch.kernels.packed_attention import SPAN
from repro_torch.kernels.vpack_matvec import vpack_tier_out_paged_torch, vpack_tier_out_torch
from torch_threads import one_torch_thread  # noqa: F401

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


def _ints(leaves, width, pack, L):
    """The tier's decoded integers V_int [BH, C, L] as f64."""
    return tt.unpack_tier(tt.TierBuffer(*leaves, width, pack), L).to(torch.float64)


def _close(got, want, mag, n: int, msg: str):
    diff = np.abs(np.array(got, np.float64) - np.array(want, np.float64))
    excess = diff - (2 * (n + 2) * EPS * mag.numpy() + 1e-30)
    assert excess.max() <= 0, f"{msg}: {excess.max()} past the bound"


@pytest.mark.parametrize("width,pack,G", [(1, 8, 4), (4, 16, 1), (16, 8, 1), (16, 16, 4)])
def test_split_matches_plain_and_pallas_interpret(width, pack, G):
    """Two spans of four rows (one empty, one cut mid-chunk): the plain
    version at its default tile (the kernel's span split) within the f32
    bound of the exact f64 sum and of the reference's Pallas kernel in
    interpret mode; the empty row exactly zero."""
    assert DEFAULT_TILE_L == SPAN
    rng = np.random.default_rng(width * 100 + pack + G)
    BH, C, L = 4, 16, 512
    words, mins, shifts = _rand_tier(rng, BH, C, L, width, pack)
    w = rng.random(size=(BH, G, L)).astype(np.float32)
    nv = np.asarray([300, 0, 512, 77], np.int32)
    leaves = _torch_leaves(words, mins, shifts)
    tw, tnv = torch.from_numpy(w), torch.from_numpy(nv)
    kw = dict(width=width, pack_size=pack)
    got = vpack_tier_out_torch(*leaves, tw, n_valid=tnv, **kw)
    mask = torch.arange(L)[None, None, :] < tnv[:, None, None]
    live = torch.where(mask, tw, 0.0).to(torch.float64)
    ints = _ints(leaves, width, pack, L)
    mag = torch.einsum("rgl,rcl->rgc", live.abs(), ints.abs())
    _close(got, torch.einsum("rgl,rcl->rgc", live, ints), mag, L, "exact sum")
    want = j_vpack(jnp.asarray(words), jnp.asarray(mins), jnp.asarray(shifts), jnp.asarray(w),
                   n_valid=jnp.asarray(nv), interpret=True, **kw)
    _close(got, want, mag, L, "pallas interpret")
    assert not got[1].any()


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
def test_paged_split_bitwise_equals_dense(page):
    """The tiles depend on token indices only: the pool's pages under a
    shuffled table give the dense rows' bits at the same tile (the paged
    plain version, like the reference's, tiles within a page: 64 tokens
    at page 64, the kernel's span at page 256; the kernel itself spans
    pages, and K7 == K4 bitwise is held on the card)."""
    rng = np.random.default_rng(page)
    B, h_kv, C, L, width, pack = 3, 2, 8, 1024, 4, 8
    words, mins, shifts = _rand_tier(rng, B * h_kv, C, L, width, pack)
    leaves = _torch_leaves(words, mins, shifts)
    w = torch.from_numpy(rng.random(size=(B * h_kv, 2, L)).astype(np.float32))
    nv = torch.tensor([1024, 1024, 0, 0, 700, 700], dtype=torch.int32)
    table = torch.from_numpy(rng.permutation(B * (L // page)).astype(np.int32)).reshape(B, -1)
    units = [page * width // 32, page // pack, page // pack // 4]
    pool = [_scatter_to_pool(x, table, h_kv, u) for x, u in zip(leaves, units)]
    kw = dict(width=width, pack_size=pack)
    dense = vpack_tier_out_torch(*leaves, w, n_valid=nv, tile_l=min(SPAN, page), **kw)
    paged = vpack_tier_out_paged_torch(*pool, w, table, nv, page_size=page, **kw)
    assert torch.equal(paged, dense)


def test_split_bucket_bitwise_equals_capacity():
    """A 1024-token bucket (the leaves' prefix) gives the 2048-token
    capacity's bits when every row's count fits the bucket."""
    rng = np.random.default_rng(11)
    BH, C, L, width, pack = 3, 8, 2048, 2, 16
    words, mins, shifts = _rand_tier(rng, BH, C, L, width, pack)
    leaves = _torch_leaves(words, mins, shifts)
    w = torch.from_numpy(rng.random(size=(BH, 1, L)).astype(np.float32))
    nv = torch.tensor([1024, 600, 0], dtype=torch.int32)
    kw = dict(width=width, pack_size=pack)
    full = vpack_tier_out_torch(*leaves, w, n_valid=nv, **kw)
    bucket = [x[..., :n] for x, n in zip(leaves, (1024 * width // 32, 1024 // pack,
                                                   1024 // pack // 4))]
    sliced = vpack_tier_out_torch(*bucket, w[..., :1024], n_valid=nv, **kw)
    assert torch.equal(sliced, full)
