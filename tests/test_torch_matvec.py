"""The port's tier matvec entry points (``ops.packed_qk_scores``,
``packed_weighted_v`` and their paged forms) and the plain versions of
K3, K4, K6 and K7 against the JAX reference. Caches are built by the
reference and carried across with ``ref_cache_to_torch``; inputs come
from numpy seeds.

Tolerance. Both sides sum f32 products in their own order, so a result
is off by at most about ``n * 2^-24 * M``, where n is the number of terms
summed and M the same sum taken over absolute values (``_abs_scores``,
``_abs_out``); a bare rtol/atol could fail where terms cancel. The bound
used is ``2 (n + 2) 2^-24 M``: n = D channels for scores, n = L tokens
for the V output, and 2 more for the rank-1 corrections.

The reference's Pallas kernels run in interpret mode once each (plain K3
and plain K4, at the smallest shape); everything else is held against
its jitted ``xla`` backend. Its paged Pallas route cannot run on this
JAX (no ``pl.load``), so the paged functions are held against its paged
``xla`` route, and bitwise against the port's own dense functions. The
CUDA kernels are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.core.tiered import TierSpec as JTierSpec
from repro.data import synthetic_kv
from repro.kernels import ops as jops
from repro.kernels.kpack_matvec import kpack_tier_scores as j_kpack
from repro.kernels.vpack_matvec import vpack_tier_out as j_vpack
from repro_torch.core import cache as tc
from repro_torch.core import tiered as tt
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kpack_matvec import (
    kpack_tier_scores,
    kpack_tier_scores_paged,
    kpack_tier_scores_torch,
)
from repro_torch.kernels.vpack_matvec import (
    vpack_tier_out,
    vpack_tier_out_paged,
    vpack_tier_out_torch,
)
from torch_port_helpers import ref_cache_to_torch
from torch_threads import one_torch_thread  # noqa: F401

EPS = 2.0 ** -24
j_scores = jax.jit(functools.partial(jops.packed_qk_scores, backend="xla"),
                   static_argnames=("sm_scale",))
j_out = jax.jit(functools.partial(jops.packed_weighted_v, backend="xla"))
j_scores_paged = jax.jit(
    functools.partial(jops.packed_qk_scores_paged, backend="xla"),
    static_argnames=("n_tokens", "sm_scale"))
j_out_paged = jax.jit(functools.partial(jops.packed_weighted_v_paged, backend="xla"))


def _kv(rng, n, H, D):
    return jnp.asarray(synthetic_kv(rng, 1, H, n, D)[0], jnp.bfloat16)


def _dense(rng, B, H, D, L, spec, pack):
    """A reference dense cache, every row full (n_valid does the
    ragging), and its port twin."""
    cfg = jc.PackKVConfig(pack_size=pack, k_spec_static=spec, v_spec_static=spec)
    k = jnp.asarray(synthetic_kv(rng, B, H, L, D), jnp.bfloat16)
    v = jnp.asarray(synthetic_kv(rng, B, H, L, D), jnp.bfloat16)
    cache = jax.jit(jc.prefill_cache)(jc.alloc_layer_cache(cfg, B, H, D, L), k, v)
    return cache, ref_cache_to_torch(cache, tc.PackKVConfig(pack_size=pack))


def _abs_scores(q, kc: tt.TieredCache, sm: float) -> np.ndarray:
    """sum_c |q_c| |K_int[c, l]| |scale_l| + sum_c |q_c| |zero_l|, times sm."""
    B, H, D = q.shape
    h_kv = kc.chan_perm.shape[1]
    qp = ref._perm_q(ref._grouped_q(q.abs(), h_kv), kc.chan_perm)
    si = 0
    for t, (o0, o1) in zip(kc.tiers, zip(kc.spec.offsets(), kc.spec.offsets()[1:])):
        ints = tt.unpack_tier(t, kc.capacity).to(torch.float32).abs()
        si = si + torch.einsum("bhgc,bhcl->bhgl", qp[..., o0:o1], ints)
    m = si * kc.scale.abs()[:, :, None] + qp.sum(-1, keepdim=True) * kc.zero.abs()[:, :, None]
    return (m * sm).reshape(B, H, -1).numpy()


def _abs_out(w, vc: tt.TieredCache) -> np.ndarray:
    """sum_l |w_l| (|scale_l| |V_int[c, l]| + |zero_l|), original channels."""
    B, H, L = w.shape
    h_kv = vc.chan_perm.shape[1]
    wg = w.abs().reshape(B, h_kv, H // h_kv, L)
    ints = torch.cat([tt.unpack_tier(t, L).to(torch.float32).abs() for t in vc.tiers], -2)
    out = torch.einsum("bhgl,bhcl->bhgc", wg * vc.scale.abs()[:, :, None], ints)
    out = out + torch.einsum("bhgl,bhl->bhg", wg, vc.zero.abs())[..., None]
    return ref._unpermute(out, vc.chan_perm).reshape(B, H, -1).numpy()


def _close(got, want, mag, n: int, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    bound = 2 * (n + 2) * EPS * mag + 1e-30
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, f"{msg}: {excess.max()} past the bound"


# (B, H_kv, G, D, L, tile, spec widths/counts, pack, n_valid)
CASES = [
    (3, 2, 2, 64, 256, 64, None, 8, [256, 0, 100]),  # the default (2,4,8) spec
    (2, 2, 1, 64, 256, 128, ((1, 2, 4, 8, 16), (16, 8, 16, 8, 16)), 16, [37, 256]),
    (2, 1, 4, 32, 128, 256, ((2, 4), (8, 24)), 8, 77),  # scalar count
    (1, 2, 2, 32, 128, 64, ((4, 8), (24, 8)), 8, None),
]


@pytest.mark.parametrize("B,H,G,D,L,tile,spec,pack,nv", CASES)
def test_ops_match_reference(B, H, G, D, L, tile, spec, pack, nv):
    """Both port backends of packed_qk_scores / packed_weighted_v against
    the reference's xla backend; zeros at and past n_valid."""
    rng = np.random.default_rng(B * 1000 + L + D)
    jspec = None if spec is None else JTierSpec(*spec, pack_size=pack)
    jcache, tcache = _dense(rng, B, H, D, L, jspec, pack)
    q = rng.normal(size=(B, H * G, D)).astype(np.float32)
    w = rng.random(size=(B, H * G, L)).astype(np.float32)
    jnv = None if nv is None else jnp.asarray(nv, jnp.int32)
    tnv = None if nv is None else torch.tensor(nv, dtype=torch.int32)
    sm = 0.125
    want_s = np.asarray(j_scores(jnp.asarray(q), jcache.k, sm, n_valid=jnv))
    want_o = np.asarray(j_out(jnp.asarray(w), jcache.v, n_valid=jnv))
    mag_s = _abs_scores(torch.from_numpy(q), tcache.k, sm)
    mag_o = _abs_out(torch.from_numpy(w), tcache.v)
    for backend in ("fused", "ref"):
        s = ops.packed_qk_scores(torch.from_numpy(q), tcache.k, sm, n_valid=tnv,
                                 backend=backend, tile_l=tile)
        _close(s, want_s, mag_s, D, f"scores/{backend}")
        o = ops.packed_weighted_v(torch.from_numpy(w), tcache.v, n_valid=tnv,
                                  backend=backend, tile_l=tile)
        _close(o, want_o, mag_o, L, f"out/{backend}")
        if nv is not None:
            rows = np.broadcast_to(np.asarray(nv), (B,))
            for r, n in enumerate(rows):
                assert not s[r, :, n:].any()
                if n == 0:
                    assert not o[r].any()


def _rand_tier(rng, BH, C, L, width, pack):
    words = rng.integers(0, 2 ** 32, size=(BH, C, L * width // 32), dtype=np.uint32)
    mins = rng.integers(-60, 60, size=(BH, C, L // pack)).astype(np.int8)
    shifts = rng.integers(0, 256, size=(BH, C, -(-L // pack // 4))).astype(np.uint8)
    return words, mins, shifts


def test_plain_k3_k4_match_pallas_interpret():
    """Plain K3 and K4 against the reference's Pallas kernels in interpret
    mode (the smallest shape: 2 rows, 16 channels, 64 tokens, tile 32,
    one row cut at 20 tokens)."""
    rng = np.random.default_rng(3)
    BH, G, C, L, width, pack = 2, 1, 16, 64, 4, 8
    words, mins, shifts = _rand_tier(rng, BH, C, L, width, pack)
    q = rng.normal(size=(BH, G, C)).astype(np.float32)
    w = rng.random(size=(BH, G, L)).astype(np.float32)
    nv = np.asarray([64, 20], np.int32)
    kw = dict(width=width, pack_size=pack, tile_l=32)
    jl = (jnp.asarray(words), jnp.asarray(mins), jnp.asarray(shifts))
    tl = (torch.from_numpy(words.view(np.int32)), torch.from_numpy(mins),
          torch.from_numpy(shifts))
    want_s = np.asarray(j_kpack(*jl, jnp.asarray(q), n_valid=jnp.asarray(nv),
                                interpret=True, **kw))
    want_o = np.asarray(j_vpack(*jl, jnp.asarray(w), n_valid=jnp.asarray(nv),
                                interpret=True, **kw))
    got_s = kpack_tier_scores_torch(*tl, torch.from_numpy(q), n_valid=torch.from_numpy(nv), **kw)
    got_o = vpack_tier_out_torch(*tl, torch.from_numpy(w), n_valid=torch.from_numpy(nv), **kw)
    ints = np.abs(tt.unpack_tier(tt.TierBuffer(*tl, width, pack), L).numpy()).astype(np.float32)
    _close(got_s, want_s, np.einsum("rgc,rcl->rgl", np.abs(q), ints), C, "K3")
    _close(got_o, want_o, np.einsum("rgl,rcl->rgc", w, ints), L, "K4")
    assert not got_s[1, :, 20:].any()


def _paged_pair(rng, page, lengths, cap, spec, pack, G=2):
    """A reference paged cache with rows of ``lengths`` tokens inserted in
    shuffled slot order (page ids out of row order), its port twin, and q
    and w."""
    B, H, D = len(lengths), 2, 32
    jspec = JTierSpec(*spec, pack_size=pack)
    jcfg = jc.PackKVConfig(pack_size=pack, k_spec_static=jspec,
                           v_spec_static=jspec, paged=True, page_size=page)
    jcache = jc.alloc_layer_cache(jcfg, B, H, D, cap)
    insert = jax.jit(jc.insert_prefill)
    for r in rng.permutation(B):
        if lengths[r]:
            jcache = insert(jcache, int(r), _kv(rng, lengths[r], H, D), _kv(rng, lengths[r], H, D))
    tcfg = tc.PackKVConfig(pack_size=pack, paged=True, page_size=page)
    q = rng.normal(size=(B, H * G, D)).astype(np.float32)
    w = rng.random(size=(B, H * G, cap)).astype(np.float32)
    return jcache, ref_cache_to_torch(jcache, tcfg), q, w


@pytest.mark.parametrize("page,n_tok,spec,pack", [
    (128, 512, ((2, 4, 8), (8, 16, 8)), 8),
    (64, 256, ((1, 4, 16), (8, 16, 8)), 16),
])
def test_paged_ops_match_reference_and_dense(page, n_tok, spec, pack):
    """The paged functions: within the bound of the reference's paged xla
    route, and bitwise equal to the port's dense functions on the gathered
    view (tile 64: two tiles a page at page 128), both backends."""
    rng = np.random.default_rng(page)
    jcache, tcache, q, w = _paged_pair(rng, page, (500, 0, 200, 64), 512, spec, pack)
    nv = torch.clamp(tcache.n_comp, max=n_tok)
    jnv = jnp.asarray(nv.numpy())
    w = w[..., :n_tok]
    tq, tw, sm = torch.from_numpy(q), torch.from_numpy(w), 0.125
    view = tc.gather_paged(tcache, n_tok)
    want_s = np.asarray(j_scores_paged(jnp.asarray(q), jcache.k, jcache.pages, n_tok, sm,
                                       n_valid=jnv))
    want_o = np.asarray(j_out_paged(jnp.asarray(w), jcache.v, jcache.pages, n_valid=jnv))
    mag_s, mag_o = _abs_scores(tq, view.k, sm), _abs_out(tw, view.v)
    for backend in ("fused", "ref"):
        s = ops.packed_qk_scores_paged(tq, tcache.k, tcache.pages, n_tok, sm,
                                       n_valid=nv, backend=backend, tile_l=64)
        o = ops.packed_weighted_v_paged(tw, tcache.v, tcache.pages, n_valid=nv,
                                        backend=backend, tile_l=64)
        _close(s, want_s, mag_s, 32, f"paged scores/{backend}")
        _close(o, want_o, mag_o, n_tok, f"paged out/{backend}")
        s_dense = ops.packed_qk_scores(tq, view.k, sm, n_valid=nv, backend=backend,
                                       tile_l=64)
        o_dense = ops.packed_weighted_v(tw, view.v, n_valid=nv, backend=backend,
                                        tile_l=64)
        assert torch.equal(s, s_dense) and torch.equal(o, o_dense), backend
        assert not s[1].any() and not s[3, :, 64:].any()


@pytest.mark.parametrize("backend", ["fused", "ref"])
def test_bucketed_slice_equals_full(backend):
    """A bucket view (``slice_compressed``) gives the full launch's live
    columns bitwise, and the full launch's columns past the bucket are
    zero (the reference's tests/test_bucketed.py for the port)."""
    rng = np.random.default_rng(9)
    B, H, G, D, L = 2, 2, 2, 64, 512
    _, tcache = _dense(rng, B, H, D, L, None, 8)
    nv = torch.tensor([192, 64], dtype=torch.int32)
    sliced = tc.slice_compressed(tcache, 256)
    q = torch.from_numpy(rng.normal(size=(B, H * G, D)).astype(np.float32))
    w = torch.softmax(torch.from_numpy(rng.normal(size=(B, H * G, L)).astype(np.float32)), -1)
    s_full = ops.packed_qk_scores(q, tcache.k, 0.125, n_valid=nv, backend=backend, tile_l=64)
    s_slice = ops.packed_qk_scores(q, sliced.k, 0.125, n_valid=nv, backend=backend, tile_l=64)
    assert torch.equal(s_slice, s_full[..., :256]) and not s_full[..., 256:].any()
    o_full = ops.packed_weighted_v(w, tcache.v, n_valid=nv, backend=backend, tile_l=64)
    o_slice = ops.packed_weighted_v(w[..., :256].contiguous(), sliced.v, n_valid=nv,
                                    backend=backend, tile_l=64)
    assert torch.equal(o_slice, o_full)


def test_rejections_and_launch_counters():
    """The reference's tiling rules raise (its asserts), a width with no
    kernel decode raises where the reference divides by zero, and CPU
    calls run the plain versions without counting a launch."""
    rng = np.random.default_rng(5)
    words, mins, shifts = _rand_tier(rng, 2, 8, 128, 4, 8)
    leaves = (torch.from_numpy(words.view(np.int32)), torch.from_numpy(mins),
              torch.from_numpy(shifts))
    q = torch.ones((2, 1, 8))
    w = torch.ones((2, 1, 128))
    fns = (kpack_tier_scores, kpack_tier_scores_paged, vpack_tier_out,
           vpack_tier_out_paged)
    before = [f.launches for f in fns]
    kpack_tier_scores(*leaves, q, width=4, pack_size=8, tile_l=64)
    vpack_tier_out(*leaves, w, width=4, pack_size=8, n_valid=torch.tensor([5, 0]))
    with pytest.raises(ValueError, match="tiling"):  # 128 % 96
        kpack_tier_scores(*leaves, q, width=4, pack_size=8, tile_l=96)
    with pytest.raises(ValueError, match="tiling"):  # 16 % (4 * 8)
        vpack_tier_out(*leaves, w, width=4, pack_size=8, tile_l=16)
    with pytest.raises(ValueError, match="width 0"):
        kpack_tier_scores(*leaves, q, width=0, pack_size=8)
    with pytest.raises(ValueError, match="width 3"):
        vpack_tier_out(*leaves, w, width=3, pack_size=8)
    # pool leaves [H_kv=1, P=2, C, page 128]
    pool = tuple(x.reshape(1, 2, 8, -1).contiguous() for x in leaves)
    table = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    n = torch.tensor([128, 3], dtype=torch.int32)
    s = kpack_tier_scores_paged(*pool, q, table, n, 128, width=4, pack_size=8,
                                page_size=128)
    assert s.shape == (2, 1, 128) and not s[1, :, 3:].any()
    for n_tok, page in ((96, 128), (0, 128), (384, 128), (128, 64)):
        with pytest.raises(ValueError):  # not whole pages / none / past the
            # table / a page the pool does not hold
            kpack_tier_scores_paged(*pool, q, table, n, n_tok, width=4,
                                    pack_size=8, page_size=page)
    with pytest.raises(ValueError):
        vpack_tier_out_paged(*pool, w[..., :96], table, n, width=4,
                             pack_size=8, page_size=128)
    tiny = tc.alloc_layer_cache(tc.PackKVConfig(), 1, 1, 32, 64, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        ops.packed_qk_scores(torch.ones(1, 2, 32), tiny.k, backend="pallas")
    assert [f.launches for f in fns] == before
