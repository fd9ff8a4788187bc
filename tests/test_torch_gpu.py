"""The CUDA kernels of the torch port against their plain PyTorch versions,
on the card. Every test here needs a CUDA GPU and skips without one; run
them there with

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the reference package, so it runs where
only PyTorch is installed. Tolerance rtol=1e-5, atol=1e-4 (f32, another
summation order); the tier matvecs (K3, K4, K6, K7) are held within
``2 (n + 2) 2^-24`` times the sum of their n terms' absolute values, as
in tests/test_torch_matvec.py."""
import numpy as np
import pytest
import torch

from repro_torch.core import cache as tc
from repro_torch.core import tiered as tt
from repro_torch.kernels.kpack_matvec import (
    kpack_tier_scores,
    kpack_tier_scores_paged,
    kpack_tier_scores_paged_torch,
    kpack_tier_scores_torch,
)
from repro_torch.kernels.packed_attention import (
    _rows_to_bh,
    fused_packed_attention,
    fused_packed_attention_paged,
    fused_packed_attention_paged_torch,
    fused_packed_attention_split_torch,
    fused_packed_attention_torch,
)
from repro_torch.kernels.vpack_matvec import (
    vpack_tier_out,
    vpack_tier_out_paged,
    vpack_tier_out_paged_torch,
    vpack_tier_out_torch,
)

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _random_cache(gen, B, Hkv, D, L, spec, lengths, device):
    cfg = tc.PackKVConfig(pack_size=spec.pack_size, k_spec_static=spec,
                          v_spec_static=spec)
    cache = tc.alloc_layer_cache(cfg, B, Hkv, D, L, device=device)
    for r, n in enumerate(lengths):
        if n:
            k = torch.randn((Hkv, n, D), generator=gen, device=device).to(torch.bfloat16)
            v = torch.randn((Hkv, n, D), generator=gen, device=device).to(torch.bfloat16)
            tc.insert_prefill(cache, r, k, v)
    return cache


@pytest.mark.gpu
@pytest.mark.parametrize("widths,counts,pack,G", [
    ((1, 2, 4, 8), (32, 32, 32, 32), 8, 1),
    ((4, 16), (96, 32), 16, 4),
])
def test_cuda_kernel_matches_plain(cuda, widths, counts, pack, G):
    gen = torch.Generator(device=cuda).manual_seed(0)
    spec = tt.TierSpec(widths, counts, pack)
    cache = _random_cache(gen, 3, 4, 128, 512, spec, (512, 200, 0), cuda)
    q = torch.randn((3, 4 * G, 128), generator=gen, device=cuda)
    for n_bucket in (None, 256):
        c = tc.slice_compressed(cache, n_bucket)
        n = torch.clamp(c.n_comp, max=c.k.capacity)
        before = fused_packed_attention.launches
        got = fused_packed_attention(q, c.k, c.v, n, 0.1)
        again = fused_packed_attention(q, c.k, c.v, n, 0.1)
        torch.cuda.synchronize()
        assert fused_packed_attention.launches == before + 2
        want = fused_packed_attention_torch(q, c.k, c.v, n, 0.1)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)  # deterministic: no atomics
            torch.testing.assert_close(g, w, **TOL)


def _to_pool(cache, page, gen):
    """The dense cache's pages scattered into a pool of B * L / page pages
    under a shuffled page table."""
    import dataclasses

    B, h_kv, L = cache.k.scale.shape
    cfg = dataclasses.replace(cache.cfg, paged=True, page_size=page)
    paged = tc.alloc_layer_cache(cfg, B, h_kv, cache.k.spec.head_dim, L,
                                 device=cache.n_comp.device)
    phys = torch.randperm(B * (L // page), generator=gen, device=gen.device)
    phys = phys.to(torch.int32).reshape(B, L // page)
    for pool, dense in ((paged.k, cache.k), (paged.v, cache.v)):
        tc._scatter_pages_tiered(pool, dense, phys)
        pool.chan_perm.copy_(dense.chan_perm)
    paged.pages.page_table.copy_(phys)
    paged.n_comp.copy_(cache.n_comp)
    return paged


@pytest.mark.gpu
@pytest.mark.parametrize("page", [64, 128, 256, 512])
@pytest.mark.parametrize("widths,counts,pack,G", [
    ((4,), (128,), 8, 1),
    ((1, 2, 4, 8), (32, 32, 32, 32), 8, 4),
])
def test_paged_kernel_matches_plain_and_k2(cuda, page, widths, counts, pack, G):
    """K5 over a shuffled page table and ragged rows (one empty): within
    tolerance of its plain version, bitwise equal to K2 on the gathered
    dense view at every page size (a span covers several pages or part of
    one), bitwise equal to itself."""
    gen = torch.Generator(device=cuda).manual_seed(page)
    spec = tt.TierSpec(widths, counts, pack)
    cache = _random_cache(gen, 4, 4, 128, 1024, spec, (1024, 0, 300, 700), cuda)
    q = torch.randn((4, 4 * G, 128), generator=gen, device=cuda)
    paged = _to_pool(cache, page, gen)
    for n_tok in (1024, 512):
        n = torch.clamp(cache.n_comp, max=n_tok)
        args = (q, paged.k, paged.v, paged.pages.page_table, n, n_tok, 0.1)
        before = fused_packed_attention_paged.launches
        got = fused_packed_attention_paged(*args, page_size=page)
        again = fused_packed_attention_paged(*args, page_size=page)
        view = tc.gather_paged(paged, n_tok)
        k2 = fused_packed_attention(q, view.k, view.v, n, 0.1)
        torch.cuda.synchronize()
        assert fused_packed_attention_paged.launches == before + 2
        want = fused_packed_attention_paged_torch(*args, page_size=page)
        for g, a, d, w in zip(got, again, k2, want):
            assert torch.equal(g, a) and torch.equal(g, d)
            torch.testing.assert_close(g, w, **TOL)
        o, m, l = got
        assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("widths,counts,pack,G", [
    ((4,), (128,), 8, 1),
    ((4, 16), (96, 32), 16, 4),
])
def test_k2_bucket_view_equals_full_capacity(cuda, widths, counts, pack, G):
    """K2 over a 1024-token bucket view (``slice_compressed``) is bitwise
    equal to K2 over the 2048-token capacity when every row's count fits
    the bucket (the spans do not depend on L), and both are within
    tolerance of the plain version with the kernel's split structure."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    spec = tt.TierSpec(widths, counts, pack)
    cache = _random_cache(gen, 4, 4, 128, 2048, spec, (2048, 0, 1000, 700), cuda)
    q = torch.randn((4, 4 * G, 128), generator=gen, device=cuda)
    n = torch.clamp(cache.n_comp, max=1024)
    view = tc.slice_compressed(cache, 1024)
    sliced = fused_packed_attention(q, view.k, view.v, n, 0.1)
    full = fused_packed_attention(q, cache.k, cache.v, n, 0.1)
    torch.cuda.synchronize()
    want = fused_packed_attention_split_torch(q, cache.k, cache.v, n, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(sliced, full))
    (o, m, l), (wo, wm, wl) = sliced, want
    torch.testing.assert_close(m, wm, **TOL)
    torch.testing.assert_close(l, wl, **TOL)
    # o after dividing by l: the unnormalized sums over 2048 tokens reach
    # ~1e2, so f32 sums in another order differ by ~1e-4 on o itself
    norm = lambda o, l: o / torch.clamp(l, min=1e-30)[..., None]
    torch.testing.assert_close(norm(o, l), norm(wo, wl), **TOL)


@pytest.mark.gpu
def test_wide_spec_stages_v_after_the_scores(cuda):
    """A spec whose K and V tiers do not fit in shared memory side by side
    (D = 256, one width-16 tier: ~133 KB each) stages V into K's space
    after the scores: still within tolerance of the plain version, the
    empty row exact, two launches bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    spec = tt.TierSpec((16,), (256,), 16)
    cache = _random_cache(gen, 3, 2, 256, 512, spec, (512, 0, 200), cuda)
    q = torch.randn((3, 4, 256), generator=gen, device=cuda)
    got = fused_packed_attention(q, cache.k, cache.v, cache.n_comp, 0.05)
    again = fused_packed_attention(q, cache.k, cache.v, cache.n_comp, 0.05)
    torch.cuda.synchronize()
    want = fused_packed_attention_torch(q, cache.k, cache.v, cache.n_comp, 0.05)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, **TOL)
    o, m, l = got
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()


@pytest.mark.gpu
def test_smoke_engine_fused_equals_ref_on_cuda(cuda):
    """The serving path on the card: the fused kernel backend and the
    plain reference backend give the same greedy tokens on the smoke
    model, and every decode step launched the kernel once per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg = get_arch("llama2-7b", smoke=True)
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0), cfg)
    outs = {}
    for backend in ("fused", "ref"):
        eng = Engine(cfg, params, tc.PackKVConfig(),
                     EngineConfig(capacity=512, max_batch=2, backend=backend))
        server = SlotServer(eng)
        rng = np.random.default_rng(0)
        for i, n in enumerate((200, 130, 70)):
            server.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, n),
                                  max_new=100))
        fused_packed_attention.launches = 0
        outs[backend] = {r.rid: list(r.output) for r in server.run()}
        launches = fused_packed_attention.launches
        steps = server.stats.decode_steps
        assert launches == (cfg.n_layers * steps if backend == "fused" else 0)
    agree = np.mean([np.mean(np.equal(outs["fused"][i], outs["ref"][i]))
                     for i in outs["ref"]])
    assert agree > 0.5, outs  # float order differs; near-ties may flip


@pytest.mark.gpu
def test_smoke_engine_paged_serves_through_k5(cuda):
    """Paged, chunked serving on the card: every decode step launches K5
    once per layer and K2 never, and the tokens match dense serving but
    for near-ties."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg = get_arch("llama2-7b", smoke=True)
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0), cfg)
    outs = {}
    for paged in (False, True):
        eng = Engine(cfg, params, tc.PackKVConfig(),
                     EngineConfig(capacity=512, max_batch=2, paged=paged,
                                  page_size=256, pool_pages=3 if paged else None,
                                  debug_invariants=True))
        server = SlotServer(eng)
        rng = np.random.default_rng(0)
        for i, n in enumerate((300, 130, 70)):
            server.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, n),
                                  max_new=100))
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        outs[paged] = {r.rid: list(r.output) for r in server.run()}
        steps = server.stats.decode_steps
        want = (0, cfg.n_layers * steps) if paged else (cfg.n_layers * steps, 0)
        assert (fused_packed_attention.launches,
                fused_packed_attention_paged.launches) == want
    agree = np.mean([np.mean(np.equal(outs[True][i], outs[False][i]))
                     for i in outs[False]])
    assert agree > 0.5, outs


def _close_bound(got, want, mag, n: int):
    """|got - want| <= 2 (n + 2) 2^-24 mag: two f32 sums of n terms."""
    assert bool(((got - want).abs() <= 2 * (n + 2) * 2.0 ** -24 * mag + 1e-30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("widths,counts,pack,G", [
    ((4,), (128,), 8, 1),
    ((1, 2, 4, 8), (32, 32, 32, 32), 8, 1),
    ((4, 16), (96, 32), 16, 1),
    ((4,), (128,), 8, 4),
    ((2, 8), (64, 64), 16, 2),
    ((4,), (128,), 8, 3),  # G=3: the kernels' GM=4 instantiation
    ((16,), (256,), 8, 8),  # 8 channel groups: more than are in flight
    ((2, 4), (8, 56), 8, 3),  # D=64: a tier of 8 channels, one of 56 (two groups)
    ((4,), (64,), 8, 8),  # D=64 at G=8: two full 32-channel groups
])
def test_tier_matvec_kernels_match_plain_and_paged(cuda, widths, counts, pack, G):
    """K3 and K4 per tier over ragged rows (one empty): within the bound
    of their plain versions and bitwise equal over two launches, K3 and K4
    over bucket views of 512 and 128 tokens bitwise equal to K3 and K4
    over the capacity; K6 and K7 on the pages scattered
    under a shuffled table (pages 64, 128, 256 and 512) bitwise equal to
    K3 and K4 on the dense cache and to themselves, and within the bound
    of their own plain versions. The head dim is the spec's channels."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    spec = tt.TierSpec(widths, counts, pack)
    B, Hkv, L, D = 4, 4, 1024, sum(counts)
    cache = _random_cache(gen, B, Hkv, D, L, spec, (1024, 0, 300, 700), cuda)
    BH = B * Hkv
    nv = _rows_to_bh(cache.n_comp, B, Hkv, cuda)
    q = torch.randn((BH, G, D), generator=gen, device=cuda)
    w = torch.rand((BH, G, L), generator=gen, device=cuda)
    flat = lambda a: a.reshape(BH, *a.shape[2:])
    pools = {page: _to_pool(cache, page, gen) for page in (64, 128, 256, 512)}
    off = 0
    for i, (t, c) in enumerate(zip(cache.k.tiers, counts)):
        leaves = tuple(flat(x) for x in (t.payload, t.mins, t.shifts))
        qt = q[..., off:off + c]
        off += c
        kw = dict(width=t.width, pack_size=pack, n_valid=nv)
        before = (kpack_tier_scores.launches, vpack_tier_out.launches)
        s, s2 = (kpack_tier_scores(*leaves, qt, **kw) for _ in range(2))
        o, o2 = (vpack_tier_out(*leaves, w, **kw) for _ in range(2))
        torch.cuda.synchronize()
        assert (kpack_tier_scores.launches, vpack_tier_out.launches) == \
            (before[0] + 2, before[1] + 2)
        assert torch.equal(s, s2) and torch.equal(o, o2)
        ints = tt.unpack_tier(t, L).reshape(BH, c, L).to(torch.float32).abs()
        mag_s = torch.bmm(qt.abs(), ints)
        mag_o = torch.bmm(w.abs(), ints.transpose(1, 2))
        _close_bound(s, kpack_tier_scores_torch(*leaves, qt, **kw), mag_s, c)
        _close_bound(o, vpack_tier_out_torch(*leaves, w, **kw), mag_o, L)
        assert not s[Hkv:2 * Hkv].any() and not o[Hkv:2 * Hkv].any()  # empty row
        # K3 and K4 over a bucket view equal K3 and K4 over the capacity
        # with the counts cut to the bucket (512: tensor copies of strided
        # rows; 128: a run shorter than a span, by cp.async)
        for bucket in (512, 128):
            bt = tc.slice_compressed(cache, bucket).k.tiers[i]
            bleaves = tuple(flat(x) for x in (bt.payload, bt.mins, bt.shifts))
            bkw = dict(width=t.width, pack_size=pack, n_valid=torch.clamp(nv, max=bucket))
            sliced = vpack_tier_out(*bleaves, w[..., :bucket], **bkw)
            full = vpack_tier_out(*leaves, w, **bkw)
            s_sliced = kpack_tier_scores(*bleaves, qt, **bkw)
            s_full = kpack_tier_scores(*leaves, qt, **bkw)
            torch.cuda.synchronize()
            assert torch.equal(sliced, full), bucket
            assert torch.equal(s_sliced, s_full[..., :bucket]), bucket
            assert not s_full[..., bucket:].any(), bucket
        for page, paged in pools.items():
            pt = paged.k.tiers[i]
            pleaves = (pt.payload, pt.mins, pt.shifts)
            table = paged.pages.page_table
            pkw = dict(width=t.width, pack_size=pack, page_size=page)
            ps = kpack_tier_scores_paged(*pleaves, qt, table, nv, L, **pkw)
            po = vpack_tier_out_paged(*pleaves, w, table, nv, **pkw)
            ps2 = kpack_tier_scores_paged(*pleaves, qt, table, nv, L, **pkw)
            po2 = vpack_tier_out_paged(*pleaves, w, table, nv, **pkw)
            torch.cuda.synchronize()
            assert torch.equal(ps, s) and torch.equal(po, o), page
            assert torch.equal(ps, ps2) and torch.equal(po, po2), page
            _close_bound(ps, kpack_tier_scores_paged_torch(*pleaves, qt, table, nv, L, **pkw),
                         mag_s, c)
            _close_bound(po, vpack_tier_out_paged_torch(*pleaves, w, table, nv, **pkw),
                         mag_o, L)


def _every_shift_and_min(BH, C, L, width, pack, gen, device):
    """Tier leaves [BH, C, ·] whose packs run through every (2-bit shift,
    int8 min) pair in turn (pack i of the flattened rows takes pair i mod
    1024), with random payload words."""
    npk = L // pack
    i = torch.arange(BH * C * npk, device=device).reshape(BH, C, npk)
    mins = ((i // 4) % 256 - 128).to(torch.int8)
    sh = (i % 4).reshape(BH, C, npk // 4, 4)
    shifts = (sh << torch.arange(0, 8, 2, device=device)).sum(-1).to(torch.uint8)
    payload = torch.randint(-2 ** 31, 2 ** 31, (BH, C, L * width // 32), generator=gen,
                            device=device, dtype=torch.int64).to(torch.int32)
    return payload, mins, shifts


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [8, 16])
@pytest.mark.parametrize("width", [1, 2, 4, 8, 16])
def test_k1_decode_bitwise_every_width_shift_min(cuda, width, pack):
    """K1 (csrc/unpack.cuh::decode_tier_run, inlined in every kernel) as
    K3 and K4 run it, bitwise against the plain decode (unpack_tier), at
    every width and pack, every shift and every min. A one-hot operand
    makes a kernel's output the decoded integers themselves: every other
    product is 0 and adding 0 is exact in any order. K3 with q one-hot
    over channels reads every (channel, token) of the tier, C / G launches;
    K4 with w one-hot over tokens reads every channel of one token of each
    pack, at a position within the pack that moves with the row."""
    gen = torch.Generator(device=cuda).manual_seed(width * 100 + pack)
    BH, C, L, G = 4, 64, 512, 8
    leaves = _every_shift_and_min(BH, C, L, width, pack, gen, cuda)
    kw = dict(width=width, pack_size=pack)
    want = tt.unpack_tier(tt.TierBuffer(*leaves, width, pack), L).to(torch.float32)
    sh = (leaves[2].to(torch.int64)[..., None] >> torch.arange(0, 8, 2, device=cuda)) & 3
    assert len(set(zip(leaves[1].flatten().tolist(), sh.flatten().tolist()))) == 1024
    eye = torch.eye(C, device=cuda)
    for k in range(C // G):  # K3: channels kG .. kG + G - 1 of every row
        q = eye[k * G:(k + 1) * G].expand(BH, G, C).contiguous()
        s = kpack_tier_scores(*leaves, q, **kw)
        assert torch.equal(s, want[:, k * G:(k + 1) * G]), k
    npk = L // pack
    rows = torch.arange(BH, device=cuda)[:, None]
    for k in range(npk // G):  # K4: packs kG .. kG + G - 1, one token each
        tok = (k * G + torch.arange(G, device=cuda))[None, :] * pack + (rows + k) % pack
        w = torch.zeros((BH, G, L), device=cuda)
        w.scatter_(2, tok[..., None], 1.0)
        o = vpack_tier_out(*leaves, w, **kw)
        assert torch.equal(o, torch.gather(want, 2, tok[:, None, :].expand(BH, C, G))
                           .transpose(1, 2)), k


@pytest.mark.gpu
def test_tier_matvec_ops_fused_match_ref_on_cuda(cuda):
    """The four ops entry points on the card: the fused backend (K3, K4,
    K6, K7) within rtol 1e-5 / atol 1e-4 of the ref backend (its scores
    reach ~10 here), and the paged ones bitwise equal to the dense ones."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda).manual_seed(8)
    spec = tt.TierSpec((2, 4, 8), (32, 64, 32), 8)
    cache = _random_cache(gen, 3, 4, 128, 1024, spec, (1024, 0, 333), cuda)
    paged = _to_pool(cache, 256, gen)
    q = torch.randn((3, 8, 128), generator=gen, device=cuda)
    w = torch.softmax(torch.randn((3, 8, 1024), generator=gen, device=cuda), -1)
    nv = cache.n_comp
    got_s = ops.packed_qk_scores(q, cache.k, 0.1, n_valid=nv)
    got_o = ops.packed_weighted_v(w, cache.v, n_valid=nv)
    torch.testing.assert_close(got_s, ops.packed_qk_scores(q, cache.k, 0.1, n_valid=nv,
                                                           backend="ref"), **TOL)
    torch.testing.assert_close(got_o, ops.packed_weighted_v(w, cache.v, n_valid=nv,
                                                            backend="ref"), **TOL)
    assert torch.equal(ops.packed_qk_scores_paged(q, paged.k, paged.pages, 1024, 0.1,
                                                  n_valid=nv), got_s)
    assert torch.equal(ops.packed_weighted_v_paged(w, paged.v, paged.pages, n_valid=nv),
                       got_o)


# the decode shapes the other dense configs give K2/K5: smollm-135m (G=3,
# D=64), qwen3-32b (G=8, D=128), minicpm-2b (G=1, D=64); the specs are
# narrow tiers as calibration gives them at these head dims
NEW_SHAPES = [
    (3, 64, (2, 4), (8, 56)),
    (8, 128, (4,), (128,)),
    (1, 64, (1, 2, 4, 8), (8, 8, 16, 32)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("G,D,widths,counts", NEW_SHAPES)
def test_k2_k5_other_config_shapes(cuda, G, D, widths, counts):
    """K2 and K5 at the new group sizes and head dims over ragged rows (one
    empty): within tolerance of their plain versions, bitwise equal to
    themselves, K5 bitwise equal to K2 on the gathered view at pages 64 and
    256, and K2 over a 512-token bucket view equal to K2 over the capacity."""
    _k2_k5_shape_checks(cuda, G, 3, D, tt.TierSpec(widths, counts, 8),
                        seed=G * 1000 + D)


def _k2_k5_shape_checks(cuda, G, Hkv, D, spec, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    cache = _random_cache(gen, 4, Hkv, D, 1024, spec, (1024, 0, 300, 700), cuda)
    q = torch.randn((4, Hkv * G, D), generator=gen, device=cuda)
    n, sm = cache.n_comp, D ** -0.5
    got = fused_packed_attention(q, cache.k, cache.v, n, sm)
    again = fused_packed_attention(q, cache.k, cache.v, n, sm)
    torch.cuda.synchronize()
    want = fused_packed_attention_torch(q, cache.k, cache.v, n, sm)
    split = fused_packed_attention_split_torch(q, cache.k, cache.v, n, sm)
    for g, a, w, x in zip(got, again, want, split):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(g, x, **TOL)
    o, m, l = got
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()
    n_half = torch.clamp(n, max=512)
    view = tc.slice_compressed(cache, 512)
    sliced = fused_packed_attention(q, view.k, view.v, n_half, sm)
    full = fused_packed_attention(q, cache.k, cache.v, n_half, sm)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(sliced, full))
    for page in (64, 256):
        paged = _to_pool(cache, page, gen)
        args = (q, paged.k, paged.v, paged.pages.page_table, n, 1024, sm)
        k5 = fused_packed_attention_paged(*args, page_size=page)
        torch.cuda.synchronize()
        plain = fused_packed_attention_paged_torch(*args, page_size=page)
        for g, a, w in zip(k5, got, plain):
            assert torch.equal(g, a), page
            torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
def test_tier_matvec_ops_head_dim_64_on_cuda(cuda):
    """The four ops entry points at D=64 and G=3 (smollm-135m's decode
    shape) under a spec with an 8-channel tier: fused within rtol 1e-5 /
    atol 1e-4 of ref, paged bitwise equal to dense."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda).manual_seed(9)
    spec = tt.TierSpec((2, 4), (8, 56), 8)
    cache = _random_cache(gen, 3, 3, 64, 1024, spec, (1024, 0, 333), cuda)
    paged = _to_pool(cache, 256, gen)
    q = torch.randn((3, 9, 64), generator=gen, device=cuda)
    w = torch.softmax(torch.randn((3, 9, 1024), generator=gen, device=cuda), -1)
    nv = cache.n_comp
    got_s = ops.packed_qk_scores(q, cache.k, 0.125, n_valid=nv)
    got_o = ops.packed_weighted_v(w, cache.v, n_valid=nv)
    torch.testing.assert_close(got_s, ops.packed_qk_scores(q, cache.k, 0.125, n_valid=nv,
                                                           backend="ref"), **TOL)
    torch.testing.assert_close(got_o, ops.packed_weighted_v(w, cache.v, n_valid=nv,
                                                            backend="ref"), **TOL)
    assert torch.equal(ops.packed_qk_scores_paged(q, paged.k, paged.pages, 1024, 0.125,
                                                  n_valid=nv), got_s)
    assert torch.equal(ops.packed_weighted_v_paged(w, paged.v, paged.pages, n_valid=nv),
                       got_o)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["smollm-135m", "minicpm-2b", "minitron-4b", "qwen3-32b"])
def test_smoke_config_engine_fused_equals_ref_on_cuda(cuda, name):
    """Each other dense config's smoke engine on the card: K2 launched once
    per layer and decode step, and the fused backend's greedy tokens those
    of the plain reference backend but for near-ties."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg = get_arch(name, smoke=True)
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0), cfg)
    outs = {}
    for backend in ("fused", "ref"):
        eng = Engine(cfg, params, tc.PackKVConfig(),
                     EngineConfig(capacity=512, max_batch=2, backend=backend))
        server = SlotServer(eng)
        rng = np.random.default_rng(0)
        for i, n in enumerate((200, 130, 70)):
            server.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, n),
                                  max_new=60))
        fused_packed_attention.launches = 0
        outs[backend] = {r.rid: list(r.output) for r in server.run()}
        steps = server.stats.decode_steps
        assert fused_packed_attention.launches == (
            cfg.n_layers * steps if backend == "fused" else 0)
    agree = np.mean([np.mean(np.equal(outs["fused"][i], outs["ref"][i]))
                     for i in outs["ref"]])
    assert agree > 0.5, outs


@pytest.mark.gpu
def test_prefix_hit_bit_identical_to_cold_on_cuda(cuda):
    """The shared-prefix traffic of tests/test_torch_prefix.py on the card
    (K5 over pages held by reference): 3 lookups, 2 hits, 4 pages shared,
    K5 once per layer and decode step and K2 never, and every warm output
    bitwise equal to a cold run on a fresh server."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg = get_arch("llama2-7b", smoke=True)
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0), cfg)
    eng = Engine(cfg, params, tc.PackKVConfig(),
                 EngineConfig(capacity=512, max_batch=2, calib_tokens=128, decode_chunk=4,
                              bucket_unit=64, paged=True, page_size=128, prefix_cache=True,
                              debug_invariants=True))
    sys_prompt = np.random.default_rng(11).integers(0, 512, 300)

    def reqs():
        r = np.random.default_rng(5)
        return [Request(rid=i, max_new=m,
                        tokens=np.concatenate([sys_prompt, r.integers(0, 512, n)]))
                for i, (n, m) in enumerate(((40, 6), (60, 5), (25, 7)))]

    def serve(rs):
        srv = SlotServer(eng)
        for r in rs:
            srv.submit(r)
        srv.run()
        return srv

    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    warm = serve(reqs())
    s = warm.stats
    assert (s.prefix_lookups, s.prefix_hits, s.prefix_pages_shared) == (3, 2, 4)
    assert (fused_packed_attention.launches, fused_packed_attention_paged.launches) == \
        (0, cfg.n_layers * s.decode_steps)
    for r in reqs():
        np.testing.assert_array_equal(warm.done[r.rid].output,
                                      serve([r]).done[r.rid].output)


# ---------------------------------------------------------------------------
# speculative decode: the GEMMs' rows, verify == stepwise, spec == plain
# ---------------------------------------------------------------------------

# llama2-7b's decode products (K, N): wq / wk / wv / wo, w_gate / w_up,
# w_down, head
LLAMA2_GEMMS = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 5])
@pytest.mark.parametrize("K,N", LLAMA2_GEMMS)
def test_gemm_rows_at_llama2_widths(cuda, K, N, w):
    """bf16 X @ W at B = 4 batch rows. Printed (run with -s): whether row
    b of the verify pass's [B*w, K] product equals row b of a plain [B, K]
    product bitwise, case (a) of the design. Asserted, case (b), the one
    the port takes: at the [B*w, K] shape every row of the product depends
    only on its own input row, so a decode step padded to w rows
    (``decode_step(rows=w)``) gives each window position's row bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(K + N + w)
    B = 4
    W = (torch.randn(K, N, generator=gen, device=cuda) / K ** 0.5).to(torch.bfloat16)
    X = torch.randn(B, w, K, generator=gen, device=cuda).to(torch.bfloat16)
    full = X @ W
    rows_equal = torch.equal(full[:, 0], X[:, :1] @ W)
    print(f"GEMM rows K={K} N={N} B={B} w={w}: (a) [B*w] row == [B] row: {rows_equal}",
          flush=True)
    for j in range(w):
        padded = torch.nn.functional.pad(X[:, j:j + 1], (0, 0, 0, w - 1)) @ W
        assert torch.equal(padded[:, 0], full[:, j]), j


def _smoke_model(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model

    cfg = get_arch("llama2-7b", smoke=True)
    return cfg, get_model(cfg), get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 5])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_matches_stepwise_on_cuda(cuda, paged, w):
    """tests/test_torch_spec.py's verify == stepwise on the card: ragged
    rows (191 / 131 / 156 tokens, 33 warm steps, so row 0's seed append
    flushes), a window where row 0 accepts every draft, row 1 none and row
    2 one; hat and every live byte of the committed cache bitwise equal to
    decode_step(rows=w) fed the same tokens, through K2 (dense) or K5
    (paged), launched once per layer and window position."""
    import copy

    cfg, api, params = _smoke_model(cuda)
    B, CAP, R = 3, 256, 96
    pack = tc.PackKVConfig(residual=R, paged=paged, page_size=128)
    rng = np.random.default_rng(0)
    cache = api.alloc_cache(cfg, pack, B, CAP, cuda)
    last = torch.zeros((B, 1), dtype=torch.int32, device=cuda)
    for i, plen in enumerate((191, 131, 156)):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, plen)), device=cuda)
        lg, cache = api.prefill_into_slot(params, cfg, pack, CAP, cache, i, {"tokens": toks})
        last[i, 0] = lg[0].argmax()
    step = lambda c, t: api.decode_step(params, cfg, c, t, rows=w)
    for _ in range(33):
        lg, cache = step(cache, last)
        last = lg.argmax(-1).to(torch.int32)[:, None]
    assert int(cache[0].n_resid[0]) == R
    c, t, chain = copy.deepcopy(cache), last, []
    for _ in range(w):
        lg, c = step(c, t)
        t = lg.argmax(-1).to(torch.int32)[:, None]
        chain.append(t[:, 0])
    toks = torch.zeros((B, w), dtype=torch.int32, device=cuda)
    toks[:, 0] = last[:, 0]
    for j in range(w - 1):
        toks[0, 1 + j] = chain[j][0]
        toks[1, 1 + j] = (chain[j][1] + 1) % cfg.vocab
        toks[2, 1 + j] = chain[j][2] if j == 0 else (chain[j][2] + 1) % cfg.vocab
    lens = torch.tensor([w, 2, min(4, w) if w > 2 else 1], dtype=torch.int32, device=cuda)
    hat_ref, snaps, c = [], [], copy.deepcopy(cache)
    for j in range(w):
        lg, c = step(c, toks[:, j:j + 1])
        hat_ref.append(lg.argmax(-1).to(torch.int32))
        snaps.append(copy.deepcopy(c))
    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    hat, n_accept, got = api.decode_verify(params, cfg, cache, toks, lens,
                                           torch.ones(B, dtype=torch.bool, device=cuda))
    launched = fused_packed_attention_paged.launches if paged else fused_packed_attention.launches
    assert launched == cfg.n_layers * w
    assert n_accept.tolist() == [w - 1, 0, 1 if w > 2 else 0]
    hat_ref = torch.stack(hat_ref, 1)
    for i in range(B):
        n = int(lens[i])
        assert torch.equal(hat[i, :n], hat_ref[i, :n]), i
        want = snaps[int(n_accept[i])]
        for g, s in zip(got, want):
            assert int(g.n_comp[i]) == int(s.n_comp[i])
            assert int(g.n_resid[i]) == int(s.n_resid[i])
            r = int(g.n_resid[i])
            assert torch.equal(g.resid_k[i, :, :r], s.resid_k[i, :, :r])
            assert torch.equal(g.resid_v[i, :, :r], s.resid_v[i, :, :r])
            for tg, ts in zip((g.k, g.v), (s.k, s.v)):
                for a, b in ((tg.scale, ts.scale), (tg.zero, ts.zero),
                             (tg.chan_perm, ts.chan_perm)):
                    assert torch.equal(a, b) if paged else torch.equal(a[i], b[i])
                for ta, tb in zip(tg.tiers, ts.tiers):
                    for a, b in ((ta.payload, tb.payload), (ta.mins, tb.mins),
                                 (ta.shifts, tb.shifts)):
                        assert torch.equal(a, b) if paged else torch.equal(a[i], b[i])
            if paged:
                for key in ("page_table", "free", "n_free", "ref"):
                    assert torch.equal(getattr(g.pages, key), getattr(s.pages, key)), key


class _Replay:
    """Proposes a plain run's outputs with every third proposal wrong."""

    def __init__(self, outputs: dict, vocab: int):
        self.outputs, self.vocab, self.pos = outputs, vocab, {}

    def seed(self, slot, tokens):
        self.pos[slot] = [self.outputs[tuple(int(t) for t in tokens)[:-1]], 1]

    def extend(self, slot, tokens):
        self.pos[slot][1] += len(tuple(tokens))

    def drop(self, slot):
        self.pos.pop(slot, None)

    def draft(self, slot, k):
        stream, cur = self.pos[slot]
        return [(int(t) + 1) % self.vocab if (cur + j) % 3 == 0 else int(t)
                for j, t in enumerate(stream[cur:cur + k])]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_spec_serving_equals_plain_on_cuda(cuda, paged):
    """Speculative serving at the smoke config on the card, the replay
    drafter: every request's tokens bitwise equal to a plain server's, K2
    (dense) or K5 (paged) launched n_layers x (plain steps + w x verify
    passes) times and the other kernel never."""
    import dataclasses

    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg, _, params = _smoke_model(cuda)
    ecfg = EngineConfig(capacity=512, max_batch=2, calib_tokens=128, decode_chunk=4,
                        bucket_unit=64, paged=paged, page_size=128, spec_k=3,
                        spec_backoff=0, debug_invariants=paged)
    plain = Engine(cfg, params, tc.PackKVConfig(), ecfg)
    spec = Engine(cfg, params, plain.pack_cfg,
                  dataclasses.replace(ecfg, calibrate=False, spec_decode=True))
    r = np.random.default_rng(5)
    prompts = [r.integers(0, cfg.vocab, n) for n in (198, 168, 228)]

    def serve(eng, **kw):
        srv = SlotServer(eng, **kw)
        for i, (p, m) in enumerate(zip(prompts, (10, 8, 12))):
            srv.submit(Request(rid=i, tokens=p, max_new=m))
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        srv.run()
        return srv, fused_packed_attention.launches, fused_packed_attention_paged.launches

    a, _, _ = serve(plain)
    outs = {tuple(int(t) for t in p): a.done[i].output for i, p in enumerate(prompts)}
    b, k2, k5 = serve(spec, drafter=_Replay(outs, cfg.vocab))
    s = b.stats
    assert s.spec_launches > 0 and 0 < s.spec_accepted < s.spec_drafted
    want = cfg.n_layers * (s.decode_steps - s.spec_launches + 4 * s.spec_launches)
    assert (k5, k2) == (want, 0) if paged else (k2, k5) == (want, 0)
    for i in a.done:
        np.testing.assert_array_equal(a.done[i].output, b.done[i].output)


# ---------------------------------------------------------------------------
# preemption and sessions on the card
# ---------------------------------------------------------------------------


def _leaves_equal(a, b) -> bool:
    from repro_torch.utils import tree_flatten

    xs, ys = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.cpu().view(torch.uint8), y.cpu().view(torch.uint8))
        for x, y in zip(xs, ys))


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_evacuate_restore_bitwise_on_cuda(cuda, paged):
    """Row 1 (1000 tokens) evacuated to host memory, another prompt
    admitted into its slot (paged: onto the pages it freed), the row
    restored into slot 2 (paged: other physical pages): K2 (dense) or K5
    (paged) gives the row's partials bitwise as before the evacuation, and
    evacuating it again gives the same mini bitwise."""
    from repro_torch.utils import to_device, to_host

    gen = torch.Generator(device=cuda).manual_seed(11)
    spec = tt.TierSpec((2, 4, 8), (32, 64, 32), 8)
    cfg = tc.PackKVConfig(k_spec_static=spec, v_spec_static=spec, paged=paged, page_size=256)
    cache = tc.alloc_layer_cache(cfg, 3, 4, 128, 1024, device=cuda)
    kv = lambda n: torch.randn((4, n, 128), generator=gen, device=cuda).to(torch.bfloat16)
    for r, n in enumerate((700, 1000, 300)):
        tc.insert_prefill(cache, r, kv(n), kv(n))
    q = torch.randn((3, 4, 128), generator=gen, device=cuda)

    def attend():
        if paged:
            return fused_packed_attention_paged(q, cache.k, cache.v, cache.pages.page_table,
                                                cache.n_comp, 1024, 0.1, page_size=256)
        return fused_packed_attention(q, cache.k, cache.v, cache.n_comp, 0.1)

    before = [x.clone() for x in attend()]
    q[2] = q[1]
    n_pages = 4 if paged else 0
    old_pages = cache.pages.page_table[1, :4].tolist() if paged else None
    _, mini = tc.evacuate_row(cache, 1, n_pages)
    host = to_host(mini)
    tc.evacuate_row(cache, 2, 2 if paged else 0)
    tc.insert_prefill(cache, 1, kv(900), kv(900))
    tc.restore_row(cache, 2, to_device(host, cuda), None, n_pages)
    after = attend()
    torch.cuda.synchronize()
    for b, a in zip(before, after):
        assert torch.equal(b[1], a[2])
    if paged:
        assert cache.pages.page_table[2, :4].tolist() != old_pages
    _, again = tc.evacuate_row(cache, 2, n_pages)
    assert _leaves_equal(again, host)


@pytest.mark.gpu
def test_save_load_mini_of_a_card_mini(cuda, tmp_path):
    """A card mini (every leaf kind, bf16 residuals) saved and loaded
    back through the session store's disk serializers is bitwise equal."""
    from repro_torch.checkpoint import load_mini, save_mini
    from repro_torch.utils import tree_flatten

    gen = torch.Generator(device=cuda).manual_seed(12)
    spec = tt.TierSpec((2, 4, 8), (32, 64, 32), 8)
    cfg = tc.PackKVConfig(k_spec_static=spec, v_spec_static=spec, paged=True, page_size=256)
    cache = tc.alloc_layer_cache(cfg, 2, 4, 128, 1024, device=cuda)
    kv = torch.randn((4, 600, 128), generator=gen, device=cuda).to(torch.bfloat16)
    tc.insert_prefill(cache, 0, kv, kv)
    _, mini = tc.evacuate_row([cache], 0, 3)
    path = save_mini(str(tmp_path / "m"), mini)
    back, _ = load_mini(path, tree_flatten(mini)[1])
    assert _leaves_equal(back, mini)


@pytest.mark.gpu
def test_decode_chunk_one_step_equals_decode_at_llama2_width(cuda):
    """A teacher-forced ingestion step is a one-step decode_chunk; it must
    run the ops of a plain decode: at llama2-7b's width (2 of its 32
    layers), the token and every cache byte bitwise equal."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=2)
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(3), cfg)
    eng = Engine(cfg, params, tc.PackKVConfig(),
                 EngineConfig(capacity=2048, max_batch=4, decode_chunk=8, prefill_chunk_pages=0))
    cache = eng.alloc_slot_cache()
    rng = np.random.default_rng(2)
    toks = np.zeros((4, 1), np.int32)
    for i, n in enumerate((700, 1000, 260)):
        lg, cache = eng.insert_request(cache, i, rng.integers(0, cfg.vocab, n))
        toks[i, 0] = int(torch.argmax(lg))
    active = [True, True, True, False]
    n_bucket = eng.bucket_for(1001)
    a = tree_map(torch.clone, cache)
    lg, a = eng.decode(a, toks, n_bucket)
    a = eng.mask_free(a, active)
    got, n_exec, b = eng.decode_chunk(cache, toks, active, 1, None, n_bucket)
    assert n_exec == 1
    np.testing.assert_array_equal(got[0, :3], torch.argmax(lg, -1).cpu().numpy()[:3])
    assert _leaves_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_preempt_and_session_equal_controls_on_cuda(cuda, paged):
    """The smoke config on the card: a class-0 arrival swaps a class-1 row
    out and every request equals the preempt-off control; a two-turn
    conversation's session hit equals the hand-driven chain on a
    session-off engine (the same max_batch and spec_k); K2 (dense) or K5
    (paged) launched once a layer and decode step and the other kernel
    never."""
    import dataclasses

    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg, _, params = _smoke_model(cuda)
    ecfg = EngineConfig(capacity=512, max_batch=2, calib_tokens=128, decode_chunk=4,
                        bucket_unit=64, paged=paged, page_size=128, debug_invariants=paged)
    base = Engine(cfg, params, tc.PackKVConfig(), ecfg)
    pre = Engine(cfg, params, base.pack_cfg, dataclasses.replace(
        ecfg, calibrate=False, preempt=True, session_cache=True))
    r = np.random.default_rng(11)
    sys_p = r.integers(0, cfg.vocab, 256)
    reqs = lambda: [Request(rid=i, max_new=40, priority=1, tokens=np.concatenate(
        [sys_p, np.random.default_rng(i).integers(0, cfg.vocab, 40 + 13 * i)]))
        for i in range(2)] + [Request(rid=2, max_new=6, tokens=np.arange(100) % cfg.vocab)]

    def launches(srv, drive=None):
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        steps0 = srv.stats.decode_steps
        (drive or srv.run)()
        k2, k5 = fused_packed_attention.launches, fused_packed_attention_paged.launches
        want = cfg.n_layers * (srv.stats.decode_steps - steps0)
        assert (k5, k2) == (want, 0) if paged else (k2, k5) == (want, 0)

    srv = SlotServer(pre)
    low_a, low_b, hi = reqs()

    def arrive_late():
        srv.submit(low_a)
        srv.submit(low_b)
        for _ in range(8):
            srv.step()
        srv.submit(hi)
        srv.run()

    launches(srv, arrive_late)
    assert srv.stats.preemptions >= 1 and srv.stats.session_parks == 3
    ctl = SlotServer(base)
    for q in reqs():
        ctl.submit(q)
    launches(ctl)
    for rid in ctl.done:
        np.testing.assert_array_equal(srv.done[rid].output, ctl.done[rid].output)
    # a conversation of two turns against the uninterrupted chain
    prompt, ext = r.integers(0, cfg.vocab, 300), r.integers(0, cfg.vocab, 5)
    srv.submit(Request(rid=3, max_new=8, tokens=prompt))
    launches(srv)
    out1 = list(srv.done[3].output)
    chunks = srv.stats.prefill_chunks
    srv.submit(Request(rid=4, max_new=8, tokens=np.concatenate([prompt, out1, ext])))
    launches(srv)
    assert srv.stats.session_hits == 1 and srv.stats.prefill_chunks == chunks
    assert [out1, list(srv.done[4].output)] == _chain(base, prompt, [(None, 8), (ext, 8)])


def _chain(eng, prompt, turns):
    """A conversation driven by hand on a session-off engine, row 0 live:
    admitted as the server admits it (page-sized chunks, the last one
    fused with the insert), then each turn's extension teacher-forced by
    single decode steps. Returns one output list a turn."""
    n = eng.ecfg.max_batch
    active = [True] + [False] * (n - 1)
    cache = eng.alloc_slot_cache()
    S, c = len(prompt), eng.chunk_tokens()
    if S <= c:
        logits, cache = eng.insert_request(cache, 0, prompt)
    else:
        bounds = sorted(set(range(0, S, c)) | {S})
        scratch = eng.chunk_init(S)
        for s0, s1 in zip(bounds[:-2], bounds[1:-1]):
            _, scratch = eng.chunk_step(scratch, prompt[s0:s1], s0)
        logits, cache = eng.chunk_final(cache, 0, scratch, prompt[bounds[-2]:], bounds[-2])

    def step(tok):
        toks = np.zeros((n, 1), np.int32)
        toks[0, 0] = tok
        lg, c_ = eng.decode(cache, toks)
        return int(torch.argmax(lg[0])), eng.mask_free(c_, active)

    t, outs = int(torch.argmax(logits)), []
    for ext, max_new in turns:
        if ext is not None:
            for f in [outs[-1][-1]] + [int(x) for x in ext[:-1]]:
                _, cache = step(f)
            t, cache = step(int(ext[-1]))
        out = [t]
        for _ in range(max_new - 1):
            t, cache = step(t)
            out.append(t)
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# the storage tier (quantizers, repacking, bit-packing, the block stream):
# the card's tensor ops against the same functions on the CPU, bitwise
# ---------------------------------------------------------------------------

STORAGE_PROFILE = dict(channel_scale=2.0, smooth=0.88, noise=0.20, outlier_frac=0.05,
                       spike_frac=0.10, spike_mag=4.0)


def _storage_blocks(seed: int, n_blocks: int, d: int):
    """K- and V-like float32 blocks [n_blocks, 64, d] (synthetic_kv)."""
    from repro_torch.data import synthetic_kv

    rng = np.random.default_rng(seed)
    k = synthetic_kv(rng, 1, n_blocks, 64, d, **STORAGE_PROFILE)[0]
    v = synthetic_kv(rng, 1, n_blocks, 64, d, n_patterns=4, pattern_scale=1.2,
                     **dict(STORAGE_PROFILE, outlier_frac=0.025))[0]
    return torch.from_numpy(k), torch.from_numpy(v)


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [4, 8, 16])
@pytest.mark.parametrize("d", [128, 256])
def test_greedy_repack_device_equals_cpu(cuda, d, pack):
    """The batched greedy repack on the card equals the CPU path bitwise
    on 512 blocks (128 each at rel 0.1, 0.2, 0.5 and 1.0, where seeds tie
    exactly): D 128 repacks K alone, D 256 the joint [K|V]."""
    from repro_torch.core.block_format import quant_tokenwise
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.core.repacking import greedy_repack

    k, v = _storage_blocks(d + pack, 128, 128)
    qs = []
    for rel in (0.1, 0.2, 0.5, 1.0):
        qk = quant_tokenwise(k, QuantConfig(rel_scale=rel))[0]
        qv = quant_tokenwise(v, QuantConfig(rel_scale=rel))[0]
        qs.append(qk if d == 128 else torch.cat([qk, qv], dim=-1))
    q = torch.cat(qs)
    got = greedy_repack(q.to(cuda), pack)
    want = greedy_repack(q, pack)
    assert got.shape == (512, 64) and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [4, 8, 16])
def test_pack_unpack_device_equals_cpu(cuda, pack):
    """Bit-packing on the card: words, widths, minima and payload bits
    equal the CPU path's bitwise at every width 0-16 (a constant block
    among them), and the round trip is exact."""
    from repro_torch.core.bitpack import pack_block, unpack_block

    gen = torch.Generator().manual_seed(pack)
    q = torch.stack([torch.randint(-3, (1 << w) - 3, (64, 128), generator=gen)
                     for w in range(17)]).reshape(17, 1, 64, 128)
    got, want = pack_block(q.to(cuda), pack), pack_block(q, pack)
    for f in ("payload", "n_words", "widths", "mins", "payload_bits"):
        assert torch.equal(_raw(getattr(got, f)), _raw(getattr(want, f))), f
    assert torch.equal(unpack_block(got).cpu(), q)
    one = pack_block(q[3, 0].to(cuda), pack)
    assert torch.equal(one.payload.cpu(), pack_block(q[3, 0], pack).payload)
    assert torch.equal(unpack_block(one).cpu(), q[3, 0])


@pytest.mark.gpu
def test_quantizers_device_equal_cpu(cuda):
    """The token- and channel-wise quantizers, their dequantizers, the
    stream's float32 quantizer and KIVI's on the card equal the CPU's
    bitwise (a constant unit included)."""
    from repro_torch.core import kivi
    from repro_torch.core import quantization as tq
    from repro_torch.core.block_format import quant_tokenwise

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 128, 64), generator=gen) * (
        0.1 + 10 * torch.rand((1, 3, 1, 64), generator=gen))
    x[0, 0, :64] = 1.5
    for cfg in (tq.QuantConfig(rel_scale=0.1), tq.QuantConfig(bits=2),
                tq.QuantConfig(rel_scale=0.2, granularity="channel", group_size=32),
                tq.QuantConfig(bits=3, granularity="channel")):
        got, want = tq.quantize(x.to(cuda), cfg), tq.quantize(x, cfg)
        for g, w in zip(got, want):
            assert torch.equal(_raw(g), _raw(w)), cfg
        assert torch.equal(_raw(tq.dequantize(*got, cfg)), _raw(tq.dequantize(*want, cfg)))
        if cfg.granularity == "token":
            for g, w in zip(quant_tokenwise(x.to(cuda), cfg), quant_tokenwise(x, cfg)):
                assert torch.equal(_raw(g), _raw(w)), cfg
    kc = kivi.KIVIConfig(k_bits=3, v_bits=2)
    for fn in (kivi.compress_k, kivi.compress_v):
        for g, w in zip(fn(x.to(cuda), kc), fn(x, kc)):
            assert torch.equal(_raw(g), _raw(w))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["greedy_joint", "median_v", "none"])
def test_stream_extend_device_equals_cpu(cuda, mode):
    """A stream of 4 heads x 4 blocks filled by ``extend`` on the card
    equals the CPU's entry by entry, with its decode (float64, no fused
    multiply-add) and its serialization, bitwise."""
    from repro_torch.core.block_format import CompressedKVStream

    k, v = _storage_blocks(2, 16, 128)
    k, v = k.reshape(4, 256, 128), v.reshape(4, 256, 128)
    dev, cpu = CompressedKVStream(repack_mode=mode), CompressedKVStream(repack_mode=mode)
    dev.extend(k.to(cuda), v.to(cuda))
    cpu.extend(k, v)
    assert len(dev.entries) == len(cpu.entries) == 16
    for i, (d, c) in enumerate(zip(dev.entries, cpu.entries)):
        assert (d.head, d.token_start) == (c.head, c.token_start)
        for f in ("perm", "k_meta", "v_meta"):
            assert torch.equal(_raw(getattr(d, f)), _raw(getattr(c, f))), f
        for blk in ("k_block", "v_block"):
            for f in ("payload", "widths", "mins"):
                assert torch.equal(_raw(getattr(getattr(d, blk), f)),
                                   _raw(getattr(getattr(c, blk), f))), (blk, f)
        for g, w in zip(dev.decode_block(i, True), cpu.decode_block(i, True)):
            assert torch.equal(_raw(g), _raw(w))
    (df, dd), (cf, cd) = dev.serialize(), cpu.serialize()
    assert dd == cd and torch.equal(df.cpu(), cf)
    assert dev.total_bits() == cpu.total_bits()


# ---------------------------------------------------------------------------
# the MoE family, the VLM: K2/K5 at their decode shapes, routing, paged
# ---------------------------------------------------------------------------


def _full_width_engine(name, n_layers, cuda, **ekw):
    """An engine of ``name`` at full width, cut to ``n_layers`` layers
    (random weights, calibrated)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig

    cfg = dataclasses.replace(get_arch(name), n_layers=n_layers)
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(1), cfg)
    return cfg, Engine(cfg, params, tc.PackKVConfig(),
                       EngineConfig(capacity=2048, max_batch=4, **ekw))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "internvl2-2b"])
def test_k2_k5_moe_and_vlm_shapes(cuda, name):
    """K2 and K5 at qwen2-moe-a2.7b's decode shape (B=4, H_kv=16, G=1,
    D=128) and internvl2-2b's (H_kv=8, G=2) under the config's calibrated
    spec (two layers at full width): the checks of the other configs'
    shapes."""
    cfg, eng = _full_width_engine(name, 2, cuda)
    spec = eng.pack_cfg.k_spec_static
    G = cfg.n_heads // cfg.n_kv_heads
    assert (cfg.n_kv_heads, G, cfg.hd) in ((16, 1, 128), (8, 2, 128))
    _k2_k5_shape_checks(cuda, G, cfg.n_kv_heads, cfg.hd, spec, seed=cfg.n_kv_heads)
    vspec = eng.pack_cfg.v_spec_static
    if vspec != spec:
        _k2_k5_shape_checks(cuda, G, cfg.n_kv_heads, cfg.hd, vspec, seed=G)


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k", [(4, 60, 4), (20, 60, 4), (256, 60, 4), (20, 64, 6)])
def test_moe_routing_on_card_equals_cpu(cuda, T, E, k):
    """``moe.route`` on the card and on the CPU from the same f32 logits:
    top-k indices, positions, keep mask and slots equal; the logits are
    skewed so the capacity binds, and rows of exact ties go to the lower
    expert index on both."""
    from repro_torch.models import moe

    gen = torch.Generator(device=cuda).manual_seed(T + E)
    logits = torch.randn((T, E), generator=gen, device=cuda)
    logits += torch.linspace(8.0, 0.0, E, device=cuda)
    logits[::3] = torch.round(logits[::3] * 2) / 2  # exact ties in every third row
    logits[1] = 0.0
    card, cpu = moe.route(logits, E, k), moe.route(logits.cpu(), E, k)
    assert card.C == cpu.C == moe.capacity(T, E, k)
    for f in ("idx", "pos", "keep", "slot"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert card.idx[1].tolist() == list(range(k))  # all tied: the lowest experts
    if T >= 20:
        assert not bool(card.keep.all())  # the capacity binds


@pytest.mark.gpu
def test_moe_paged_equals_dense_full_width(cuda):
    """qwen2-moe-a2.7b at full width, two layers: chunked admission through
    paged storage (pages of 256, K5) gives every request's tokens bitwise
    equal to dense storage (K2), each kernel launched once a layer and
    decode step."""
    import dataclasses

    from repro_torch.serving import Engine, Request, SlotServer

    cfg, dense = _full_width_engine("qwen2-moe-a2.7b", 2, cuda, prefill_chunk_pages=1)
    paged = Engine(cfg, dense.params, dense.pack_cfg, dataclasses.replace(
        dense.ecfg, calibrate=False, paged=True, page_size=256))
    outs = []
    for eng, kernel in ((dense, fused_packed_attention), (paged, fused_packed_attention_paged)):
        server = SlotServer(eng)
        rng = np.random.default_rng(2)
        for i, n in enumerate((300, 700, 520, 260, 900)):
            server.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, n), max_new=24))
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        outs.append({r.rid: list(r.output) for r in server.run()})
        assert kernel.launches == cfg.n_layers * server.stats.decode_steps > 0
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the recurrent families: K2 at recurrentgemma-9b's shape, the ring, slots
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("widths,counts", [((4,), (256,)), ((2, 4, 8), (64, 128, 64))])
def test_k2_k5_recurrentgemma_shape(cuda, widths, counts):
    """K2 and K5 at recurrentgemma-9b's local-attention decode shape (B=4,
    H_kv=1, G=16, D=256, a 2048-token window): rows empty, full, partial
    and counted past the window (the kernel reads at most the window),
    within tolerance of the plain versions, bitwise equal to themselves,
    K5 on pages of 256 bitwise equal to K2."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    spec = tt.TierSpec(widths, counts, 8)
    L = 2048
    cache = _random_cache(gen, 4, 1, 256, L, spec, (0, L, 700, L), cuda)
    q = torch.randn((4, 16, 256), generator=gen, device=cuda)
    sm = 256 ** -0.5
    past = cache.n_comp.clone()
    past[3] = L + 320
    runs = []
    for n in (cache.n_comp, past):
        got = fused_packed_attention(q, cache.k, cache.v, n, sm)
        runs.append(got)
        again = fused_packed_attention(q, cache.k, cache.v, n, sm)
        paged = _to_pool(cache, 256, gen)
        k5 = fused_packed_attention_paged(q, paged.k, paged.v, paged.pages.page_table, n,
                                          L, sm, page_size=256)
        torch.cuda.synchronize()
        want = fused_packed_attention_torch(q, cache.k, cache.v, n, sm)
        for g, a, p, w in zip(got, again, k5, want):
            assert torch.equal(g, a) and torch.equal(g, p)
            torch.testing.assert_close(g, w, **TOL)
        o, m, l = got
        assert (o[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()
    # a count past the window reads the window, as the clamped count does
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    with pytest.raises(ValueError, match="group sizes"):
        fused_packed_attention(torch.randn((4, 17, 256), device=cuda), cache.k, cache.v,
                               cache.n_comp, sm)


@pytest.mark.gpu
def test_k2_two_streams_at_once(cuda):
    """Two K2 launches on two streams at once, repeatedly: each equals the
    same launch alone (the arrival counters are keyed by stream)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    spec = tt.TierSpec((4,), (128,), 8)
    caches = [_random_cache(gen, 4, 8, 128, 2048, spec, (2048, 1500, 2048, 900), cuda)
              for _ in range(2)]
    qs = [torch.randn((4, 32, 128), generator=gen, device=cuda) for _ in range(2)]
    alone = [fused_packed_attention(q, c.k, c.v, c.n_comp, 0.1) for q, c in zip(qs, caches)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                outs[i].append(fused_packed_attention(qs[i], caches[i].k, caches[i].v,
                                                      caches[i].n_comp, 0.1))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            assert all(torch.equal(g, a) for g, a in zip(got, alone[i]))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_ring_append_on_card_equals_cpu(cuda, policy):
    """append_token(ring=True) on the card, past the window twice: every
    leaf byte-equal to the CPU plain path on the same inputs."""
    from repro_torch.utils import tree_flatten

    B, H, D, W, R = 3, 2, 128, 256, 128
    spec = tt.TierSpec((2, 4, 8), (32, 64, 32), 8)
    cfg = tc.PackKVConfig(policy=policy, residual=R, k_spec_static=spec, v_spec_static=spec)
    caches = [tc.alloc_layer_cache(cfg, B, H, D, W, device=d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(9)
    bf = lambda a, d: torch.from_numpy(a).to(d).to(torch.bfloat16)
    for row, n in enumerate((256, 100, 0)):
        if n:
            k, v = rng.normal(size=(H, n, D)), rng.normal(size=(H, n, D))
            for c in caches:
                d = c.n_comp.device
                tc.insert_prefill(c, row, bf(k, d), bf(v, d))
    for _ in range(400):
        s = rng.normal(size=(B, H, 1, D))
        for c in caches:
            d = c.n_comp.device
            tc.append_token(c, bf(s, d), -bf(s, d), ring=True)
    # five flushes a row: rows 0 and 1 wrap their rings, row 2 fills its
    assert caches[1].n_comp.tolist() == [W + 320, W + 128, 320]
    for a, b in zip(tree_flatten(caches[0])[0], tree_flatten(caches[1])[0]):
        assert torch.equal(a.cpu(), b)


def _solo(eng, prompt, max_new):
    """A request run alone at the server's height: admitted as SlotServer
    admits it, in row 0 of a ``max_batch``-row table, the other rows free,
    a decode step at a time."""
    n = eng.ecfg.max_batch
    active = [True] + [False] * (n - 1)
    cache = eng.alloc_slot_cache()
    S, c = len(prompt), eng.chunk_tokens()
    if eng.ecfg.prefill_chunk_pages == 0 or S <= c:
        logits, cache = eng.insert_request(cache, 0, prompt)
    else:
        bounds = sorted(set(range(0, S, c)) | {S})
        scratch = eng.chunk_init(S)
        for s0, s1 in zip(bounds[:-2], bounds[1:-1]):
            _, scratch = eng.chunk_step(scratch, prompt[s0:s1], s0)
        logits, cache = eng.chunk_final(cache, 0, scratch, prompt[bounds[-2]:], bounds[-2])
    out = [int(torch.argmax(logits))]
    toks = np.zeros((n, 1), np.int32)
    while len(out) < max_new:
        toks[0, 0] = out[-1]
        lg, cache = eng.decode(cache, toks)
        cache = eng.mask_free(cache, active)
        out.append(int(torch.argmax(lg[0])))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_layers", [("recurrentgemma-9b", 5), ("rwkv6-1.6b", 2)])
def test_recurrent_slots_equal_solo_full_width(cuda, name, n_layers):
    """rwkv6-1.6b and recurrentgemma-9b at full width (depth cut): every
    SlotServer request bitwise equal to its solo control at the server's
    height, chunked admission bitwise equal to monolithic; rglru launches
    K2 once an attention layer and decode step, and a 2048-token prompt
    wraps its rings."""
    import dataclasses

    from repro_torch.serving import Engine, Request, SlotServer

    cfg, eng = _full_width_engine(name, n_layers, cuda, prefill_chunk_pages=1)
    mono = Engine(cfg, eng.params, eng.pack_cfg,
                  dataclasses.replace(eng.ecfg, calibrate=False, prefill_chunk_pages=0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (2048, 300, 700, 517)]
    news = (200 if cfg.window else 40, 24, 30, 16)
    outs = []
    for e in (eng, mono):
        server = SlotServer(e)
        for i, (p, m) in enumerate(zip(prompts, news)):
            server.submit(Request(rid=i, tokens=p, max_new=m))
        fused_packed_attention.launches = 0
        outs.append({r.rid: list(r.output) for r in server.run()})
        want_k2 = cfg.n_layers // 3 * server.stats.decode_steps if cfg.window else 0
        assert fused_packed_attention.launches == want_k2
    assert outs[0] == outs[1]
    for i, (p, m) in enumerate(zip(prompts, news)):
        assert _solo(eng, p, m) == outs[0][i], i
    # the 2048-token admission: logits and state row, chunked == monolithic
    p = prompts[0]
    scratch = eng.chunk_init(len(p))
    for s0 in range(0, len(p) - 256, 256):
        _, scratch = eng.chunk_step(scratch, p[s0:s0 + 256], s0)
    l_chunk, chunked = eng.chunk_final(eng.alloc_slot_cache(), 0, scratch, p[-256:],
                                       len(p) - 256)
    l_mono, whole = mono.insert_request(mono.alloc_slot_cache(), 0, p)
    assert torch.equal(l_chunk, l_mono) and _leaves_equal(chunked, whole)


# ---------------------------------------------------------------------------
# training (no kernel of csrc/: the card against the port's own CPU path)
# ---------------------------------------------------------------------------


def _train_batch(cfg, gen, B=2, S=128) -> dict:
    """CPU inputs of a train step by input mode (labels on the text)."""
    batch = {}
    n = S - cfg.n_patches if cfg.input_mode == "tokens_patches" else S
    if cfg.input_mode == "frames":
        batch["frames"] = torch.randn((B, S, cfg.d_model), generator=gen)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab, (B, n), generator=gen,
                                        dtype=torch.int32)
    if cfg.input_mode == "tokens_patches":
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen)
    batch["labels"] = torch.randint(0, cfg.vocab, (B, n), generator=gen, dtype=torch.int32)
    return batch


def _leaves(tree):
    from repro_torch.utils import tree_flatten

    return tree_flatten(tree)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama2-7b", "qwen2-moe-a2.7b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "internvl2-2b", "hubert-xlarge"])
def test_train_step_on_card_equals_cpu(cuda, name):
    """One make_train_step of each family's smoke model on the card against
    the same step on the CPU (the plain path), from the same parameters:
    bf16 products sum in another order, so the loss within 1e-2, the grad
    norm within 2e-2 and every parameter within 5e-3 (Adam's first step
    moves a parameter by ~lr whatever its gradient's size, so a near-zero
    gradient of another sign moves it 2 lr the other way); the step
    counter equal."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_training, make_train_step
    from repro_torch.utils import to_device, tree_map

    cfg = SMOKES[name]
    api = get_model(cfg)
    params, opt = init_training(api, cfg, torch.Generator().manual_seed(0))
    batch = _train_batch(cfg, torch.Generator().manual_seed(1))
    step = make_train_step(api, cfg, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    host = tree_map(torch.clone, (params, opt))  # the steps update in place
    dp, _, dm = step(to_device(params, cuda), to_device(opt, cuda), to_device(batch, cuda))
    hp, _, hm = step(*host, batch)
    print(f"{name}: loss {float(dm['loss'])} vs {float(hm['loss'])}, grad norm "
          f"{float(dm['grad_norm'])} vs {float(hm['grad_norm'])}")
    assert abs(float(dm["loss"]) - float(hm["loss"])) < 1e-2
    assert abs(float(dm["grad_norm"]) / float(hm["grad_norm"]) - 1) < 2e-2
    assert int(dm["step"]) == int(hm["step"]) == 1
    for d, h in zip(_leaves(dp), _leaves(hp)):
        assert d.is_cuda and d.dtype == h.dtype
        assert (d.cpu().float() - h.float()).abs().max() < 5e-3


@pytest.mark.gpu
def test_grad_accum_full_width_smollm(cuda):
    """smollm-135m at full width: one step at grad_accum 1 against one at 2
    from the same parameters: the loss within 1e-3 and every parameter
    within 5e-3 (the reference's bounds, tests/test_training.py). Adam's
    first step moves each element by about lr whatever its gradient, so
    the gradients themselves are held too: the global norm within 1e-2
    relative and each first moment (0.1 x the clipped gradient, f32)
    within 0.1 of its leaf's max abs. The bf16 gradients of 8 rows and of
    two blocks of 4 differ by up to 1e-3 and 2e-2 there (the tied
    embedding's, on the CPU smoke model); a sum not divided moves the norm
    by 1.0, a dropped microbatch by 0.27 and a moment by 0.8, a gradient
    added into another leaf its moments by ~1
    (tests/test_torch_training.py::test_grad_accum_holds_gradients)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import ShardedTokenStream
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_training, make_train_step
    from repro_torch.utils import tree_map

    cfg = get_arch("smollm-135m")
    api = get_model(cfg)
    p1, o1 = init_training(api, cfg, torch.Generator(device=cuda).manual_seed(0))
    p2, o2 = tree_map(torch.clone, p1), tree_map(torch.clone, o1)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in ShardedTokenStream(
        vocab=cfg.vocab, batch_per_host=4, seq=256).next_batch().items()}
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p1, o1, m1 = make_train_step(api, cfg, oc, grad_accum=1)(p1, o1, batch)
    p2, o2, m2 = make_train_step(api, cfg, oc, grad_accum=2)(p2, o2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    for a, b in zip(_leaves(p1), _leaves(p2)):
        assert (a.float() - b.float()).abs().max() < 5e-3
    g1, g2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    assert abs(g1 - g2) <= 1e-2 * g1, (g1, g2)
    for a, b in zip(_leaves(o1.mu), _leaves(o2.mu)):
        assert (a - b).abs().max() <= 0.1 * a.abs().max(), a.shape


def _trained_smoke(cuda, steps: int):
    from repro_torch.configs import SMOKES
    from repro_torch.data import ShardedTokenStream
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_training, make_train_step

    cfg = SMOKES["smollm-135m"]
    api = get_model(cfg)
    params, opt = init_training(api, cfg, torch.Generator(device=cuda).manual_seed(0))
    step = make_train_step(api, cfg, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=4, seq=64)
    batches = lambda: {k: torch.from_numpy(v).to(cuda)
                       for k, v in stream.next_batch().items()}
    for _ in range(steps):
        params, opt, _ = step(params, opt, batches())
    return params, opt, step, batches


@pytest.mark.gpu
def test_checkpoint_save_restore_on_card_bitwise(cuda, tmp_path):
    from repro_torch.checkpoint import restore, save

    params, opt, _, _ = _trained_smoke(cuda, 2)
    save(str(tmp_path), 2, (params, opt), {"k": 1})
    like = ({k: v for k, v in params.items()}, opt)
    (got_p, got_o), extra = restore(str(tmp_path), 2, like, device=cuda)
    assert extra == {"k": 1}
    for a, b in zip(_leaves((params, opt)), _leaves((got_p, got_o))):
        assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_async_checkpointer_while_next_step_updates(cuda, tmp_path):
    """submit, then at once a train step that updates the same tensors in
    place: the checkpoint holds the values at submit."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore

    params, opt, step, batches = _trained_smoke(cuda, 1)
    want = [x.clone() for x in _leaves((params, opt))]
    ck = AsyncCheckpointer(str(tmp_path))
    ck.submit(1, (params, opt))
    params, opt, _ = step(params, opt, batches())
    torch.cuda.synchronize()
    ck.close()
    got, _ = restore(str(tmp_path), 1, (params, opt), device=cuda)
    moved = False
    for w, g, now in zip(want, _leaves(got), _leaves((params, opt))):
        assert torch.equal(w, g)
        moved |= not torch.equal(w, now)
    assert moved


# -- the serving mesh: a lane's launches over its head block ---------------

LANE_SHAPES = [  # (H_kv, G, head blocks): llama2-7b's lanes, minitron-4b's
    (32, 1, (16, 8)),
    (8, 3, (2,)),
]


def _lane_cache(cuda, h_kv, G, seed):
    """llama2-7b-like ragged rows (one empty) with a live residual buffer."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    spec = tt.TierSpec((2, 4, 8), (32, 64, 32), 8)
    cache = _random_cache(gen, 4, h_kv, 128, 1024, spec, (1024, 0, 320, 704), cuda)
    for buf in (cache.resid_k, cache.resid_v):
        buf.copy_(torch.randn(buf.shape, generator=gen, device=cuda).to(buf.dtype))
    cache.n_resid.copy_(torch.tensor([3, 64, 0, 127], dtype=torch.int32))
    q = torch.randn((4, h_kv * G, 128), generator=gen, device=cuda)
    return gen, cache, q


@pytest.mark.gpu
@pytest.mark.parametrize("h_kv,G,blocks", LANE_SHAPES)
def test_k2_k5_head_block_equals_full_launch(cuda, h_kv, G, blocks):
    """K2 and K5 launched over a lane's head block (its own B x H_kv
    partials, spans and arrival counters) give that block of the full
    launch bitwise, at pages 64 and 256 for K5."""
    from repro_torch.kernels.sharded import Mesh, split_layer

    gen, cache, q = _lane_cache(cuda, h_kv, G, seed=h_kv * 10 + G)
    sm = 128 ** -0.5
    full = fused_packed_attention(q, cache.k, cache.v, cache.n_comp, sm)
    pools = {page: _to_pool(cache, page, gen) for page in (64, 256)}
    full_p = {page: fused_packed_attention_paged(
        q, p.k, p.v, p.pages.page_table, p.n_comp, 1024, sm, page_size=page)
        for page, p in pools.items()}
    for b in blocks:
        mesh = Mesh(1, h_kv // b, (cuda,) * (h_kv // b))
        for lane in mesh.lanes:
            part = split_layer(cache, lane, mesh)
            got = fused_packed_attention(lane.split(q, 1), part.k, part.v,
                                         part.n_comp, sm)
            torch.cuda.synchronize()
            for g, f in zip(got, full):
                assert torch.equal(g, lane.split(f, 1)), (b, lane.kv)
            for page, pool in pools.items():
                part = split_layer(pool, lane, mesh)
                got = fused_packed_attention_paged(
                    lane.split(q, 1), part.k, part.v, part.pages.page_table,
                    part.n_comp, 1024, sm, page_size=page)
                torch.cuda.synchronize()
                for g, f in zip(got, full_p[page]):
                    assert torch.equal(g, lane.split(f, 1)), (b, lane.kv, page)


@pytest.mark.gpu
@pytest.mark.parametrize("h_kv,G,blocks", LANE_SHAPES)
def test_mesh_attention_equals_full_heads(cuda, h_kv, G, blocks):
    """A mesh layer's decode attention (each lane's K2 / K5 over its head
    block with its dp rows masked, the residual buffer's partials and the
    log-sum-exp merge at full heads over the gathered residual) equals the
    single-device attention bitwise, for a decode step and a verify window
    of 3. (Run per lane, the residual partials' einsums and sums differ
    from the full-head ones on the card: PyTorch picks their launch layout
    by shape.)"""
    from repro_torch.kernels.sharded import Mesh, lane_lists, split_cache
    from repro_torch.models.transformer import _layer_attention

    gen, cache, q = _lane_cache(cuda, h_kv, G, seed=h_kv * 10 + G + 1)
    q = torch.randn((4, h_kv * G, 3, 128), generator=gen, device=cuda)
    sm = 128 ** -0.5
    layers = {"dense": cache, "paged": _to_pool(cache, 64, gen)}
    layers["paged"].resid_k.copy_(cache.resid_k)
    layers["paged"].resid_v.copy_(cache.resid_v)
    layers["paged"].n_resid.copy_(cache.n_resid)
    keep = lambda layer, k, v: layer  # the attention alone: no append
    kv = torch.zeros((4, h_kv, 3, 128), device=cuda)
    for kind, layer in layers.items():
        for w in (1, 3):
            want = _layer_attention([layer], [None], 0, q[:, :, :w], kv, kv,
                                    keep, sm, "fused", 1024)
            for b in blocks:
                for n_dp in (1, 2):
                    n = n_dp * h_kv // b
                    mc = split_cache([layer], Mesh(n_dp, h_kv // b, (cuda,) * n))
                    owned = [lane.owned_rows(4) for lane, _ in lane_lists(mc)]
                    got = _layer_attention(mc, owned, 0, q[:, :, :w], kv, kv,
                                           keep, sm, "fused", 1024)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (kind, w, b, n_dp)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "paged", "spec"])
def test_mesh_serving_equals_single_on_cuda(cuda, mode):
    """The llama2-7b smoke model served on ("cuda:0",) * n at meshes (1, 2)
    and (2, 2): every token bitwise equal to the (1, 1) engine's on the
    card, K2 (dense) or K5 (paged) launched once a lane a layer a step,
    and every lane's ledger lane (0, 0)'s (debug_invariants)."""
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg, _, params = _smoke_model(cuda)
    paged = mode != "dense"
    r = np.random.default_rng(7)
    prompts = [r.integers(0, cfg.vocab, n) for n in (198, 100, 228)]

    def serve(mesh):
        n = mesh[0] * mesh[1]
        eng = Engine(cfg, params, tc.PackKVConfig(), EngineConfig(
            capacity=512, max_batch=2, calib_tokens=128, decode_chunk=4,
            bucket_unit=64, paged=paged, page_size=128, spec_decode=mode == "spec",
            spec_k=3, debug_invariants=True, device=str(cuda), mesh_shape=mesh,
            mesh_devices=(str(cuda),) * n))
        srv = SlotServer(eng)
        for i, (p, m) in enumerate(zip(prompts, (10, 8, 12))):
            srv.submit(Request(rid=i, tokens=p, max_new=m))
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        srv.run()
        launches = fused_packed_attention_paged.launches if paged else \
            fused_packed_attention.launches
        return [srv.done[i].output.tolist() for i in sorted(srv.done)], launches

    want, base = serve((1, 1))
    for mesh in ((1, 2), (2, 2)):
        got, launches = serve(mesh)
        assert got == want, mesh
        assert launches == base * mesh[0] * mesh[1], (mesh, launches, base)


@pytest.mark.gpu
def test_data_parallel_two_ranks_on_one_card_bitwise(cuda, tmp_path):
    """Two ranks share cuda:0 over gloo (NCCL takes one rank a card), with
    ZeRO-1 moments: a data = 2 step of the llama2-7b and qwen2-moe-a2.7b
    smoke models equals the single-process grad_accum = 2 step bitwise
    (losses, grad norms, parameters, moments, step), on every rank."""
    import torch.multiprocessing as mp

    import torch_dp_helpers as h

    mp.spawn(h.gpu_dp2_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    r0, r1 = (torch.load(tmp_path / f"gpu_dp2_rank{r}.pt", weights_only=False)
              for r in range(2))
    for name in ("llama2-7b", "qwen2-moe-a2.7b"):
        ctl = r0[name, "ctl"]
        assert h.bitwise_diff(r0[name, "dp"], ctl) == [], name
        assert h.bitwise_diff(r1[name, "dp"], ctl) == [], name


@pytest.mark.gpu
def test_launcher_torchrun_ranks_bitwise(cuda, tmp_path):
    """``torchrun --nproc-per-node n -m repro_torch.launch.train --device
    cuda``: with a card a rank (n = every card, two or more) the ranks
    take cuda:LOCAL_RANK over NCCL; on one card two ranks share cuda:0
    over gloo. Either way the step-4 checkpoint (smollm-135m smoke, a
    checkpoint every 2 steps, ZeRO-1 moments gathered whole) equals one
    process's at --grad-accum n byte for byte, leaf for leaf."""
    import os
    import subprocess
    import sys

    cards = torch.cuda.device_count()
    n = max(cards, 2)
    backend = "nccl" if cards >= n else "gloo"
    args = ["-m", "repro_torch.launch.train", "--arch", "smollm-135m", "--smoke",
            "--device", "cuda", "--steps", "4", "--batch", str(2 * n), "--seq", "64",
            "--ckpt-every", "2", "--schedule", "wsd"]
    # torchrun gives each rank one CPU thread: so does the control (the
    # host's share of the step then runs alike)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))

    def run(cmd):
        out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
        return out.stdout

    said = run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(n)] + args + ["--ckpt-dir", str(tmp_path / "dp")])
    assert f"{n} ranks on {backend}" in said, said
    run([sys.executable] + args + ["--grad-accum", str(n), "--ckpt-dir", str(tmp_path / "one")])
    ck = lambda run: tmp_path / run / "step_00000004" / "arrays.npz"
    with np.load(ck("dp")) as a, np.load(ck("one")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert [k for k in a.files if a[k].tobytes() != b[k].tobytes()] == []
