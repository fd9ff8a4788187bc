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
    ((16,), (256,), 8, 8),  # 8 channel groups of K4/K7: more than are in flight
])
def test_tier_matvec_kernels_match_plain_and_paged(cuda, widths, counts, pack, G):
    """K3 and K4 per tier over ragged rows (one empty): within the bound
    of their plain versions and bitwise equal over two launches, K4 over bucket views of 512 and 128
    tokens bitwise equal to K4 over the capacity; K6 and K7 on the pages scattered
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
        # K4 over a bucket view equals K4 over the capacity with the counts
        # cut to the bucket (512: tensor copies of strided rows; 128: a run
        # shorter than a span, by cp.async)
        for bucket in (512, 128):
            bt = tc.slice_compressed(cache, bucket).k.tiers[i]
            nb = torch.clamp(nv, max=bucket)
            sliced = vpack_tier_out(*(flat(x) for x in (bt.payload, bt.mins, bt.shifts)),
                                    w[..., :bucket], width=t.width, pack_size=pack, n_valid=nb)
            full = vpack_tier_out(*leaves, w, width=t.width, pack_size=pack, n_valid=nb)
            torch.cuda.synchronize()
            assert torch.equal(sliced, full), bucket
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
