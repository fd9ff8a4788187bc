#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device - the card's name and power limit (nvidia-smi), torch and CUDA
     versions; then every CUDA kernel is built from csrc/ with nvcc.
  2. kernel - the fused compressed-cache attention kernel (K2) against its
     plain PyTorch version on the card, at llama2-7b decode shapes (B=4,
     H_kv=32, G=1, D=128, L=2048, ragged n_comp {0, 64, 1344, 2048}) under
     the serving engine's calibrated spec, a (1,2,4,8) spec and a width-16
     spec, and at a GQA shape (H_kv=8, G=4): m, l and o / l within
     rtol=1e-5, atol=1e-4 of the plain version and of the plain version with
     the kernel's split structure, the empty row exactly o = 0, m = -1e30,
     l = 0, two launches bitwise equal, and K2 over a 1024-token bucket view
     bitwise equal to K2 over the 2048 capacity (counts cut to 1024). Timed
     with CUDA events (L2 flushed before each run, median of 20) beside the
     plain version, the byte bound and scaled_dot_product_attention over the
     dequantized bf16 K/V (the uncompressed yardstick; the port never calls
     it). Each row also gives the launch: span blocks in the grid and live,
     shared memory per block, registers per thread (-Xptxas -v).
  3. kernel_paged - the page-indexed kernel (K5) on the same calibrated
     caches scattered into a page pool under a shuffled page table, at
     page sizes 64, 128, 256 and 512 (a span covers several pages or part
     of one): against its plain version (same tolerances), bitwise against
     K2 on the gathered dense view, and bitwise against itself; timed at
     pages 256 and 512 as K2 is, with the byte bound counting the
     page-table reads too.
  4. serve - llama2-7b at full width (32 layers, random bf16 weights from a
     seeded torch.Generator) through Engine + SlotServer: policy packkv,
     capacity 2048, 4 slots, decode_chunk 8, backend "fused", dense
     storage, monolithic admission; 6 requests of prompt lengths {320,
     700, 1000, 450, 260, 900} and 160 new tokens each (every row flushes
     its residual, slots are reused). K2's launch count must equal
     n_layers x decode steps; outputs must be finite and in the
     vocabulary. Reports decode tok/s, compressed bytes per token against
     bf16, and each request's agreement with the port's own B=1 generate
     (not a pass bar: batched and B=1 GEMMs may round differently).
  5. serve_paged - the same model and requests through the reference's
     paged serving path: a pool of 14 pages of 256 tokens (the first four
     requests reserve all 14, so the sixth blocks on pages while a slot
     is free), chunked admission (one page per step). K5's launch count must equal
     n_layers x decode steps and K2's must be 0; admission must block at
     least once; reserved pages stay within the pool; every retired row's
     counters equal the host mirror (the flush rule). Reports decode
     tok/s, each request's agreement with the dense phase's tokens,
     chunked against monolithic admission (logits and cache bytes) for
     every prompt (dense) and the 1000-token one (paged), which must be
     bitwise equal, and the wall time per step of steady decode launches,
     dense and paged in turns.

  6. matvec - the tier matvec entry points (packed_qk_scores,
     packed_weighted_v and their paged forms) and their kernels K3, K4
     (dense) and K6, K7 (paged), on caches built as in the kernel phase at
     its specs and shapes: each kernel against its plain version within
     the f32 bound 2 (n + 2) 2^-24 sum|terms|, two launches bitwise equal,
     the fused entry points within rtol=1e-5, atol=1e-4 of the ref
     backend; at the main shape timed (as K2) beside the plain version,
     the byte bound and torch.bmm over the dequantized bf16 K or V (the
     uncompressed cuBLAS yardstick; the port never calls it), and the
     whole entry-point call, beside an empty launch and a torch.sum over
     as many bytes as each must move (their ratios to both); each row
     gives the launches (span blocks, live, shared memory, registers).
     Paged half (matvec_paged), pages 256 and 512 under a shuffled
     table: K6 and K7 bitwise equal to K3 and K4 on the dense cache and to
     themselves, timed likewise. A wide spec (matvec_wide: one width-16
     tier of 256 channels, G=8, more channel groups than the kernels keep
     in flight): K3 and K4 within the bound of their plain versions,
     bitwise equal to themselves, K6 and K7 at pages 64, 128, 256 and 512
     bitwise equal to them. Then the
     main path (matvec_path): the four entry points called once each with
     every launch count set to 0 first; each kernel must have launched.

Then the kernels line and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-4)
SPIN_CYCLES = 4_000_000  # ~2 ms of the card's clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, L2 flushed before
    each (a decode step finds each layer's cache cold). A spin kernel of
    ~2 ms queued after the flush keeps the card busy while the host
    enqueues the run, so the host's time in Python wrappers and dispatch
    is not counted; a host sync inside ``fn`` (the plain versions' loop
    bounds) still is."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kv_like(gen, h, n, d, device):
    """KV-like bf16 data: per-channel offsets and scales plus noise."""
    import torch

    off = torch.randn((h, 1, d), generator=gen, device=device) * 2.0
    sc = 0.5 + torch.rand((h, 1, d), generator=gen, device=device) * 2.0
    x = torch.randn((h, n, d), generator=gen, device=device) * sc + off
    return x.to(torch.bfloat16)


def tier_bytes(spec, n_rows, h_kv: int) -> int:
    """Bytes of one tensor's tiers over these live counts: payload bits,
    an int8 min and a 2-bit shift per pack, per channel and kv head."""
    total = 0
    for n in n_rows:
        P = n // spec.pack_size
        for w, c in zip(spec.widths, spec.counts):
            total += h_kv * c * (n * w // 8 + P + (P + 3) // 4)
    return total


def kernel_bytes(cache, n_rows, G: int) -> int:
    """Bytes K2 must move for these live counts: compressed payload, pack
    metadata and f32 scale/zero of each live token, the permutations, q
    and the outputs."""
    k, v = cache.k, cache.v
    h_kv, D = k.scale.shape[1], k.spec.head_dim
    total = tier_bytes(k.spec, n_rows, h_kv) + tier_bytes(v.spec, n_rows, h_kv)
    total += sum(n_rows) * h_kv * 2 * 8  # K and V scale + zero, f32
    B = len(n_rows)
    total += B * h_kv * (2 * D * 4)  # chan_perm K and V
    total += B * h_kv * G * (D * 4 + v.spec.head_dim * 4 + 8)  # q, o, m, l
    return total


def ragged_cache(ks, vs, B: int, h_kv: int, D: int, L: int, lengths, gen):
    """A dense compressed cache of capacity L whose row r holds lengths[r]
    KV-like tokens (0: an empty row)."""
    from repro_torch.core import cache as tc

    cfg = tc.PackKVConfig(k_spec_static=ks, v_spec_static=vs)
    cache = tc.alloc_layer_cache(cfg, B, h_kv, D, L, device=gen.device)
    for r, n in enumerate(lengths):
        if n:
            tc.insert_prefill(cache, r, kv_like(gen, h_kv, n, D, gen.device),
                              kv_like(gen, h_kv, n, D, gen.device))
    return cache


def kernel_flops(cache, n_rows, G: int) -> int:
    k = cache.k
    h_kv, D, Dv = k.scale.shape[1], k.spec.head_dim, cache.v.spec.head_dim
    return sum(n for n in n_rows) * h_kv * G * (2 * D + 2 * Dv + 8)


# the kernel phases' decode shapes (name, B, H_kv, G) at D=128 over a
# 2048-token bucket, with ragged live counts (an empty row among them)
SHAPES = [("llama2-7b", 4, 32, 1), ("gqa", 4, 8, 4)]
LENGTHS = (0, 64, 1344, 2048)


def kernel_specs(engine) -> dict:
    """The (K, V) tier specs the kernel phases run: the serving engine's
    calibrated one, a (1,2,4,8) one and a width-16 one."""
    from repro_torch.core.tiered import TierSpec

    return {
        "calibrated": (engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static),
        "w1248": (TierSpec((1, 2, 4, 8), (32, 32, 32, 32)),) * 2,
        "w16": (TierSpec((4, 16), (96, 32)),) * 2,
    }


def held_to(got, want) -> None:
    """K2/K5's partials against a plain version's: m and l as they are, o
    after dividing by l (the region's attention output): the unnormalized
    acc and zsum terms reach ~1e2 over 2048 tokens and cancel in acc +
    zsum, so f32 sums in another order leave ~1e-4 absolute differences
    on o itself."""
    import torch

    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, **TOL)
    norm = lambda o, l: o / torch.clamp(l, min=1e-30)[..., None]
    torch.testing.assert_close(norm(got[0], got[2]), norm(want[0], want[2]), **TOL)


def ptxas_usage() -> dict:
    """Registers per thread and spill-store bytes of every kernel
    instantiation of both libraries, from their ``-Xptxas -v`` build
    logs: {``name<args>``: {"regs": r, "spill_bytes": s}}."""
    from repro_torch.kernels import build

    return {k: v for name in build.LIBRARIES for k, v in build.built_usage(name).items()}


def launch_shape(cache, lengths, G: int, L: int, paged: bool) -> dict:
    """K2/K5's launch: span blocks in the grid, those of live spans (the
    rest exit at once), dynamic shared memory per block, registers per
    thread (the span kernel of this storage and group size)."""
    from repro_torch.kernels.packed_attention import SPAN, kernel_smem_bytes

    h_kv = cache.k.scale.shape[1]  # the dense cache
    key = f"packed_attention_span_kernel<{str(paged).lower()},{G}>"
    return {"blocks": len(lengths) * h_kv * -(-L // SPAN),
            "live_blocks": h_kv * sum(-(-min(x, L) // SPAN) for x in lengths),
            "threads": 256, "smem_bytes": kernel_smem_bytes(cache.k, cache.v, G),
            "regs": ptxas_usage().get(key, {}).get("regs")}


def tier_launches(scores: bool, spec, G: int, L: int, lengths, h_kv: int,
                  paged: bool) -> list:
    """K3/K6's (``scores``) or K4/K7's launch for each tier of ``spec``:
    span blocks in the grid and live (the rest write zeros or exit at
    once), dynamic shared memory per block, registers per thread and
    spill bytes of its instantiation (tier width, G rounded up to 1, 2, 4
    or 8)."""
    from repro_torch.kernels.kpack_matvec import tier_smem_bytes
    from repro_torch.kernels.packed_attention import SPAN

    usage = ptxas_usage()
    kernel = "kpack_span_kernel" if scores else "vpack_span_kernel"
    gm = next(m for m in (1, 2, 4, 8) if G <= m)
    return [{"width": w, "C": c, "blocks": len(lengths) * h_kv * -(-L // SPAN),
             "live_blocks": h_kv * sum(-(-min(x, L) // SPAN) for x in lengths),
             "threads": 256, "smem_bytes": tier_smem_bytes(w, spec.pack_size, c, G, scores=scores),
             **usage.get(f"{kernel}<{str(paged).lower()},{w.bit_length() - 1},{gm}>",
                         {"regs": None, "spill_bytes": None})}
            for w, c in zip(spec.widths, spec.counts)]


def phase_kernel(engine, device) -> dict:
    import torch

    from repro_torch.core import cache as tc
    from repro_torch.core.tiered import dequantize_tiered
    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_split_torch,
        fused_packed_attention_torch,
    )

    gen = torch.Generator(device=device).manual_seed(1)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    lengths = LENGTHS
    D, L = 128, 2048
    main = None
    for sname, (ks, vs) in kernel_specs(engine).items():
        for shape, B, h_kv, G in SHAPES:
            if sname != "calibrated" and shape != "llama2-7b":
                continue
            cache = ragged_cache(ks, vs, B, h_kv, D, L, lengths, gen)
            q = torch.randn((B, h_kv * G, D), generator=gen, device=device)
            sm = D ** -0.5
            n = cache.n_comp
            got = fused_packed_attention(q, cache.k, cache.v, n, sm)
            again = fused_packed_attention(q, cache.k, cache.v, n, sm)
            torch.cuda.synchronize()
            want = fused_packed_attention_torch(q, cache.k, cache.v, n, sm)
            err = 0.0
            for g, a, w in zip(got, again, want):
                check(torch.equal(g, a), f"{sname}/{shape}: two launches differ")
                err = max(err, float((g - w).abs().max()))
            held_to(got, want)
            check(bool((got[0][0] == 0).all() and (got[1][0] == -1e30).all()
                       and (got[2][0] == 0).all()),
                  f"{sname}/{shape}: the empty row is not o = 0, m = -1e30, l = 0")
            # the plain version with the kernel's split structure
            split = fused_packed_attention_split_torch(q, cache.k, cache.v, n, sm)
            held_to(got, split)
            err_split = max(float((g - w).abs().max()) for g, w in zip(got, split))
            # a 1024-token bucket view == the full 2048 capacity, bitwise,
            # when every row's count fits the bucket
            n_half = torch.clamp(n, max=L // 2)
            view = tc.slice_compressed(cache, L // 2)
            sliced = fused_packed_attention(q, view.k, view.v, n_half, sm)
            full = fused_packed_attention(q, cache.k, cache.v, n_half, sm)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(sliced, full)),
                  f"{sname}/{shape}: K2 over a {L // 2}-token bucket != K2 over {L}")
            ms = time_ms(lambda: fused_packed_attention(q, cache.k, cache.v, n, sm), flush)
            plain_ms = time_ms(
                lambda: fused_packed_attention_torch(q, cache.k, cache.v, n, sm), flush)
            # yardstick: uncompressed attention over the same K/V in bf16
            kd = dequantize_tiered(cache.k, torch.bfloat16).transpose(-1, -2)
            vd = dequantize_tiered(cache.v, torch.bfloat16).transpose(-1, -2)
            kd, vd = (x.repeat_interleave(G, dim=1).contiguous() for x in (kd, vd))
            qb = q.to(torch.bfloat16)[:, :, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = time_ms(lambda: sdpa(qb, kd, vd, scale=sm), flush)
            n_rows = [min(x, L) for x in lengths]
            nbytes = kernel_bytes(cache, n_rows, G)
            flops = kernel_flops(cache, n_rows, G)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
            row = {"phase": "kernel", "spec": sname, "shape": shape, "B": B,
                   "H_kv": h_kv, "G": G, "D": D, "L": L, "n_comp": list(lengths),
                   "k_spec": [ks.widths, ks.counts], "v_spec": [vs.widths, vs.counts],
                   "max_abs_err": err, "max_abs_err_vs_split": err_split,
                   "bitwise_repeat": True, "bitwise_sliced_eq_full": True, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "x_bound": ms / max(t_bytes, t_ops), "vs_library": ms / library_ms,
                   **launch_shape(cache, lengths, G, L, paged=False)}
            emit(row)
            if main is None:
                main = row
            del cache, kd, vd
    return main


def to_pool(cache, page_size: int, gen):
    """The dense cache's pages scattered into a pool of exactly
    B * L / page_size pages under a shuffled page table."""
    import dataclasses

    import torch

    from repro_torch.core import cache as tc

    B, h_kv, L = cache.k.scale.shape
    cfg = dataclasses.replace(cache.cfg, paged=True, page_size=page_size)
    paged = tc.alloc_layer_cache(cfg, B, h_kv, cache.k.spec.head_dim, L,
                                 device=cache.n_comp.device)
    n_pages = L // page_size
    phys = torch.randperm(B * n_pages, generator=gen, device=gen.device)
    phys = phys.to(torch.int32).reshape(B, n_pages)
    for pool, dense in ((paged.k, cache.k), (paged.v, cache.v)):
        tc._scatter_pages_tiered(pool, dense, phys)
        pool.chan_perm.copy_(dense.chan_perm)
    paged.pages.page_table.copy_(phys)
    paged.n_comp.copy_(cache.n_comp)
    return paged


def phase_kernel_paged(engine, device) -> dict:
    import torch

    from repro_torch.core import cache as tc
    from repro_torch.core.tiered import dequantize_tiered
    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
        fused_packed_attention_paged_torch,
    )

    gen = torch.Generator(device=device).manual_seed(2)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    B, h_kv, G, D, L = 4, 32, 1, 128, 2048
    lengths = LENGTHS
    cache = ragged_cache(ks, vs, B, h_kv, D, L, lengths, gen)
    q = torch.randn((B, h_kv * G, D), generator=gen, device=device)
    sm = D ** -0.5
    n = cache.n_comp
    kd = dequantize_tiered(cache.k, torch.bfloat16).transpose(-1, -2).contiguous()
    vd = dequantize_tiered(cache.v, torch.bfloat16).transpose(-1, -2).contiguous()
    qb = q.to(torch.bfloat16)[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    main = None
    for page in (64, 128, 256, 512):  # timed at 256 and 512
        paged = to_pool(cache, page, gen)
        args = (q, paged.k, paged.v, paged.pages.page_table, n, L, sm)
        k5 = lambda: fused_packed_attention_paged(*args, page_size=page)
        got, again = k5(), k5()
        view = tc.gather_paged(paged)
        k2 = fused_packed_attention(q, view.k, view.v, n, sm)
        torch.cuda.synchronize()
        want = fused_packed_attention_paged_torch(*args, page_size=page)
        err = 0.0
        for g, a, d, w in zip(got, again, k2, want):
            check(torch.equal(g, a), f"page {page}: two K5 launches differ")
            check(torch.equal(g, d), f"page {page}: K5 != K2 on the gathered view")
            err = max(err, float((g - w).abs().max()))
        held_to(got, want)
        check(bool((got[0][0] == 0).all() and (got[1][0] == -1e30).all()
                   and (got[2][0] == 0).all()),
              "the empty row's partials are not o = 0, m = -1e30, l = 0")
        row = {"phase": "kernel_paged", "page_size": page, "B": B, "H_kv": h_kv,
               "G": G, "D": D, "n_tokens": L, "n_comp": list(lengths),
               "k_spec": [ks.widths, ks.counts], "v_spec": [vs.widths, vs.counts],
               "max_abs_err": err, "bitwise_repeat": True,
               "bitwise_equal_k2_gathered": True,
               **launch_shape(cache, lengths, G, L, paged=True)}
        if page >= 256:
            ms = time_ms(k5, flush)
            plain_ms = time_ms(
                lambda: fused_packed_attention_paged_torch(*args, page_size=page), flush)
            library_ms = time_ms(lambda: sdpa(qb, kd, vd, scale=sm), flush)
            n_rows = list(lengths)
            table_bytes = sum(-(-x // page) for x in n_rows) * 4
            nbytes = kernel_bytes(cache, n_rows, G) + table_bytes
            flops = kernel_flops(cache, n_rows, G)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
            row.update({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                        "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "x_bound": ms / max(t_bytes, t_ops),
                        "vs_library": ms / library_ms})
        emit(row)
        if page == 256:
            main = row
        del paged, view
    return main


def cache_tensors(x):
    """Every tensor of a cache (dataclasses, lists, tuples), in order."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from cache_tensors(getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from cache_tensors(v)


def phase_serve(engine, cfg, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.tiered import tiered_bits_per_value
    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.serving import Request, SlotServer

    prompts = serve_prompts(cfg)
    server = SlotServer(engine)
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, tokens=p, max_new=160))
    # record each row's compressed length as it retires
    retired, free_slot = [], engine.free_slot
    engine.free_slot = lambda cache, slot: (
        retired.append(int(cache[0].n_comp[slot])), free_slot(cache, slot))[1]
    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    t0 = time.perf_counter()
    done = {r.rid: r for r in server.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_packed_attention.launches
    s = server.stats
    check(len(done) == len(prompts), "not every request finished")
    check(launches > 0 and launches == cfg.n_layers * s.decode_steps,
          f"fused launches {launches} != {cfg.n_layers} x {s.decode_steps} steps")
    check(fused_packed_attention_paged.launches == 0, "dense serving launched K5")
    for r in done.values():
        out = np.asarray(r.output)
        check(out.shape == (160,) and (out >= 0).all() and (out < cfg.vocab).all(),
              f"request {r.rid}: output out of the vocabulary")
    engine.free_slot = free_slot
    # the compressed lengths the flush rule gives (residual R, 64-token
    # blocks): every row must have flushed at least once
    pack, want = engine.pack_cfg, []
    for p in prompts:
        lb, r = len(p) // pack.block * pack.block, len(p) % pack.block + 159
        f = -(-(r - pack.residual) // pack.block) if r > pack.residual else 0
        check(f >= 1, "a request too short to flush")
        want.append(lb + f * pack.block)
    check(sorted(retired) == sorted(want), f"compressed lengths {retired} != {want}")
    logits, _ = engine.prefill({"tokens": prompts[0][None]})
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    # per-request agreement with the port's own B=1 generate
    agree = []
    for rid, r in sorted(done.items()):
        gen, _ = engine.generate({"tokens": r.tokens[None]}, 160)
        out = np.asarray(r.output)
        same = out == gen[0]
        prefix = int(np.argmin(same)) if not same.all() else len(out)
        agree.append({"rid": rid, "rate": float(same.mean()), "prefix": prefix})
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    per_tok = cfg.n_layers * cfg.n_kv_heads * cfg.hd
    comp_bytes = per_tok * (tiered_bits_per_value(ks) + tiered_bits_per_value(vs)) / 8
    bf16_bytes = per_tok * 2 * 2
    decode_tokens = s.tokens_out - s.admitted  # the first token comes from prefill
    row = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "requests": len(prompts), "max_new": 160,
           "max_batch": engine.ecfg.max_batch, "capacity": engine.ecfg.capacity,
           "k_spec": [ks.widths, ks.counts], "v_spec": [vs.widths, vs.counts],
           "decode_steps": s.decode_steps, "decode_launches": s.chunk_launches,
           "fused_launches": launches,
           "launches_per_step": launches / s.decode_steps,
           "slot_reuses": s.slot_reuses, "occupancy": s.occupancy,
           "wall_s": wall, "decode_s": s.decode_s,
           "decode_tok_s": decode_tokens / s.decode_s,
           "tok_s_with_prefill": s.tokens_out / wall,
           "compressed_bytes_per_token": comp_bytes,
           "bf16_bytes_per_token": bf16_bytes,
           "compression_ratio": bf16_bytes / comp_bytes,
           "agreement_with_b1_generate": agree}
    emit(row)
    return {"launches": launches, "want_n_comp": want,
            "compressed_bytes_per_token": comp_bytes,
            "outputs": {rid: np.asarray(r.output) for rid, r in done.items()}}


def serve_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, n) for n in (320, 700, 1000, 450, 260, 900)]


def chunk_vs_mono(engine, tokens) -> dict:
    """One prompt admitted by the monolithic insert and by 256-token
    chunks: their last-token logits and row bytes."""
    import torch

    mono = engine.alloc_slot_cache()
    l_mono, mono = engine.insert_request(mono, 0, tokens)
    chunked = engine.alloc_slot_cache()
    S = len(tokens)
    bounds = list(range(0, S, 256)) + [S]
    scratch = engine.chunk_init(S)
    for s0, s1 in zip(bounds[:-2], bounds[1:-1]):
        _, scratch = engine.chunk_step(scratch, tokens[s0:s1], s0)
    l_chunk, chunked = engine.chunk_final(chunked, 0, scratch,
                                          tokens[bounds[-2]:], bounds[-2])
    same = all(torch.equal(a, b) for a, b in
               zip(cache_tensors(mono), cache_tensors(chunked)))
    return {"chunks": len(bounds) - 1,
            "logits_max_abs_diff": float((l_mono - l_chunk).abs().max()),
            "argmax_equal": int(l_mono.argmax()) == int(l_chunk.argmax()),
            "cache_bytes_equal": same}


def steady_step_ms(engines: dict, cfg, launches: int = 4) -> dict:
    """Wall milliseconds per decode step of steady launches (4 rows of 700
    tokens, 8 steps a launch, no flush in the window), the engines taken
    in turns A, B, B, A in this one process (host time varies between
    processes and machines)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 700) for _ in range(4)]
    state = {}
    for name, eng in engines.items():
        cache = eng.alloc_slot_cache()
        toks = []
        for i, p in enumerate(prompts):
            logits, cache = eng.insert_request(cache, i, p)
            toks.append(int(torch.argmax(logits)))
        state[name] = [cache, np.asarray(toks, np.int32)[:, None]]
    names = list(engines)
    out = {n: [] for n in names}
    for name in names + names[::-1]:
        eng, st = engines[name], state[name]
        n_bucket = eng.bucket_for(700 + (launches + 1) * 8)
        run = lambda: eng.decode_chunk(st[0], st[1], [True] * 4, 8, None, n_bucket)
        toks, _, st[0] = run()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            toks, _, st[0] = run()
            st[1] = toks[-1][:, None]
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) * 1e3 / (8 * launches))
    return out


def phase_serve_paged(engine, cfg, dense: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    pool_pages = 14
    paged = Engine(cfg, engine.params, engine.pack_cfg,
                   EngineConfig(capacity=2048, max_batch=4, decode_chunk=8,
                                backend="fused", device=engine.ecfg.device, calibrate=False,
                                paged=True, page_size=256, pool_pages=pool_pages,
                                prefill_chunk_pages=1))
    prompts = serve_prompts(cfg)
    server = SlotServer(paged)
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, tokens=p, max_new=160))
    # at each retirement: the host counter mirror and the device counters
    mirror, retire = [], server._retire_slot

    def retire_and_record(i):
        c = server.cache[0]
        mirror.append((server._counters(server.slots[i]),
                       (int(c.n_comp[i]), int(c.n_resid[i]))))
        return retire(i)

    server._retire_slot = retire_and_record
    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    t0 = time.perf_counter()
    done = {r.rid: r for r in server.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_packed_attention_paged.launches
    s = server.stats
    check(len(done) == len(prompts), "not every request finished")
    check(launches > 0 and launches == cfg.n_layers * s.decode_steps,
          f"K5 launches {launches} != {cfg.n_layers} x {s.decode_steps} steps")
    check(fused_packed_attention.launches == 0, "paged serving launched K2")
    check(s.admission_blocks >= 1, "admission never blocked on pages")
    check(s.pages_reserved_peak <= pool_pages - paged.ecfg.page_watermark,
          f"reserved {s.pages_reserved_peak} of {pool_pages} pages")
    check(s.prefill_chunks > 0, "no chunked admission ran")
    check(all(m == d for m, d in mirror), f"counters differ from the mirror: {mirror}")
    check(sorted(m[0][0] for m in mirror) == sorted(dense["want_n_comp"]),
          f"compressed lengths {mirror} != {dense['want_n_comp']}")
    agree = []
    for rid, r in sorted(done.items()):
        out = np.asarray(r.output)
        check(out.shape == (160,) and (out >= 0).all() and (out < cfg.vocab).all(),
              f"request {rid}: output out of the vocabulary")
        same = out == dense["outputs"][rid]
        prefix = int(np.argmin(same)) if not same.all() else len(out)
        agree.append({"rid": rid, "rate": float(same.mean()), "prefix": prefix})
    probe = {"dense": [dict(prompt=len(p), **chunk_vs_mono(engine, p)) for p in prompts],
             "paged": [dict(prompt=len(prompts[2]), **chunk_vs_mono(paged, prompts[2]))]}
    # chunked == monolithic admission, bitwise (the final chunk's GEMMs run
    # over a full chunk's rows: prefill_chunk's ``rows``)
    for r in probe["dense"] + probe["paged"]:
        check(r["logits_max_abs_diff"] == 0.0 and r["cache_bytes_equal"],
              f"chunked != monolithic admission: {r}")
    steady = steady_step_ms({"dense": engine, "paged": paged}, cfg)
    decode_tokens = s.tokens_out - s.admitted
    emit({"phase": "serve_paged", "arch": cfg.name, "page_size": 256,
          "pool_pages": pool_pages, "prefill_chunk_pages": 1,
          "decode_steps": s.decode_steps, "decode_launches": s.chunk_launches,
          "k5_launches": launches,
          "launches_per_step": launches / s.decode_steps,
          "admission_blocks": s.admission_blocks,
          "pages_reserved_peak": s.pages_reserved_peak,
          "prefill_chunks": s.prefill_chunks, "slot_reuses": s.slot_reuses,
          "occupancy": s.occupancy, "wall_s": wall, "decode_s": s.decode_s,
          "decode_tok_s": decode_tokens / s.decode_s,
          "tok_s_with_prefill": s.tokens_out / wall,
          "compressed_bytes_per_token": dense["compressed_bytes_per_token"],
          "agreement_with_dense_phase": agree, "chunked_vs_monolithic": probe,
          "steady_ms_per_step": steady})
    return {"launches": launches}


def tier_runs(tc_, flat, sliced: bool):
    """(tier, its (payload, mins, shifts) through ``flat``, its channel
    slice of q's head dim if ``sliced`` (K) else None (V, whose w is
    whole)) for each tier of a TieredCache, in order."""
    from repro_torch.kernels.ops import _tier_slices

    return [(t, tuple(flat(x) for x in (t.payload, t.mins, t.shifts)),
             sl if sliced else None) for t, sl in _tier_slices(tc_)]


def within_bound(got, want, mag, n: int) -> float:
    """Max |got - want|, after checking it against 2 (n + 2) 2^-24 mag:
    two f32 sums of n terms whose absolute values sum to mag."""
    import torch

    diff = (got - want).abs()
    check(bool((diff <= 2 * (n + 2) * 2.0 ** -24 * mag + 1e-30).all()),
          f"kernel and plain version differ past the f32 bound: {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def bound(nbytes: int, flops: int) -> dict:
    """The least time on the card: bytes over HBM, operations over f32."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def yardsticks(ms: float, nbytes: int, flush, device) -> dict:
    """An empty launch and a torch.sum over a contiguous f32 tensor of
    nbytes, timed as the kernels are, and a kernel time's ratio to each."""
    import torch

    x = torch.ones(nbytes // 4, device=device)
    empty = time_ms(lambda: torch.cuda._sleep(0), flush)
    total = time_ms(lambda: x.sum(), flush)
    return {"empty_launch_ms": empty, "torch_sum_ms": total,
            "vs_empty_launch": ms / empty, "vs_torch_sum": ms / total}


def phase_matvec_wide(device, gen) -> None:
    """The four tier matvecs at a spec with more channel groups than they
    keep in flight (one width-16 tier of 256 channels, G=8): K3 and K4
    within the f32 bound of their plain versions, bitwise equal over two
    launches, K6 and K7 at pages 64, 128, 256 and 512 bitwise equal to K3
    and K4 on the gathered view."""
    import torch

    from repro_torch.core.tiered import TierSpec, unpack_tier
    from repro_torch.kernels.kpack_matvec import (
        kpack_tier_scores,
        kpack_tier_scores_paged,
        kpack_tier_scores_torch,
    )
    from repro_torch.kernels.packed_attention import _rows_to_bh
    from repro_torch.kernels.vpack_matvec import (
        vpack_tier_out,
        vpack_tier_out_paged,
        vpack_tier_out_torch,
    )

    spec = TierSpec((16,), (256,), 8)
    B, h_kv, G, D, L = 4, 4, 8, 256, 2048
    cache = ragged_cache(spec, spec, B, h_kv, D, L, LENGTHS, gen)
    BH = B * h_kv
    flat = lambda t: tuple(x.reshape(BH, *x.shape[2:]) for x in (t.payload, t.mins, t.shifts))
    kt, vt = cache.k.tiers[0], cache.v.tiers[0]
    kl, vl = flat(kt), flat(vt)
    q = torch.randn((BH, G, D), generator=gen, device=device)
    w = torch.softmax(torch.randn((BH, G, L), generator=gen, device=device), -1)
    nv = _rows_to_bh(cache.n_comp, B, h_kv, device)
    kw = dict(width=16, pack_size=8)
    s3, again3 = (kpack_tier_scores(*kl, q, n_valid=nv, **kw) for _ in range(2))
    got, again = (vpack_tier_out(*vl, w, n_valid=nv, **kw) for _ in range(2))
    torch.cuda.synchronize()
    check(torch.equal(s3, again3), "wide spec: two K3 launches differ")
    check(torch.equal(got, again), "wide spec: two K4 launches differ")
    ints = lambda t: unpack_tier(t, L).reshape(BH, 256, L).float().abs()
    err3 = within_bound(s3, kpack_tier_scores_torch(*kl, q, n_valid=nv, **kw),
                        torch.bmm(q.abs(), ints(kt)), 256)
    mag = torch.bmm(w.abs(), ints(vt).transpose(1, 2))
    err = within_bound(got, vpack_tier_out_torch(*vl, w, n_valid=nv, **kw), mag, L)
    for page in (64, 128, 256, 512):
        pool = to_pool(cache, page, gen)
        pk, pv = pool.k.tiers[0], pool.v.tiers[0]
        table = pool.pages.page_table
        s6 = kpack_tier_scores_paged(pk.payload, pk.mins, pk.shifts, q, table, nv, L,
                                     page_size=page, **kw)
        paged = vpack_tier_out_paged(pv.payload, pv.mins, pv.shifts, w, table, nv,
                                     page_size=page, **kw)
        torch.cuda.synchronize()
        check(torch.equal(s6, s3), f"wide spec, page {page}: K6 != K3")
        check(torch.equal(paged, got), f"wide spec, page {page}: K7 != K4")
        del pool
    emit({"phase": "matvec_wide", "spec": [spec.widths, spec.counts], "pack": 8, "B": B,
          "H_kv": h_kv, "G": G, "L": L, "n_valid": list(LENGTHS), "k3_max_abs_err": err3,
          "k4_max_abs_err": err, "bitwise_repeat": True,
          "k6_k7_bitwise_equal_k3_k4_pages": [64, 128, 256, 512],
          "launch": {"k3": tier_launches(True, spec, G, L, LENGTHS, h_kv, False),
                     "k4": tier_launches(False, spec, G, L, LENGTHS, h_kv, False)}})


def phase_matvec(engine, device) -> dict:
    """The tier matvec entry points (K3, K4; paged K6, K7)."""
    import torch

    from repro_torch.core.tiered import dequantize_tiered, unpack_tier
    from repro_torch.kernels import ops
    from repro_torch.kernels.kpack_matvec import (
        kpack_tier_scores,
        kpack_tier_scores_paged,
        kpack_tier_scores_paged_torch,
        kpack_tier_scores_torch,
    )
    from repro_torch.kernels.packed_attention import _rows_to_bh
    from repro_torch.kernels.vpack_matvec import (
        vpack_tier_out,
        vpack_tier_out_paged,
        vpack_tier_out_paged_torch,
        vpack_tier_out_torch,
    )

    gen = torch.Generator(device=device).manual_seed(3)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    D, L, sm = 128, 2048, 128 ** -0.5
    kernels = {}  # name -> the kernels-line numbers of the main shape

    def run_tiers(fn, runs, x, **kw):
        """One launch per tier, as the ops functions launch them."""
        return [fn(*leaves, x if sl is None else x[..., sl], width=t.width,
                   pack_size=t.pack_size, **kw) for t, leaves, sl in runs]

    def held(name, fn, plain, runs, x, mags, n_terms, **kw):
        """Each tier's launch twice (bitwise equal) and against the plain
        version within the f32 bound; returns (outputs, max abs err)."""
        got, again = run_tiers(fn, runs, x, **kw), run_tiers(fn, runs, x, **kw)
        torch.cuda.synchronize()
        want = run_tiers(plain, runs, x, **kw)
        err = 0.0
        for g, a, w, m, n in zip(got, again, want, mags, n_terms):
            check(torch.equal(g, a), f"{name}: two launches differ")
            err = max(err, within_bound(g, w, m, n))
        return got, err

    for sname, (ks, vs) in kernel_specs(engine).items():
        for shape, B, h_kv, G in SHAPES:
            if sname != "calibrated" and shape != "llama2-7b":
                continue
            main = sname == "calibrated" and shape == "llama2-7b"
            cache = ragged_cache(ks, vs, B, h_kv, D, L, LENGTHS, gen)
            BH = B * h_kv
            flat = lambda a: a.reshape(BH, *a.shape[2:])
            q = torch.randn((B, h_kv * G, D), generator=gen, device=device)
            w = torch.softmax(torch.randn((B, h_kv * G, L), generator=gen,
                                          device=device), -1)
            nv = _rows_to_bh(cache.n_comp, B, h_kv, device)
            qf = ops._perm_q(q, cache.k, BH)
            ws = w.reshape(BH, G, L) * flat(cache.v.scale)[:, None, :]
            k_runs = tier_runs(cache.k, flat, True)
            v_runs = tier_runs(cache.v, flat, False)
            ints = lambda runs: [unpack_tier(t, L).reshape(BH, -1, L).float().abs()
                                 for t, _, _ in runs]
            k_mags = [torch.bmm(qf[..., sl].abs(), i)
                      for (_, _, sl), i in zip(k_runs, ints(k_runs))]
            v_mags = [torch.bmm(ws.abs(), i.transpose(1, 2)) for i in ints(v_runs)]
            k_cs = [t.payload.shape[2] for t, _, _ in k_runs]
            si, err3 = held("K3", kpack_tier_scores, kpack_tier_scores_torch, k_runs,
                            qf, k_mags, k_cs, n_valid=nv)
            vo, err4 = held("K4", vpack_tier_out, vpack_tier_out_torch, v_runs, ws,
                            v_mags, [L] * len(v_runs), n_valid=nv)
            # the entry points: fused against the ref backend
            n = cache.n_comp
            s_ops = lambda be="fused": ops.packed_qk_scores(q, cache.k, sm, n_valid=n,
                                                             backend=be)
            o_ops = lambda be="fused": ops.packed_weighted_v(w, cache.v, n_valid=n,
                                                              backend=be)
            torch.testing.assert_close(s_ops(), s_ops("ref"), **TOL)
            torch.testing.assert_close(o_ops(), o_ops("ref"), **TOL)
            n_rows = list(LENGTHS)
            row = {"phase": "matvec", "spec": sname, "shape": shape, "B": B,
                   "H_kv": h_kv, "G": G, "D": D, "L": L, "n_valid": n_rows,
                   "k_spec": [ks.widths, ks.counts], "v_spec": [vs.widths, vs.counts],
                   "k3_max_abs_err": err3, "k4_max_abs_err": err4,
                   "bitwise_repeat": True, "ops_fused_vs_ref": "within rtol 1e-5 atol 1e-4",
                   "launch": {"k3": tier_launches(True, ks, G, L, n_rows, h_kv, False),
                              "k4": tier_launches(False, vs, G, L, n_rows, h_kv, False)}}
            if main:
                # bytes each must move: the live tiers; K3 q and the whole
                # score bucket, K4 the live weights and its output
                k3_bytes = (tier_bytes(ks, n_rows, h_kv) + BH * G * D * 4
                            + BH * G * L * 4 + BH * 4)
                k4_bytes = (tier_bytes(vs, n_rows, h_kv) + sum(n_rows) * h_kv * G * 4
                            + BH * G * D * 4 + BH * 4)
                flops = 2 * sum(n_rows) * h_kv * G * D
                # yardstick: cuBLAS bmm over the dequantized bf16 rows
                kd = dequantize_tiered(cache.k, torch.bfloat16).transpose(-1, -2)
                vd = dequantize_tiered(cache.v, torch.bfloat16).transpose(-1, -2)
                kd, vd = (x.reshape(BH, L, D).contiguous() for x in (kd, vd))
                qb = q.to(torch.bfloat16).reshape(BH, G, D)
                wb = w.to(torch.bfloat16).reshape(BH, G, L)
                lib = {"K3": lambda: torch.bmm(qb, kd.transpose(1, 2)),
                       "K4": lambda: torch.bmm(wb, vd)}
                for name, fn, plain, nbytes, entry, err in (
                        ("K3", kpack_tier_scores, kpack_tier_scores_torch, k3_bytes,
                         s_ops, err3),
                        ("K4", vpack_tier_out, vpack_tier_out_torch, k4_bytes, o_ops, err4)):
                    runs, x = (k_runs, qf) if name == "K3" else (v_runs, ws)
                    kernels[name] = {
                        "max_abs_err": err,
                        "ms": time_ms(lambda: run_tiers(fn, runs, x, n_valid=nv), flush),
                        "plain_ms": time_ms(lambda: run_tiers(plain, runs, x, n_valid=nv),
                                            flush),
                        "library_ms": time_ms(lib[name], flush),
                        "ops_ms": time_ms(entry, flush), "bytes": nbytes,
                        **bound(nbytes, flops)}
                    kernels[name].update(yardsticks(kernels[name]["ms"], nbytes, flush, device))
                    row.update({f"{name.lower()}_{k}": v for k, v in kernels[name].items()})
                dense = dict(cache=cache, q=q, w=w, qf=qf, ws=ws, nv=nv, si=si, vo=vo,
                             lib=lib, flops=flops, k_mags=k_mags, v_mags=v_mags, k_cs=k_cs)
            emit(row)
            del cache

    # the paged half at the main shape: the same rows under a shuffled table
    d = dense
    cache, q, w, qf, ws, nv = (d[k] for k in ("cache", "q", "w", "qf", "ws", "nv"))
    B, h_kv = cache.k.scale.shape[:2]
    BH, G = qf.shape[:2]
    pools = {}
    for page in (256, 512):
        paged = pools[page] = to_pool(cache, page, gen)
        table = paged.pages.page_table
        k_runs = tier_runs(paged.k, lambda a: a, True)
        v_runs = tier_runs(paged.v, lambda a: a, False)
        k6 = lambda fn=kpack_tier_scores_paged: [
            fn(*lv, qf[..., sl], table, nv, L, width=t.width, pack_size=t.pack_size,
               page_size=page) for t, lv, sl in k_runs]
        k7 = lambda fn=vpack_tier_out_paged: [
            fn(*lv, ws, table, nv, width=t.width, pack_size=t.pack_size,
               page_size=page) for t, lv, _ in v_runs]
        got6, again6, got7, again7 = k6(), k6(), k7(), k7()
        torch.cuda.synchronize()
        errs = {}
        for name, got, again, dn, want, mags, n_terms in (
                ("K6", got6, again6, d["si"], k6(kpack_tier_scores_paged_torch),
                 d["k_mags"], d["k_cs"]),
                ("K7", got7, again7, d["vo"], k7(vpack_tier_out_paged_torch),
                 d["v_mags"], [L] * len(got7))):
            errs[name] = 0.0
            for g, a, x, pw, m, n in zip(got, again, dn, want, mags, n_terms):
                check(torch.equal(g, a), f"page {page}: two {name} launches differ")
                check(torch.equal(g, x), f"page {page}: {name} differs from the "
                      "dense kernel on the gathered view")
                errs[name] = max(errs[name], within_bound(g, pw, m, n))
        n = cache.n_comp
        s_ops = lambda be="fused": ops.packed_qk_scores_paged(
            q, paged.k, paged.pages, L, sm, n_valid=n, backend=be)
        o_ops = lambda be="fused": ops.packed_weighted_v_paged(
            w, paged.v, paged.pages, n_valid=n, backend=be)
        torch.testing.assert_close(s_ops(), s_ops("ref"), **TOL)
        torch.testing.assert_close(o_ops(), o_ops("ref"), **TOL)
        check(torch.equal(s_ops(), ops.packed_qk_scores(q, cache.k, sm, n_valid=n))
              and torch.equal(o_ops(), ops.packed_weighted_v(w, cache.v, n_valid=n)),
              f"page {page}: paged entry points != dense ones")
        table_bytes = sum(-(-x // page) for x in LENGTHS) * h_kv * 4
        row = {"phase": "matvec_paged", "page_size": page, "B": B, "H_kv": h_kv,
               "G": G, "D": D, "n_tokens": L, "n_valid": list(LENGTHS),
               "bitwise_repeat": True, "bitwise_equal_dense_gathered": True,
               "launch": {"k6": tier_launches(True, cache.k.spec, G, L, LENGTHS, h_kv, True),
                          "k7": tier_launches(False, cache.v.spec, G, L, LENGTHS, h_kv, True)}}
        for name, fn, plain, entry, base in (
                ("K6", k6, lambda: k6(kpack_tier_scores_paged_torch), s_ops, "K3"),
                ("K7", k7, lambda: k7(vpack_tier_out_paged_torch), o_ops, "K4")):
            nbytes = kernels[base]["bytes"] + table_bytes
            numbers = {"max_abs_err": errs[name], "ms": time_ms(fn, flush),
                       "plain_ms": time_ms(plain, flush),
                       "library_ms": time_ms(d["lib"][base], flush),
                       "ops_ms": time_ms(entry, flush), "bytes": nbytes,
                       **bound(nbytes, d["flops"])}
            numbers.update(yardsticks(numbers["ms"], nbytes, flush, device))
            if page == 256:
                kernels[name] = numbers
            row.update({f"{name.lower()}_{k}": v for k, v in numbers.items()})
        emit(row)

    phase_matvec_wide(device, gen)

    # the slice's main path: the four entry points as a user calls them,
    # at the main shape (paged: pages of 256), counted from zero
    fns = (kpack_tier_scores, vpack_tier_out, kpack_tier_scores_paged,
           vpack_tier_out_paged)
    for f in fns:
        f.launches = 0
    paged = pools[256]
    scores = ops.packed_qk_scores(q, cache.k, sm, n_valid=cache.n_comp)
    out = ops.packed_weighted_v(torch.softmax(scores, -1), cache.v, n_valid=cache.n_comp)
    p_scores = ops.packed_qk_scores_paged(q, paged.k, paged.pages, L, sm,
                                          n_valid=cache.n_comp)
    p_out = ops.packed_weighted_v_paged(torch.softmax(p_scores, -1), paged.v,
                                        paged.pages, n_valid=cache.n_comp)
    torch.cuda.synchronize()
    counts = dict(zip(("K3", "K4", "K6", "K7"), (f.launches for f in fns)))
    check(all(c > 0 for c in counts.values()), f"a kernel of the path never ran: {counts}")
    check(bool(torch.isfinite(out).all() and torch.isfinite(p_out).all())
          and out.shape == (B, h_kv * G, D), "non-finite or misshapen outputs")
    check(torch.equal(out, p_out), "paged entry points != dense ones")
    for name, c in counts.items():
        kernels[name]["launches"] = c
    emit({"phase": "matvec_path", "launches": counts,
          "tiers": [len(cache.k.tiers), len(cache.v.tiers)]})
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "the port's kernels run only on the card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    logs = build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(build.LIBRARIES), "compiled": sorted(logs)})

    cfg = get_arch("llama2-7b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = get_model(cfg).init(gen, cfg)
    engine = Engine(cfg, params, get_policy("packkv"),
                    EngineConfig(capacity=2048, max_batch=4, decode_chunk=8,
                                 backend="fused", device="cuda",
                                 prefill_chunk_pages=0))
    emit({"phase": "engine", "seconds": time.perf_counter() - t0,
          "params": cfg.param_count(),
          "k_spec": [engine.pack_cfg.k_spec_static.widths,
                     engine.pack_cfg.k_spec_static.counts],
          "v_spec": [engine.pack_cfg.v_spec_static.widths,
                     engine.pack_cfg.v_spec_static.counts]})

    k2 = phase_kernel(engine, device)
    k5 = phase_kernel_paged(engine, device)
    serve = phase_serve(engine, cfg, device)
    serve_paged = phase_serve_paged(engine, cfg, serve)
    mv = phase_matvec(engine, device)
    print(card, flush=True)
    row = lambda name, source, replaces, k, launches: {
        "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": k["library_ms"]}
    emit({"kernels": [
        row("fused_packed_attention", "packed_attention.cu",
            "src/repro/kernels/packed_attention.py:172", k2, serve["launches"]),
        row("fused_packed_attention_paged", "packed_attention.cu",
            "src/repro/kernels/packed_attention.py:375", k5, serve_paged["launches"]),
        row("kpack_tier_scores", "tier_matvec.cu",
            "src/repro/kernels/kpack_matvec.py:69", mv["K3"], mv["K3"]["launches"]),
        row("vpack_tier_out", "tier_matvec.cu",
            "src/repro/kernels/vpack_matvec.py:64", mv["K4"], mv["K4"]["launches"]),
        row("kpack_tier_scores_paged", "tier_matvec.cu",
            "src/repro/kernels/kpack_matvec.py:154", mv["K6"], mv["K6"]["launches"]),
        row("vpack_tier_out_paged", "tier_matvec.cu",
            "src/repro/kernels/vpack_matvec.py:145", mv["K7"], mv["K7"]["launches"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
