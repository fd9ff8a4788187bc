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
     rtol=1e-5, atol=1e-4 and two launches bitwise equal. Timed with CUDA events (L2
     flushed before each run, median of 20) beside the plain version, the
     byte bound and scaled_dot_product_attention over the dequantized bf16
     K/V (the uncompressed yardstick; the port never calls it).
  3. serve - llama2-7b at full width (32 layers, random bf16 weights from a
     seeded torch.Generator) through Engine + SlotServer: policy packkv,
     capacity 2048, 4 slots, decode_chunk 8, backend "fused"; 6 requests of
     prompt lengths {320, 700, 1000, 450, 260, 900} and 160 new tokens each
     (every row flushes its residual, slots are reused). The launch count
     must equal n_layers x decode steps; outputs must be finite and in the
     vocabulary. Reports decode tok/s, compressed bytes per token against
     bf16, and each request's agreement with the port's own B=1 generate
     (not a pass bar: batched and B=1 GEMMs may round differently).

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, L2 flushed before
    each (a decode step finds each layer's cache cold)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
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


def kernel_bytes(cache, n_rows, G: int) -> int:
    """Bytes K2 must move for these live counts: compressed payload, pack
    metadata and f32 scale/zero of each live token, the permutations, q
    and the outputs."""
    k, v = cache.k, cache.v
    h_kv, D = k.scale.shape[1], k.spec.head_dim
    total = 0
    for n in n_rows:
        for spec in (k.spec, v.spec):
            P = n // spec.pack_size
            for w, c in zip(spec.widths, spec.counts):
                total += h_kv * c * (n * w // 8 + P + (P + 3) // 4)
            total += h_kv * n * 8  # scale + zero, f32
    B = len(n_rows)
    total += B * h_kv * (2 * D * 4)  # chan_perm K and V
    total += B * h_kv * G * (D * 4 + v.spec.head_dim * 4 + 8)  # q, o, m, l
    return total


def kernel_flops(cache, n_rows, G: int) -> int:
    k = cache.k
    h_kv, D, Dv = k.scale.shape[1], k.spec.head_dim, cache.v.spec.head_dim
    return sum(n for n in n_rows) * h_kv * G * (2 * D + 2 * Dv + 8)


def phase_kernel(engine, device) -> dict:
    import torch

    from repro_torch.core import cache as tc
    from repro_torch.core.tiered import TierSpec, dequantize_tiered
    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_torch,
    )

    gen = torch.Generator(device=device).manual_seed(1)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    calibrated = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    specs = {
        "calibrated": calibrated,
        "w1248": (TierSpec((1, 2, 4, 8), (32, 32, 32, 32)),) * 2,
        "w16": (TierSpec((4, 16), (96, 32)),) * 2,
    }
    shapes = [("llama2-7b", 4, 32, 1), ("gqa", 4, 8, 4)]
    lengths = (0, 64, 1344, 2048)
    D, L = 128, 2048
    main = None
    for sname, (ks, vs) in specs.items():
        for shape, B, h_kv, G in shapes:
            if sname != "calibrated" and shape != "llama2-7b":
                continue
            cfg = tc.PackKVConfig(k_spec_static=ks, v_spec_static=vs)
            cache = tc.alloc_layer_cache(cfg, B, h_kv, D, L, device=device)
            for r, n in enumerate(lengths):
                if n:
                    tc.insert_prefill(cache, r, kv_like(gen, h_kv, n, D, device),
                                      kv_like(gen, h_kv, n, D, device))
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
            # m and l as they are; o after dividing by l (the region's
            # attention output): the unnormalized acc and zsum terms reach
            # ~1e2 over 2048 tokens and cancel in acc + zsum, so f32 sums in
            # another order leave ~1e-4 absolute differences on o itself
            for g, w in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, w, **TOL)
            norm = lambda o, l: o / torch.clamp(l, min=1e-30)[..., None]
            torch.testing.assert_close(norm(got[0], got[2]), norm(want[0], want[2]), **TOL)
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
                   "max_abs_err": err, "bitwise_repeat": True, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            emit(row)
            if main is None:
                main = row
            del cache, kd, vd
    return main


def phase_serve(engine, cfg, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.tiered import tiered_bits_per_value
    from repro_torch.kernels.packed_attention import fused_packed_attention
    from repro_torch.serving import Request, SlotServer

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (320, 700, 1000, 450, 260, 900)]
    server = SlotServer(engine)
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, tokens=p, max_new=160))
    # record each row's compressed length as it retires
    retired, free_slot = [], engine.free_slot
    engine.free_slot = lambda cache, slot: (
        retired.append(int(cache[0].n_comp[slot])), free_slot(cache, slot))[1]
    fused_packed_attention.launches = 0
    t0 = time.perf_counter()
    done = {r.rid: r for r in server.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_packed_attention.launches
    s = server.stats
    check(len(done) == len(prompts), "not every request finished")
    check(launches > 0 and launches == cfg.n_layers * s.decode_steps,
          f"fused launches {launches} != {cfg.n_layers} x {s.decode_steps} steps")
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
           "decode_steps": s.decode_steps, "fused_launches": launches,
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
    return {"launches": launches}


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
                                 backend="fused", device="cuda"))
    emit({"phase": "engine", "seconds": time.perf_counter() - t0,
          "params": cfg.param_count(),
          "k_spec": [engine.pack_cfg.k_spec_static.widths,
                     engine.pack_cfg.k_spec_static.counts],
          "v_spec": [engine.pack_cfg.v_spec_static.widths,
                     engine.pack_cfg.v_spec_static.counts]})

    k = phase_kernel(engine, device)
    serve = phase_serve(engine, cfg, device)
    print(card, flush=True)
    emit({"kernels": [{
        "name": "fused_packed_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/packed_attention.cu",
        "replaces": "src/repro/kernels/packed_attention.py:172",
        "launches": serve["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
