#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device - the card's name and power limit (nvidia-smi), torch and CUDA
     versions; then every CUDA kernel is built from csrc/ with nvcc.
  1b. storage (after the llama2-7b engine is built) - the paper's storage
     tier, which runs no kernel of its own: every 64-token block of the
     model's K/V (one 512-token random prompt prefilled with policy none
     on dense storage, 32 layers x 32 kv heads, head dim 128: 8,192
     blocks; 1024 tokens before PR 26) and of synthetic_kv at the same shape (the llama2-7b-like
     profile, made by two worker processes meanwhile) quantized token-wise
     (K rel 0.1, V rel 0.2), repacked (none, median_v, greedy_joint) and
     bit-packed in pack 8 by CompressedKVStream.extend on the card. Checks:
     unpack(pack(q)) == q and |x - decode| <= scale / 2 (plus the f32
     rounding of x - lo and the quotient) at every value; the payload bits
     of a re-encode equal the stream's; blocks 0-1 of every head of layers
     0 and 31 (128 blocks) bitwise equal to the plain CPU path (append, a
     block at a time: perm, scale / zero, widths, minima, words and the
     serialized stream with its directory) for median_v and greedy_joint.
     Reports the K, V and joint ratios beside KIVI's analytic ratio at the
     same rel scale and the gain over it, the storage bytes a token beside
     the compute tier's and bf16's, extend's and the encode's device ms
     (CUDA events), blocks a second, and the sample's plain CPU time.
  2. kernel - the fused compressed-cache attention kernel (K2) against its
     plain PyTorch version on the card, at llama2-7b decode shapes (B=4,
     H_kv=32, G=1, D=128, L=2048, ragged n_comp {0, 64, 1344, 2048}) under
     the serving engine's calibrated spec, a (1,2,4,8) spec and a width-16
     spec, and under the calibrated specs at a GQA shape (H_kv=8, G=4), at
     qwen3-32b's (H_kv=8, G=8, D=128) and at smollm-135m's (H_kv=3, G=3,
     D=64; smollm-135m's own calibrated spec): m, l and o / l within
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
     of one; the qwen3-32b and smollm-135m shapes at 64 and 256): against
     its plain version (same tolerances), bitwise against K2 on the
     gathered dense view, and bitwise against itself; timed at pages 256
     (and 512) as K2 is, with the byte bound counting the page-table reads
     too. Both kernel phases also run the serving mesh's lane shapes under
     llama2-7b's calibrated spec: H_kv = 16 and 8 (llama2-7b over 2 and 4
     kv lanes) and H_kv = 2, G = 3 (minitron-4b over 4).
  4. serve - llama2-7b at full width (32 layers, random bf16 weights from a
     seeded torch.Generator) through Engine + SlotServer: policy packkv,
     capacity 2048, 4 slots, decode_chunk 8, backend "fused", dense
     storage, monolithic admission; 6 requests of prompt lengths {320,
     700, 1000, 450, 260, 900} and 160 new tokens each (every row flushes
     its residual, slots are reused). K2's launch count must equal
     n_layers x decode steps; outputs must be finite and in the
     vocabulary. Reports decode tok/s, compressed bytes per token against
     bf16, and each request's agreement with the port's own B=1 generate
     over its first 32 tokens (not a pass bar: batched and B=1 GEMMs may
     round differently).
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
  6. serve_spec - speculative decode (spec_k 4: verify passes over windows
     of 5) on the serve phases' engines and requests, 32 new tokens each
     (cut from 160 to pay for later phases), in four runs: dense with the default n-gram drafter, dense with
     a drafter replaying the serve phase's outputs with every third
     proposal wrong (full, partial and zero acceptance), dense with a
     drafter always wrong (zero acceptance: the backoff), paged (the
     14-page pool) replaying serve_paged's outputs likewise. Every
     request's tokens must equal its plain phase's bitwise; every run must
     verify at least once; K2's (paged: K5's) launches must equal n_layers
     x (plain steps + 5 x verify passes) and the other kernel's be 0; the
     replay runs must accept some drafts but not all, the wrong drafter
     none. Reports decode tok/s beside the plain phase's, acceptance,
     tokens per model pass, degraded steps and the launches that tripped
     the straggler watchdog, wall time; then (spec_rows) the plain path's
     cost of its GEMMs at the window's height: a step's GEMM device time
     at B and B x 5 rows, and the steady wall ms per step at spec_k 0
     (rows 1) and 4 (rows 5), in turns.

  7. matvec - the tier matvec entry points (packed_qk_scores,
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
  8. serve_configs - smollm-135m, minicpm-2b and minitron-4b at full width
     and depth (random bf16 weights), one after another, each freed before
     the next: dense storage, policy packkv, backend "fused", 4 slots,
     capacity 2048, monolithic admission, 4 requests of 32 new tokens. K2's
     launch count must equal n_layers x decode steps and K5's be 0; outputs
     in the vocabulary. Reports decode tok/s and compressed bytes per token
     against bf16.
  9. serve_prefix - the llama2-7b engine freed, qwen3-32b at full width and
     depth (64 layers, d_model 5120, 64 heads over 8 kv heads, hd 128,
     qk-norm, vocab 151936; 65.5 GB of bf16 weights) through paged storage
     (pages of 256) with the prefix cache, chunked admission (one page a
     step), capacity 2048, 4 slots: 6 requests, each a shared 512-token
     system prompt and a suffix of {320, 700, 200, 450, 260, 900} tokens,
     32 new tokens each. K5's launch count must equal n_layers x decode
     steps and K2's be 0; 6 lookups, at least 4 hits, 2 pages shared per
     hit; the reserved peak within the suffix-only bound; refcounts
     conserved (free <=> ref == 0) in every layer at the end; every hit's
     admission (last-token logits and the whole mini-cache it scatters)
     and its 64 tokens bitwise equal to a cold admission of the same
     request on a fresh server over the same engine. Reports decode tok/s,
     wall time, peak device memory and compressed bytes per token.

  10. serve_preempt (after spec_rows, on the llama2-7b weights and
     calibrated specs, chunked admission of one page a step) - four class-1
     requests (prompts 320/700/1000/450, 128 new tokens), then, once all
     four decode, two class-0 requests (260 and 900, 16 new tokens) that
     must swap class-1 rows out to host memory: dense; paged with the
     prefix cache (the class-1 prompts open with one 512-token system
     prompt); paged at 5 slots on a pool one page short of a class-0
     arrival. Every request bitwise equal to the same run with preemption
     off, >= 2 preemptions (>= 1 under page pressure), swapped == restored
     pages, pools clean after the run, K2/K5 once a layer and decode step.
     Reports each swapped row's bytes, the swap store's peak, evacuate /
     host copy / restore ms (CUDA events), decode tok/s beside the
     control's.
  11. serve_session - two conversations (prompts 700 and 1000, 16 new
     tokens a turn, a 16-token extension a returning turn; the second takes
     three turns), dense and paged, the host tier sized at 1.5x the first
     parked row so a park spills to disk and loads back: every turn
     bitwise equal to the hand-driven chain on a session-off engine (the
     same max_batch and spec_k), 3 hits with no prefill chunk, spills and
     loads >= 1. Reports parked bytes, save_mini / load_mini / restore ms,
     and the returning 748-token turn's time to first token beside a cold
     admission of the same prompt on a fresh server.
  12. serve_faults - the paged prefix engine with sessions and preemption,
     8 requests, a FaultPlan of 12 events of every kind over 34 steps: the
     run drains, references conserved after every admit and retire, no
     page leaked, every request no fault touched bitwise equal to a
     fault-free control.
  12b. serve_mesh - the (dp, kv) serving mesh on this one card, every
     lane on cuda:0: (a) llama2-7b dense, monolithic, mesh (1, 2): K2 at
     H_kv = 16; (b) llama2-7b paged (the 14-page pool), chunked, mesh
     (2, 2): K5 at H_kv = 16 with the dp row masks; (c) minitron-4b
     (32 layers, 24 heads over 8 kv heads, hd 128) dense, monolithic,
     mesh (1, 4): K2 at H_kv = 2, G = 3, freed before serve_prefix. The 6
     prompts of serve, 16 new tokens, 4 slots: every request bitwise equal
     to its (1, 1) control (a, b: the serve / serve_paged phases' first 16
     tokens; c: a (1, 1) run here), K2 / K5 launched once a lane, layer
     and decode step and the other kernel never, every lane's page ledger
     and counters equal to lane (0, 0)'s. Reports decode tok/s, the wall
     ms a step of steady launches beside the control's (in turns), the
     device bytes a token a lane and summed, and the peak memory.

  13. serve_moe (after serve_prefix, qwen3-32b freed) - qwen2-moe-a2.7b at
     full width and depth (24 layers, d_model 2048, 16 heads over 16 kv
     heads, 60 routed experts top-4 and 4 shared, Fe 1408, vocab 151936;
     28.6 GB of bf16), policy packkv, capacity 2048, 4 slots: 6 requests
     (prompts 320/700/1000/450/260/900, 16 new tokens) in four runs: (a)
     dense, chunked admission: K2 == n_layers x decode steps, K5 == 0; (b)
     paged (pages of 256), chunked: every token bitwise equal to (a), K5
     == n_layers x decode steps, K2 == 0; (c) dense, spec_k 4, the replay
     drafter: every request no verify pass dropped a routed choice of
     bitwise equal to (a), at least one such request; (d) dense,
     monolithic admission: its agreement with (a) reported only (C
     follows the chunk's length in one and the prompt's in the other).
     Then one prefill chunk, one prefill and one decode step with the
     routing log keeping tensors: the card's top-k indices, positions,
     keep mask and slots equal the CPU's from the same logits (a tie
     within 1e-6 counted). Reports decode tok/s, C and dropped choices per
     call site, compressed bytes per token (the paper's count and the
     device's), peak memory. Then, qwen2-moe freed, moonshot-v1-16b-a3b
     at full width and depth (48 layers, 64 experts top-6 and 2 shared,
     vocab 163840; 57.8 GB), dense, monolithic, 4 requests of 16 new
     tokens: K2 == n_layers x decode steps, outputs in the vocabulary.
  14. serve_vlm - internvl2-2b at full width and depth (24 layers, 8 kv
     heads, G 2): Engine.generate at B=2 over 256 random patch embeddings
     before 512 text tokens, 32 new tokens: K2 == n_layers x decode steps,
     finite prefill logits, the cache holding patches + tokens + steps.
  15. encode - hubert-xlarge at full width and depth (48 layers, d_model
     1280): encode of 2 x 1024 random frames: [2, 1024, 1280], finite;
     one call's device time by CUDA events.

  16. serve_rwkv - rwkv6-1.6b at full width and depth (24 layers, d_model
     2048, 32 WKV heads of 64, vocab 65,536): SlotServer, 4 slots, chunked
     admission (pages of 256), 6 requests (prompts 320/700/1000/450/260/
     900, four with a sub-chunk WKV tail), 16 new tokens each: every
     request bitwise equal to its solo control at the server's height
     (``solo``), the same traffic through monolithic admission bitwise
     equal, and one 1000-token admission's logits and state row equal
     chunked and monolithic. No kernel (no KV cache).
  17. serve_rglru - recurrentgemma-9b at full width and depth (38 layers,
     d_model 4096, 16 heads over 1 kv head of 256, window 2048, LRU width
     4096, vocab 256,000), policy packkv calibrated over the window, 4
     slots, chunked admission: 5 requests (prompts 2048/700/450/900/260,
     200 new tokens for the first, whose window rings flush twice over
     their oldest blocks, 16 for the others): K2 once an attention layer
     and decode step at G = 16, D = 256; each request bitwise equal to its
     solo control; the 2048-token admission chunked == monolithic
     bitwise. Then K2 and K5 (pages 64 and 256) at that decode shape under
     the calibrated spec, held and timed as in the kernel phases.
  18. train - minicpm-2b trained at full width and depth (40 layers,
     d_model 2304, 36 heads of 64, d_ff 5760, vocab 122,753; random bf16
     weights from a seeded torch.Generator): 8 steps of 4 x 1024 tokens
     from ShardedTokenStream, AdamW under the config's WSD schedule
     (warmup 1, lr 1e-3), grad_accum 1, a checkpoint a layer. Checks:
     every loss and grad norm finite, the last loss below the first, each
     step's lr within an f32 ulp of the plain f32 formula. Reports the
     losses, grad norms, step ms, tokens a second, 6 N T / step time as a
     share of the bf16 peak and the peak memory. No kernel of csrc/.
  19. train_launch - smollm-135m at full width through
     ``launch.train.main``: 10 steps of 8 x 256 tokens at grad_accum 2
     under WSD (40 before PR 26), checkpoints every 5 steps into a
     temporary directory; the same run preempted after 5 steps and
     resumed: the two step-10
     checkpoints bitwise equal leaf for leaf (parameters, moments, step);
     then one step at grad_accum 1 against one at 2 from the same
     parameters: the loss within 1e-3, every parameter within 5e-3.
  20. train_dp - smollm-135m at full width and depth trained data-parallel
     by two spawned ranks that share cuda:0 over gloo (NCCL takes one rank
     a card), ZeRO-1 moments: two steps of 8 x 256 tokens, each rank on
     its 4 rows, gradients gathered and added in rank order. Checks: every
     rank's losses, grad norms, step, parameters and (gathered) moments
     bitwise equal to this process's grad_accum 2 run from the same seed
     (sha256 of each leaf's bytes). Reports each rank's step ms, peak
     memory, and the exchange's ms (one step's gradients summed in rank
     order, timed alone). No kernel of csrc/.

Each phase's seconds follow it on a line of their own ("phase_seconds"),
and the total before the card's line. Then the kernels line (K2's
launches summed over the dense serve phases, serve_spec's,
serve_preempt's, serve_session's, serve_mesh's, serve_moe's,
serve_vlm's and serve_rglru's dense runs included, K5's over the paged,
paged speculative, prefix, paged preempt, session, fault, serve_mesh and
serve_moe paged ones) and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
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


T_START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(phase, *args):
    """Run ``phase(*args)``; print its seconds on a line of their own."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase_seconds": phase.__name__.removeprefix("phase_"),
          "s": time.perf_counter() - t0})
    return out


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


# the kernel phases' decode shapes (name, B, H_kv, G, D) over a 2048-token
# bucket, with ragged live counts (an empty row among them): llama2-7b's,
# a GQA one, and those of the other dense configs' serving (qwen3-32b's
# G = 8; smollm-135m's G = 3 at head dim 64)
SHAPES = [("llama2-7b", 4, 32, 1, 128), ("gqa", 4, 8, 4, 128),
          ("qwen3-32b", 4, 8, 8, 128), ("smollm-135m", 4, 3, 3, 64),
          # serve_mesh's lanes: llama2-7b over 2 and 4 kv lanes, minitron-4b over 4
          ("llama2-7b-lane16", 4, 16, 1, 128), ("llama2-7b-lane8", 4, 8, 1, 128),
          ("minitron-4b-lane2", 4, 2, 3, 128)]
MATVEC_SHAPES = SHAPES[:2]  # the tier matvecs' shapes (K3/K4 at D=64: GPU tests)
LENGTHS = (0, 64, 1344, 2048)


def kernel_specs(engine) -> dict:
    """The (K, V) tier specs the kernel phases run at D=128: the serving
    engine's calibrated one, a (1,2,4,8) one and a width-16 one."""
    from repro_torch.core.tiered import TierSpec

    return {
        "calibrated": (engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static),
        "w1248": (TierSpec((1, 2, 4, 8), (32, 32, 32, 32)),) * 2,
        "w16": (TierSpec((4, 16), (96, 32)),) * 2,
    }


def calibrated(engines: dict, D: int):
    """The calibrated (K, V) specs at head dim D: llama2-7b's engine at
    128, smollm-135m's at 64."""
    eng = engines[D]
    return eng.pack_cfg.k_spec_static, eng.pack_cfg.v_spec_static


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
    gm = next(m for m in (1, 2, 4, 8, 16) if G <= m)  # the instantiation's group bound
    key = f"packed_attention_span_kernel<{str(paged).lower()},{gm}>"
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


def k2_row(sname: str, shape: str, B: int, h_kv: int, G: int, D: int, ks, vs,
           gen, flush) -> dict:
    """K2 at one decode shape (2048-token bucket, the ragged LENGTHS) and
    one (K, V) spec: held against its plain versions (tile loop and split
    structure), bitwise equal to itself and over a 1024-token bucket view,
    timed beside the plain version, the byte bound and SDPA over the
    dequantized cache. Emits and returns the row."""
    import torch

    from repro_torch.core import cache as tc
    from repro_torch.core.tiered import dequantize_tiered
    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_split_torch,
        fused_packed_attention_torch,
    )

    device = gen.device
    lengths = LENGTHS
    L = 2048
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
    # a 1024-token bucket view == the full 2048 capacity, bitwise, when
    # every row's count fits the bucket
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
    return row


def phase_kernel(engines: dict, device) -> dict:
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    main = None
    for sname in kernel_specs(engines[128]):
        for shape, B, h_kv, G, D in SHAPES:
            if sname != "calibrated" and shape != "llama2-7b":
                continue
            ks, vs = (calibrated(engines, D) if sname == "calibrated"
                      else kernel_specs(engines[128])[sname])
            row = k2_row(sname, shape, B, h_kv, G, D, ks, vs, gen, flush)
            if main is None:
                main = row
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


def k5_rows(shape: str, B: int, h_kv: int, G: int, D: int, ks, vs, pages,
            gen, flush) -> dict:
    """K5 at one decode shape over the ragged LENGTHS under a calibrated
    spec, the cache scattered into a pool of each page size of ``pages``
    under a shuffled page table: held against its plain version, bitwise
    equal to itself and to K2 on the gathered dense view; timed at pages
    256 and 512 as K2 is. Emits each row; returns the page-256 row."""
    import torch

    from repro_torch.core import cache as tc
    from repro_torch.core.tiered import dequantize_tiered
    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
        fused_packed_attention_paged_torch,
    )

    device = gen.device
    L = 2048
    lengths = LENGTHS
    sdpa = torch.nn.functional.scaled_dot_product_attention
    main = None
    cache = ragged_cache(ks, vs, B, h_kv, D, L, lengths, gen)
    q = torch.randn((B, h_kv * G, D), generator=gen, device=device)
    sm = D ** -0.5
    n = cache.n_comp
    kd = dequantize_tiered(cache.k, torch.bfloat16).transpose(-1, -2)
    vd = dequantize_tiered(cache.v, torch.bfloat16).transpose(-1, -2)
    kd, vd = (x.repeat_interleave(G, dim=1).contiguous() for x in (kd, vd))
    qb = q.to(torch.bfloat16)[:, :, None, :]
    for page in pages:
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
            check(torch.equal(g, a), f"{shape}, page {page}: two K5 launches differ")
            check(torch.equal(g, d), f"{shape}, page {page}: K5 != K2 on the gathered view")
            err = max(err, float((g - w).abs().max()))
        held_to(got, want)
        check(bool((got[0][0] == 0).all() and (got[1][0] == -1e30).all()
                   and (got[2][0] == 0).all()),
              "the empty row's partials are not o = 0, m = -1e30, l = 0")
        row = {"phase": "kernel_paged", "shape": shape, "page_size": page, "B": B,
               "H_kv": h_kv, "G": G, "D": D, "n_tokens": L, "n_comp": list(lengths),
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


def phase_kernel_paged(engines: dict, device) -> dict:
    import torch

    gen = torch.Generator(device=device).manual_seed(2)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    main = None
    for shape, B, h_kv, G, D in SHAPES:
        if shape == "gqa":
            continue
        ks, vs = calibrated(engines, D)
        # llama2-7b: every page size, timed at 256 and 512; the other
        # configs' shapes: pages of 64 and 256, timed at 256
        pages = (64, 128, 256, 512) if shape == "llama2-7b" else (64, 256)
        row = k5_rows(shape, B, h_kv, G, D, ks, vs, pages, gen, flush)
        if main is None:
            main = row
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


AGREE_NEW = 32  # serve's B=1 generate controls: the first 32 of 160 tokens


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
    # per-request agreement with the port's own B=1 generate over the first
    # AGREE_NEW tokens (reported, not a check)
    agree = []
    for rid, r in sorted(done.items()):
        gen, _ = engine.generate({"tokens": r.tokens[None]}, AGREE_NEW)
        out = np.asarray(r.output)[:AGREE_NEW]
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
            "outputs": {rid: np.asarray(r.output) for rid, r in done.items()},
            "decode_tok_s": decode_tokens / s.decode_s,
            "tokens_per_step": decode_tokens / s.decode_steps}


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


def steady_step_ms(engines: dict, cfg, launches: int = 2) -> dict:
    """Wall milliseconds per decode step of steady launches (4 rows of 700
    tokens, 8 steps a launch, ``launches`` launches a turn after a warm-up
    one, no flush in the window), the engines taken in turns A, B, B, A in
    this one process (host time varies between processes and machines)."""
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
    return {"launches": launches, "engine": paged,
            "outputs": {rid: np.asarray(r.output) for rid, r in done.items()},
            "decode_tok_s": decode_tokens / s.decode_s,
            "tokens_per_step": decode_tokens / s.decode_steps}


class ReplayDrafter:
    """Proposes a plain run's own continuation of each request with every
    ``corrupt``-th proposal made wrong (``corrupt`` 3: full, partial and
    zero acceptance; 1: every proposal wrong). Draft content moves only
    the acceptance, never the tokens."""

    def __init__(self, outputs: dict, vocab: int, corrupt: int):
        self.outputs = outputs  # {tuple(prompt): plain output tokens}
        self.vocab, self.corrupt = vocab, corrupt
        self.pos: dict[int, list] = {}

    def seed(self, slot, tokens):
        toks = tuple(int(t) for t in tokens)
        self.pos[slot] = [self.outputs[toks[:-1]], 1]

    def extend(self, slot, tokens):
        self.pos[slot][1] += len(tuple(tokens))

    def drop(self, slot):
        self.pos.pop(slot, None)

    def draft(self, slot, k):
        stream, cur = self.pos[slot]
        return [(int(t) + 1) % self.vocab if (cur + j) % self.corrupt == 0 else int(t)
                for j, t in enumerate(stream[cur:cur + k])]


SPEC_K = 4  # drafts a verify pass: windows of 5 (EngineConfig's default)
SPEC_NEW = 32  # new tokens a request: the first 32 of the plain phases' 160


def phase_serve_spec(engine, cfg, dense: dict, paged: dict) -> dict:
    """Speculative decode on the serve phases' engines and requests, in
    four runs (dense: the n-gram drafter, the replay drafter with every
    third proposal wrong, a drafter always wrong; paged: the replay
    drafter): every request's tokens bitwise equal to its plain phase's,
    K2 (K5) launched n_layers x (plain steps + 5 x verify passes) times
    and the other kernel never, acceptance within the run's range.

    Cut to pay for later phases: 32 new tokens a request (the plain
    phases ran 160; the first 32 are compared)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.serving import Engine, Request, SlotServer

    prompts = serve_prompts(cfg)
    w = SPEC_K + 1
    total = {"dense": 0, "paged": 0}
    runs = [("ngram", "dense", None), ("replay", "dense", 3), ("wrong", "dense", 1),
            ("replay", "paged", 3)]
    for drafter_name, mode, corrupt in runs:
        base = engine if mode == "dense" else paged["engine"]
        plain = dense if mode == "dense" else paged
        check(base.ecfg.spec_k == SPEC_K, "the plain engine's GEMM height differs")
        spec = Engine(cfg, base.params, base.pack_cfg, dataclasses.replace(
            base.ecfg, calibrate=False, spec_decode=True, spec_k=SPEC_K))
        outputs = {tuple(int(t) for t in p): plain["outputs"][i] for i, p in enumerate(prompts)}
        drafter = None if corrupt is None else ReplayDrafter(outputs, cfg.vocab, corrupt)
        server = SlotServer(spec, drafter=drafter)
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, tokens=p, max_new=SPEC_NEW))
        # each launch the watchdog reads: (wall s, a verify pass?, verdict)
        launches, observe = [], server._watchdog.observe

        def observed(dt):
            verdict = observe(dt)
            n = server.stats.spec_launches
            launches.append((dt, n > sum(v for _, v, _ in launches), verdict))
            return verdict

        server._watchdog.observe = observed
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        t0 = time.perf_counter()
        done = {r.rid: r for r in server.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = server.stats
        k2, k5 = fused_packed_attention.launches, fused_packed_attention_paged.launches
        used, unused = (k2, k5) if mode == "dense" else (k5, k2)
        want = cfg.n_layers * (s.decode_steps - s.spec_launches + w * s.spec_launches)
        tag = f"serve_spec {mode} {drafter_name}"
        check(len(done) == len(prompts), f"{tag}: not every request finished")
        for rid, r in done.items():
            check(np.array_equal(np.asarray(r.output), plain["outputs"][rid][:SPEC_NEW]),
                  f"{tag}: request {rid} differs from plain decode")
        check(s.spec_launches > 0, f"{tag}: no verify pass ran")
        check(used == want and unused == 0,
              f"{tag}: attention launches {used} (other {unused}) != {want}")
        if drafter_name == "replay":
            check(0 < s.spec_accepted < s.spec_drafted,
                  f"{tag}: accepted {s.spec_accepted} of {s.spec_drafted}")
        if drafter_name == "wrong":
            check(s.spec_accepted == 0, f"{tag}: accepted {s.spec_accepted}")
        # the launches that tripped the watchdog, beside the median before them
        flagged = [{"launch": i, "s": dt, "verify_pass": v, "verdict": vd,
                    "median_before_s": statistics.median(
                        [d for d, _, _ in launches[max(0, i - 32):i]] or [dt])}
                   for i, (dt, v, vd) in enumerate(launches) if vd in ("straggler", "exclude")]
        decode_tokens = s.tokens_out - s.admitted
        emit({"phase": "serve_spec", "mode": mode, "drafter": drafter_name,
              "spec_k": SPEC_K, "requests": len(prompts), "max_new": SPEC_NEW,
              "decode_steps": s.decode_steps, "verify_passes": s.spec_launches,
              "plain_steps": s.decode_steps - s.spec_launches,
              "drafted": s.spec_drafted, "accepted": s.spec_accepted,
              "acceptance_rate": s.acceptance_rate,
              "tokens_per_pass": decode_tokens / s.decode_steps,
              "degraded_steps": s.degraded_steps, "degraded": server._spec_degraded,
              "watchdog_flags": flagged[:8],
              "k2_launches": k2, "k5_launches": k5, "wall_s": wall, "decode_s": s.decode_s,
              "decode_tok_s": decode_tokens / s.decode_s,
              "plain_decode_tok_s": plain["decode_tok_s"],
              "plain_tokens_per_step": plain["tokens_per_step"]})
        total[mode] += used
        del server, done, spec
    return total


def phase_spec_rows(engine, cfg) -> None:
    """The plain path's cost of running its GEMMs at the verify window's
    height: a decode step's GEMM device time at B rows and at B x 5 (each
    of llama2-7b's products timed on layer 0's weights, L2 flushed: a
    step reads every weight once, cold), and the steady wall ms per step
    of an engine at spec_k 0 (rows 1) against the serving engine's spec_k
    4 (rows 5), in turns A B B A in this one process."""
    import dataclasses

    import torch

    from repro_torch.serving import Engine

    B, w = engine.ecfg.max_batch, SPEC_K + 1
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=engine.device)
    flush = lambda: flush_buf.zero_()
    lp = engine.params["layers"]
    mats = [(lp[g][n][0], cfg.n_layers) for g, n in (
        ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
        ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))]
    mats.append((engine.params["head"], 1))
    gen = torch.Generator(device=engine.device).manual_seed(3)
    gemm = {}
    for rows in (1, w):
        total = 0.0
        for W, count in mats:
            x = torch.randn((B, rows, W.shape[0]), generator=gen,
                            device=engine.device).to(torch.bfloat16)
            total += count * time_ms(lambda: x @ W, flush)
        gemm[f"rows_{rows}"] = total
    rows1 = Engine(cfg, engine.params, engine.pack_cfg,
                   dataclasses.replace(engine.ecfg, calibrate=False, spec_k=0))
    steady = steady_step_ms({"rows_1": rows1, f"rows_{w}": engine}, cfg)
    emit({"phase": "spec_rows", "B": B, "gemm_ms_per_step": gemm,
          "steady_ms_per_step": steady,
          "steady_median_ms": {k: statistics.median(v) for k, v in steady.items()}})


# serve_preempt / serve_session / serve_faults: llama2-7b at full width and
# depth on the serve phases' weights and calibrated specs, chunked
# admission of one page a step
PREEMPT_LOW = (320, 700, 1000, 450)  # class 1
PREEMPT_HIGH = (260, 900)  # class 0, arriving once every class-1 row decodes
PREEMPT_LOW_NEW, PREEMPT_HIGH_NEW = 128, 16
PREEMPT_SYS = 512  # the paged prefix run's shared system prompt


def slot_engine(engine, cfg, **ekw):
    """An engine over ``engine``'s weights and calibrated specs (no second
    calibration): capacity 2048, 4 slots, decode_chunk 8, backend fused,
    chunked admission of one page a step."""
    from repro_torch.serving import Engine, EngineConfig

    kw = dict(capacity=2048, max_batch=4, decode_chunk=8, backend="fused",
              device=engine.ecfg.device, calibrate=False, prefill_chunk_pages=1)
    return Engine(cfg, engine.params, engine.pack_cfg, EngineConfig(**{**kw, **ekw}))


def device_timed(obj, name: str, log: list, size=None) -> None:
    """Wrap ``obj.name`` so each call appends (ms between CUDA events
    recorded around it, synchronized, so its host copies are included;
    with ``size``, ``size(args)`` bytes)."""
    import torch

    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        b.synchronize()
        log.append((a.elapsed_time(b), size(args) if size else None))
        return out

    setattr(obj, name, wrapper)


def host_timed(obj, name: str, log: list) -> None:
    """Wrap ``obj.name`` so each call appends its wall ms (host-only work:
    the disk serializers)."""
    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log.append(((time.perf_counter() - t0) * 1e3, None))
        return out

    setattr(obj, name, wrapper)


def mini_bytes(mini) -> int:
    from repro_torch.utils import leaf_nbytes, tree_flatten

    return sum(leaf_nbytes(x) for x in tree_flatten(mini)[0])


def served(server, launch_mode: str, cfg, drive=None) -> int:
    """Drain ``server`` (``drive()``, default ``server.run()``), counting
    launches from 0: K2 (dense) or K5 (paged) must have launched once a
    layer and decode step, the other never. Returns the launches."""
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )

    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    steps0 = server.stats.decode_steps
    (drive or server.run)()
    torch.cuda.synchronize()
    k2, k5 = fused_packed_attention.launches, fused_packed_attention_paged.launches
    used, unused = (k2, k5) if launch_mode == "dense" else (k5, k2)
    want = cfg.n_layers * (server.stats.decode_steps - steps0)
    check(used == want and unused == 0,
          f"{launch_mode}: attention launches {used} (other {unused}) != {want}")
    return used


def pool_clean(server, what: str) -> None:
    """After a drained run: every layer's pool free but the index's pages,
    references conserved (free <=> ref == 0)."""
    held = server._index.n_held if server._index is not None else 0
    for layer in server.cache:
        ref = layer.pages.ref.cpu().numpy()
        nf = int(layer.pages.n_free)
        check(nf == len(ref) - held and int((ref == 0).sum()) == nf
              and int((ref > 0).sum()) == held,
              f"{what}: {len(ref) - nf} pages held, the index holds {held}")


def phase_serve_preempt(engine, cfg) -> dict:
    """Preemption on the full-width model: four class-1 requests, then,
    once all four decode, two class-0 arrivals that must each swap a
    victim out (dense; paged with the prefix cache, the class-1 prompts
    opening with one 512-token system prompt; paged with 5 slots and a
    pool one page short of a class-0 arrival). Every request bitwise equal
    to its control (the same config, preemption off), K2/K5 counted,
    pools clean after the run."""
    import numpy as np

    from repro_torch.serving import Request, SlotServer

    rng = np.random.default_rng(6)
    sys_prompt = rng.integers(0, cfg.vocab, PREEMPT_SYS)
    lows = [rng.integers(0, cfg.vocab, n) for n in PREEMPT_LOW]
    highs = [rng.integers(0, cfg.vocab, n) for n in PREEMPT_HIGH]
    pressure_pool = 1 + sum(-(-(n + PREEMPT_LOW_NEW) // 256) for n in PREEMPT_LOW)
    runs = [("dense", dict()),
            ("prefix", dict(paged=True, page_size=256, prefix_cache=True,
                            debug_invariants=True)),
            ("pressure", dict(paged=True, page_size=256, max_batch=5,
                              pool_pages=pressure_pool, debug_invariants=True))]
    total = {"dense": 0, "paged": 0}
    for name, ekw in runs:
        mode = "dense" if name == "dense" else "paged"
        prefix = sys_prompt if name == "prefix" else np.zeros(0, np.int64)

        def drive(server):
            def steps():
                for i, p in enumerate(lows):
                    server.submit(Request(rid=i, max_new=PREEMPT_LOW_NEW, priority=1,
                                          tokens=np.concatenate([prefix, p])))
                while server.n_occupied < len(lows):
                    server.step()
                for j, p in enumerate(highs):
                    server.submit(Request(rid=len(lows) + j, max_new=PREEMPT_HIGH_NEW,
                                          priority=0, tokens=p))
                server.run()

            return served(server, mode, cfg, steps)

        pre = slot_engine(engine, cfg, preempt=True, **ekw)
        server = SlotServer(pre)
        evac, swap, restore = [], [], []
        device_timed(pre, "evacuate", evac)
        device_timed(server._swap, "put", swap, lambda a: mini_bytes(a[1]))
        device_timed(pre, "restore", restore)
        reserved = []
        if name == "pressure":
            fit = server._fit_pages

            def fit_and_record(head, need_new, protected):
                reserved.append({"step": server._step_no, "rid": head.rid,
                                 "need_new": need_new, "available": server._pages_avail,
                                 "reserved": dict(server._reserved)})
                return fit(head, need_new, protected)

            server._fit_pages = fit_and_record
        t0 = time.perf_counter()
        total[mode] += drive(server)
        wall = time.perf_counter() - t0
        s = server.stats
        ctl_engine = slot_engine(engine, cfg, **ekw)
        control = SlotServer(ctl_engine)
        t0 = time.perf_counter()
        total[mode] += drive(control)
        ctl_wall = time.perf_counter() - t0
        tag = f"serve_preempt {name}"
        check(len(server.done) == len(lows) + len(highs) == len(control.done),
              f"{tag}: not every request finished")
        for rid, r in server.done.items():
            check(np.array_equal(r.output, control.done[rid].output),
                  f"{tag}: request {rid} differs from its uninterrupted control")
        check(s.preemptions >= (1 if name == "pressure" else 2),
              f"{tag}: {s.preemptions} preemptions")
        check(sum(r.n_preempts for r in server.done.values()) == s.preemptions,
              f"{tag}: n_preempts do not add up to {s.preemptions}")
        check(control.stats.preemptions == 0, f"{tag}: the control preempted")
        if mode == "paged":
            check(s.swapped_pages == s.restored_pages,
                  f"{tag}: {s.swapped_pages} pages out, {s.restored_pages} back")
            pool_clean(server, tag)
            pool_clean(control, tag + " control")
        check(len(server._swap) == 0, f"{tag}: the swap store did not drain")
        row = {"phase": "serve_preempt", "run": name, "max_batch": pre.ecfg.max_batch,
               "low_prompts": [len(prefix) + n for n in PREEMPT_LOW],
               "high_prompts": list(PREEMPT_HIGH), "low_new": PREEMPT_LOW_NEW,
               "high_new": PREEMPT_HIGH_NEW, "preemptions": s.preemptions,
               "swapped_pages": s.swapped_pages, "restored_pages": s.restored_pages,
               "prefix_hits": s.prefix_hits,
               "n_preempts": {rid: r.n_preempts for rid, r in server.done.items()},
               "swapped_row_bytes": [b for _, b in swap],
               "swap_peak_bytes": server._swap.peak_bytes,
               "evacuate_ms": [t for t, _ in evac], "host_copy_ms": [t for t, _ in swap],
               "restore_ms": [t for t, _ in restore], "decode_steps": s.decode_steps,
               "wall_s": wall, "decode_tok_s": (s.tokens_out - s.admitted) / s.decode_s,
               "control_wall_s": ctl_wall,
               "control_decode_tok_s": (control.stats.tokens_out - control.stats.admitted)
               / control.stats.decode_s,
               "bitwise_equal_control": True, "stats": s.to_json()}
        if name == "pressure":
            row.update(pool_pages=pressure_pool, fit_checks=reserved[:12])
        emit(row)
        del server, control, pre, ctl_engine
    return total


def chain(eng, prompt, turns):
    """A conversation driven by hand, uninterrupted, on a session-off
    engine, row 0 live and the others free (the server's GEMM height):
    admitted as the server admits it (page-sized chunks, the last fused
    with the insert), each extension teacher-forced by single decode
    steps. ``turns``: [(extension or None, max_new), ...]; returns one
    output list a turn."""
    import numpy as np
    import torch

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


SESSION_PROMPTS = (700, 1000)
SESSION_NEW, SESSION_EXT = 16, 16  # 32 new a turn before PR 26


def phase_serve_session(engine, cfg) -> dict:
    """Two conversations (prompts 700 and 1000, 16 new tokens a turn; each
    turn returns with a 16-token extension; the 1000-token one takes a
    third turn), dense and paged. The host tier is sized at 1.5x the
    first parked row, so the second park spills the first to disk and
    its return loads it back. Every turn bitwise equal to the
    uninterrupted chain on a session-off engine (the same max_batch and
    spec_k), no prefill chunk for a hit, K2/K5 counted; the returning
    turn's time to first token beside a cold admission of its prompt."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import sharded
    from repro_torch.core.cache import SessionStore
    from repro_torch.serving import Request, SlotServer

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in SESSION_PROMPTS]
    exts = [[rng.integers(0, cfg.vocab, SESSION_EXT) for _ in range(2)] for _ in prompts]
    plans = [[(None, SESSION_NEW), (exts[0][0], SESSION_NEW)],
             [(None, SESSION_NEW), (exts[1][0], SESSION_NEW), (exts[1][1], SESSION_NEW)]]
    total = {"dense": 0, "paged": 0}
    saves, loads = [], []
    save, load = sharded.save_mini, sharded.load_mini
    host_timed(sharded, "save_mini", saves)
    host_timed(sharded, "load_mini", loads)
    try:
        for mode in ("dense", "paged"):
            ekw = dict(paged=True, page_size=256, debug_invariants=True) if mode == "paged" else {}
            with tempfile.TemporaryDirectory() as tmp:
                store = SessionStore(capacity_bytes=1 << 62, disk_dir=tmp)
                put = store.put

                def sized_put(trace, mini, meta):
                    if store.parks == 0:  # the host tier holds one row
                        store.capacity_bytes = int(1.5 * mini_bytes(mini))
                    put(trace, mini, meta)

                store.put = sized_put
                eng = slot_engine(engine, cfg, session_cache=True, **ekw)
                server = SlotServer(eng, session_store=store)
                restores = []
                device_timed(eng, "restore", restores)
                outs, toks, turn_reqs = [[], []], list(prompts), []
                chunks_before_hits = None
                for k in range(3):
                    live = [c for c in range(2) if k < len(plans[c])]
                    for c in live:
                        ext = plans[c][k][0]
                        if ext is not None:
                            toks[c] = np.concatenate([toks[c], outs[c][-1], ext])
                        req = Request(rid=10 * k + c, max_new=SESSION_NEW, tokens=toks[c])
                        turn_reqs.append((k, c, req))
                        server.submit(req)
                    if k == 1:
                        chunks_before_hits = server.stats.prefill_chunks
                    total[mode] += served(server, mode, cfg)
                    for c in live:
                        outs[c].append(np.asarray(server.done[10 * k + c].output))
                s = server.stats
                tag = f"serve_session {mode}"
                check(s.session_hits == 3 and s.session_parks == 5,
                      f"{tag}: {s.session_hits} hits, {s.session_parks} parks")
                check(s.prefill_chunks == chunks_before_hits,
                      f"{tag}: a hit ran prefill chunks")
                check(store.spills >= 1 and store.loads >= 1,
                      f"{tag}: {store.spills} spills, {store.loads} loads")
                if mode == "paged":
                    pool_clean(server, tag)
                base = slot_engine(engine, cfg, **ekw)
                for c in range(2):
                    want = chain(base, prompts[c], plans[c])
                    for k, (got, w) in enumerate(zip(outs[c], want)):
                        check(list(got) == w,
                              f"{tag}: conversation {c} turn {k} differs from its chain")
                # what a hit saves a user: the returning turn's time to first
                # token beside a cold admission of the same prompt (the 700
                # conversation's: a prompt past 1024 tokens prefills only at
                # a multiple of 1024, flash attention's tile, in both packages)
                last = next(r for k, c, r in turn_reqs if (k, c) == (1, 0))
                cold = SlotServer(base)
                cold_req = Request(rid=0, max_new=SESSION_NEW, tokens=last.tokens)
                cold.submit(cold_req)
                total[mode] += served(cold, mode, cfg)
                emit({"phase": "serve_session", "mode": mode,
                      "prompts": list(SESSION_PROMPTS), "max_new": SESSION_NEW,
                      "extension": SESSION_EXT, "turns": [len(p) for p in plans],
                      "session_hits": s.session_hits, "session_parks": s.session_parks,
                      "session_evictions": s.session_evictions,
                      "session_restored_pages": s.session_restored_pages,
                      "host_capacity_bytes": store.capacity_bytes,
                      "session_cache_mb": store.capacity_bytes / 2 ** 20,
                      "spills": store.spills, "loads": store.loads,
                      "peak_host_bytes": store.peak_bytes,
                      "parked_bytes": [e["nbytes"] for e in store._host.values()]
                      + [e["nbytes"] for e in store._disk.values()],
                      "save_mini_ms": [t for t, _ in saves], "load_mini_ms": [t for t, _ in loads],
                      "restore_ms": [t for t, _ in restores],
                      "hit_prompt": len(last.tokens),
                      "hit_ttft_s": last.t_first - last.t_submit,
                      "cold_ttft_s": cold_req.t_first - cold_req.t_submit,
                      "cold_prefill_chunks": cold.stats.prefill_chunks,
                      "bitwise_equal_chain": True, "stats": s.to_json()})
                saves.clear(), loads.clear()
                del server, eng, base, cold
    finally:
        sharded.save_mini, sharded.load_mini = save, load
    return total


FAULT_REQUESTS, FAULT_SYS = 8, 512


def phase_serve_faults(engine, cfg) -> dict:
    """The paged prefix engine with sessions, preemption and
    debug_invariants under a FaultPlan of every kind over its first 40
    steps, 8 requests (a shared 512-token system prompt, classes 0 and
    1): the run drains, references are conserved after every admit and
    retire, no page leaks, and every request no fault touched is bitwise
    equal to its control (the same requests, no faults)."""
    import numpy as np

    from repro_torch.distributed import FaultEvent, FaultPlan
    from repro_torch.serving import Request, SlotServer

    ekw = dict(paged=True, page_size=256, prefix_cache=True, debug_invariants=True)
    rng = np.random.default_rng(8)
    sys_prompt = rng.integers(0, cfg.vocab, FAULT_SYS)
    spec = [(int(n), int(m)) for n, m in zip(rng.integers(100, 700, FAULT_REQUESTS),
                                             rng.integers(64, 128, FAULT_REQUESTS))]
    sfx = [rng.integers(0, cfg.vocab, n) for n, _ in spec]
    reqs = lambda: [Request(rid=i, max_new=m, priority=i % 2,
                            tokens=np.concatenate([sys_prompt, sfx[i]]))
                    for i, (_, m) in enumerate(spec)]
    plan = FaultPlan([FaultEvent(3, "chunk_abort"), FaultEvent(5, "pool_squeeze", 6),
                      FaultEvent(9, "park", 1), FaultEvent(11, "pool_squeeze", 0),
                      FaultEvent(12, "resume", 1), FaultEvent(16, "cancel", 1),
                      FaultEvent(20, "park", 1), FaultEvent(22, "session_expire", 1),
                      FaultEvent(25, "deadline", 1), FaultEvent(28, "resume", 2),
                      FaultEvent(31, "chunk_abort"), FaultEvent(34, "straggler", 5.0)])
    eng = slot_engine(engine, cfg, session_cache=True, preempt=True, **ekw)
    server = SlotServer(eng, fault_plan=plan)
    for r in reqs():
        server.submit(r)
    t0 = time.perf_counter()
    launches = served(server, "paged", cfg)
    wall = time.perf_counter() - t0
    s = server.stats
    check(len(plan.fired) == len(plan.events),
          f"serve_faults: {len(plan.fired)} of {len(plan.events)} faults fired "
          f"in {server._step_no} steps")
    check(not server.queue and server._task is None and len(server._swap) == 0,
          "serve_faults: the run did not drain")
    pool_clean(server, "serve_faults")
    control = SlotServer(slot_engine(engine, cfg, **ekw))
    for r in reqs():
        control.submit(r)
    launches += served(control, "paged", cfg)
    touched = sorted(rid for rid, r in server.done.items() if r.status != "done")
    compared = 0
    for rid, r in control.done.items():
        if rid not in touched:
            check(np.array_equal(server.done[rid].output, r.output),
                  f"serve_faults: untouched request {rid} differs from its control")
            compared += 1
    check(compared >= 3, f"serve_faults: only {compared} untouched requests")
    emit({"phase": "serve_faults", "requests": FAULT_REQUESTS, "system_prompt": FAULT_SYS,
          "faults": [[e.step, e.kind, e.arg] for e in plan.fired],
          "steps": server._step_no, "touched": touched,
          "statuses": {rid: r.status for rid, r in sorted(server.done.items())},
          "compared_bitwise": compared, "cancelled": s.cancelled, "expired": s.expired,
          "preemptions": s.preemptions, "session_parks": s.session_parks,
          "session_hits": s.session_hits, "session_evictions": s.session_evictions,
          "prefix_hits": s.prefix_hits, "prefix_evictions": s.prefix_evictions,
          "k5_launches": launches, "wall_s": wall, "stats": s.to_json()})
    return {"dense": 0, "paged": launches}


# serve_mesh: the (dp, kv) serving mesh on one card, lanes on cuda:0
MESH_NEW = 16  # new tokens a request: the first 16 of the plain phases' 160 (32 before PR 26)
MESH_STEADY_LAUNCHES = 1  # timed 8-step launches a turn of steady_step_ms


def lane_bytes_per_token(layers) -> float:
    """Bytes a token holds in one lane's compressed region on the card
    (tier payload words, pack mins and shifts, f32 scale and zero, every
    layer) per token slot of its storage: rows x capacity dense, pool
    pages x page paged; every head of the lane."""
    total = 0
    for layer in layers:
        for t in (layer.k, layer.v):
            total += sum(x.numel() * x.element_size() for tier in t.tiers
                         for x in (tier.payload, tier.mins, tier.shifts))
            total += sum(x.numel() * x.element_size() for x in (t.scale, t.zero))
    first = layers[0]
    return total / (first.k.scale.numel() // first.resid_k.shape[1])


def mesh_serve(eng, prompts) -> dict:
    """Serve ``prompts`` (MESH_NEW new tokens each) on ``eng`` with the
    launch counts from 0: outputs, stats, wall, K2 / K5 launches, peak
    device memory."""
    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.serving import Request, SlotServer

    server = SlotServer(eng)
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, tokens=p, max_new=MESH_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    t0 = time.perf_counter()
    server.run()
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0, "server": server,
           "k2": fused_packed_attention.launches,
           "k5": fused_packed_attention_paged.launches,
           "peak": torch.cuda.max_memory_allocated(),
           "outputs": {rid: np.asarray(r.output) for rid, r in server.done.items()}}
    return out


def phase_serve_mesh(engine, cfg, dense: dict, paged: dict, device) -> dict:
    """The serving mesh on one card, every lane on cuda:0 (the lanes run
    one after another): (a) llama2-7b dense, monolithic, mesh (1, 2): K2
    at H_kv = 16; (b) llama2-7b paged (the 14-page pool), chunked, mesh
    (2, 2): K5 at H_kv = 16 with the dp row masks; (c) minitron-4b dense,
    monolithic, mesh (1, 4): K2 at H_kv = 2, G = 3. The 6 prompts of
    serve_prompts, MESH_NEW new tokens, 4 slots. Every request bitwise
    equal to its (1, 1) control with the same engine settings in this
    process (a, b: the serve and serve_paged phases' first MESH_NEW
    tokens, as serve_spec holds its runs; c: a (1, 1) run here); K2 / K5
    launched once a lane, layer and decode step, the other kernel never;
    every lane's ledger lane (0, 0)'s at the end. Reports decode tok/s
    beside the control's, the wall ms a step of steady launches beside the
    control's (in turns, one process), the device bytes a token a lane,
    summed and over one dp row of lanes (the (1, 1) cache's), and the
    peak memory."""
    import numpy as np

    from repro_torch.kernels.sharded import ledgers_agree

    total = {"dense": 0, "paged": 0}
    cfg_m, eng_m = config_engine("minitron-4b", device, 12, prefill_chunk_pages=0)
    runs = [("a", cfg, engine, (1, 2), dict(prefill_chunk_pages=0), dense),
            ("b", cfg, engine, (2, 2),
             dict(paged=True, page_size=256, pool_pages=14, prefill_chunk_pages=1), paged),
            ("c", cfg_m, eng_m, (1, 4), dict(prefill_chunk_pages=0), None)]
    for name, c, base, shape, ekw, ref in runs:
        n = shape[0] * shape[1]
        lane_dev = "cuda:0" if base.ecfg.device == "cuda" else base.ecfg.device
        prompts = serve_prompts(c)
        control = slot_engine(base, c, **ekw)
        ctl = None
        if ref is None:  # no earlier phase served this config: a control run
            ctl = mesh_serve(control, prompts)
            cs = ctl["server"].stats
            ref = {"outputs": ctl["outputs"],
                   "decode_tok_s": (cs.tokens_out - cs.admitted) / cs.decode_s}
        want = ref["outputs"]
        mesh = slot_engine(base, c, mesh_shape=shape, mesh_devices=(lane_dev,) * n, **ekw)
        got = mesh_serve(mesh, prompts)
        tag = f"serve_mesh {name} {c.name} {shape}"
        mode = "paged" if ekw.get("paged") else "dense"
        used, other = (got["k5"], got["k2"]) if mode == "paged" else (got["k2"], got["k5"])
        s = got["server"].stats
        check(len(got["outputs"]) == len(prompts), f"{tag}: not every request finished")
        for rid, out in got["outputs"].items():
            check(np.array_equal(out, want[rid][:MESH_NEW]),
                  f"{tag}: request {rid} differs from its (1, 1) control")
        check(used == n * c.n_layers * s.decode_steps and other == 0,
              f"{tag}: attention launches {used} (other {other}) != {n} lanes x "
              f"{c.n_layers} layers x {s.decode_steps} steps")
        check(ledgers_agree(got["server"].cache), f"{tag}: lane ledgers diverged")
        lanes = [lane_bytes_per_token(x) for x in got["server"].cache.lanes]
        steady = steady_step_ms({"control": control, "mesh": mesh}, c,
                                launches=MESH_STEADY_LAUNCHES)
        emit({"phase": "serve_mesh", "run": name, "arch": c.name, "mesh": list(shape),
              "devices": [lane_dev] * n, "mode": mode, "n_layers": c.n_layers,
              "n_kv_heads": c.n_kv_heads, "lane_kv_heads": c.n_kv_heads // shape[1],
              "G": c.n_heads // c.n_kv_heads, "requests": len(prompts),
              "max_new": MESH_NEW, "decode_steps": s.decode_steps,
              "attention_launches": used, "bitwise_equal_control": True,
              "decode_tok_s": (s.tokens_out - s.admitted) / s.decode_s,
              "control_decode_tok_s": ref["decode_tok_s"],
              "control_max_new": MESH_NEW if ctl else 160,
              "wall_s": got["wall"],
              "steady_ms_per_step": steady,
              "steady_ratio": statistics.median(steady["mesh"])
              / statistics.median(steady["control"]),
              "device_bytes_per_token_lane": lanes,
              "device_bytes_per_token_sum": sum(lanes),
              "device_bytes_per_token_one_dp_row": sum(lanes[:shape[1]]),
              "peak_memory_bytes": got["peak"]})
        if ctl is not None:
            total[mode] += ctl["k5" if mode == "paged" else "k2"]
        total[mode] += used
        del control, mesh, ctl, got
    free_engine(eng_m)
    return total


def compressed_bytes_per_token(cfg, engine):
    """(compressed, bf16) bytes a token of context takes in the cache over
    all layers and kv heads, from the calibrated specs (payload bits, pack
    metadata and the per-token scale/zero, as the paper counts them)."""
    from repro_torch.core.tiered import tiered_bits_per_value

    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    per_tok = cfg.n_layers * cfg.n_kv_heads * cfg.hd
    return (per_tok * (tiered_bits_per_value(ks) + tiered_bits_per_value(vs)) / 8,
            per_tok * 2 * 2)


def config_engine(name: str, device, seed: int, **ekw):
    """A full-width engine of a ported config: random bf16 weights from a
    seeded torch.Generator, policy packkv, capacity 2048, 4 slots,
    decode_chunk 8, backend fused."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, EngineConfig

    cfg = get_arch(name)
    params = get_model(cfg).init(torch.Generator(device=device).manual_seed(seed), cfg)
    return cfg, Engine(cfg, params, get_policy("packkv"),
                       EngineConfig(capacity=2048, max_batch=4, decode_chunk=8,
                                    backend="fused", device="cuda", **ekw))


def free_engine(engine) -> None:
    """Drop an engine's weights so the next model fits on the card: the
    phases' servers hold their engines in reference cycles (wrapped
    methods), so the collector runs before the cache is emptied."""
    import gc

    import torch

    engine.params = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# serve_configs: the other dense configs at full width and depth, dense
CONFIG_SERVE = ("smollm-135m", "minicpm-2b", "minitron-4b")
CONFIG_PROMPTS = (320, 700, 450, 900)
CONFIG_NEW = 32


def phase_serve_configs(first: tuple, device) -> dict:
    """smollm-135m (``first``: its (cfg, engine), built for the kernel
    phases' D=64 spec), minicpm-2b and minitron-4b one after another:
    4 requests of 32 new tokens each through dense storage. K2 launches
    once per layer and decode step, K5 never; outputs in the vocabulary."""
    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.serving import Request, SlotServer

    total = 0
    for i, name in enumerate(CONFIG_SERVE):
        t0 = time.perf_counter()
        cfg, engine = first if name == first[0].name else config_engine(
            name, device, i + 10, prefill_chunk_pages=0)
        built = time.perf_counter() - t0
        rng = np.random.default_rng(4)
        server = SlotServer(engine)
        for rid, n in enumerate(CONFIG_PROMPTS):
            server.submit(Request(rid=rid, tokens=rng.integers(0, cfg.vocab, n),
                                  max_new=CONFIG_NEW))
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        t0 = time.perf_counter()
        done = {r.rid: r for r in server.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, s = fused_packed_attention.launches, server.stats
        check(len(done) == len(CONFIG_PROMPTS), f"{name}: not every request finished")
        check(launches > 0 and launches == cfg.n_layers * s.decode_steps,
              f"{name}: K2 launches {launches} != {cfg.n_layers} x {s.decode_steps} steps")
        check(fused_packed_attention_paged.launches == 0, f"{name}: dense serving launched K5")
        for r in done.values():
            out = np.asarray(r.output)
            check(out.shape == (CONFIG_NEW,) and (out >= 0).all() and (out < cfg.vocab).all(),
                  f"{name} request {r.rid}: output out of the vocabulary")
        comp, bf16 = compressed_bytes_per_token(cfg, engine)
        ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
        emit({"phase": "serve_configs", "arch": name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "G": cfg.n_heads // cfg.n_kv_heads, "head_dim": cfg.hd,
              "weights_gb": cfg.param_count() * 2 / 1e9, "engine_s": built,
              "requests": len(CONFIG_PROMPTS), "prompts": list(CONFIG_PROMPTS),
              "max_new": CONFIG_NEW, "k_spec": [ks.widths, ks.counts],
              "v_spec": [vs.widths, vs.counts], "decode_steps": s.decode_steps,
              "k2_launches": launches, "prefill_chunks": s.prefill_chunks,
              "wall_s": wall, "decode_s": s.decode_s,
              "decode_tok_s": (s.tokens_out - s.admitted) / s.decode_s,
              "compressed_bytes_per_token": comp, "bf16_bytes_per_token": bf16,
              "compression_ratio": bf16 / comp})
        total += launches
        del server, done
        free_engine(engine)
    return {"launches": total}


# serve_prefix: qwen3-32b with a shared system prompt, paged + prefix cache
PREFIX_SYS = 512
PREFIX_SUFFIXES = (320, 700, 200, 450, 260, 900)
PREFIX_NEW = 32


def phase_serve_prefix(device) -> dict:
    """qwen3-32b at full width and depth through paged storage with the
    prefix cache: 6 requests opening with one 512-token system prompt
    (2 pages of 256). Every admission after the first hits the index;
    each hit's admission (last-token logits, the whole mini-cache it
    scatters) and its 64 tokens must equal a cold admission of the same
    request on a fresh server over the same engine, bitwise."""
    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.serving import Request, SlotServer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, engine = config_engine("qwen3-32b", device, 20, paged=True, page_size=256,
                                prefix_cache=True, prefill_chunk_pages=1)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, cfg.vocab, PREFIX_SYS)
    suffixes = [rng.integers(0, cfg.vocab, n) for n in PREFIX_SUFFIXES]
    reqs = lambda: [Request(rid=i, max_new=PREFIX_NEW,
                            tokens=np.concatenate([sys_prompt, sfx]))
                    for i, sfx in enumerate(suffixes)]

    def serve(requests):
        """A fresh server over ``engine``; records each admission's logits,
        mini-cache and matched pages as its last segment finishes."""
        server = SlotServer(engine)
        record, finish = {}, server._finish_task

        def finish_and_record(t, finished):
            record[t.req.rid] = (t.logits, t.scratch, t.match_pages)
            return finish(t, finished)

        server._finish_task = finish_and_record
        for r in requests:
            server.submit(r)
        fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
        start = time.perf_counter()
        server.run()
        torch.cuda.synchronize()
        return server, record, time.perf_counter() - start

    warm, record, wall = serve(reqs())
    launches, s = fused_packed_attention_paged.launches, warm.stats
    check(len(warm.done) == len(PREFIX_SUFFIXES), "not every request finished")
    check(launches > 0 and launches == cfg.n_layers * s.decode_steps,
          f"K5 launches {launches} != {cfg.n_layers} x {s.decode_steps} steps")
    check(fused_packed_attention.launches == 0, "paged serving launched K2")
    hits = sorted(rid for rid, (_, _, pages) in record.items() if pages)
    pages_sys = PREFIX_SYS // engine.ecfg.page_size
    check(s.prefix_lookups == len(PREFIX_SUFFIXES) and s.prefix_hits >= 4
          and len(hits) == s.prefix_hits
          and s.prefix_pages_shared == pages_sys * s.prefix_hits
          and all(len(record[rid][2]) == pages_sys for rid in hits),
          f"prefix stats: {s.prefix_lookups} lookups, {s.prefix_hits} hits, "
          f"{s.prefix_pages_shared} pages shared")
    # suffix-only reservations: at most one cold row (the first) among the
    # slots, every hit reserving its need less the shared pages
    needs = [warm._pages_needed(r) for r in reqs()]
    bound = needs[0] + sum(sorted(n - pages_sys for n in needs[1:])[-3:])
    check(s.pages_reserved_peak <= bound < sum(sorted(needs)[-4:]),
          f"reserved peak {s.pages_reserved_peak} above the suffix-only bound {bound}")
    # refcount conservation (free <=> ref == 0) in every layer; the index's
    # pages stay held
    for layer in warm.cache:
        ref = layer.pages.ref.cpu().numpy()
        nf = int(layer.pages.n_free)
        free = layer.pages.free.cpu().numpy()[:nf]
        check(int((ref == 0).sum()) == nf and int((ref > 0).sum()) + nf == len(ref)
              and bool((ref[free] == 0).all())
              and all(ref[p] >= 1 for p in warm._index.pages),
              "page refcounts are not conserved")
    peak = torch.cuda.max_memory_allocated()
    outputs = {rid: np.asarray(r.output) for rid, r in warm.done.items()}
    for r in outputs.values():
        check(r.shape == (PREFIX_NEW,) and (r >= 0).all() and (r < cfg.vocab).all(),
              "an output out of the vocabulary")
    decode_tok_s = (s.tokens_out - s.admitted) / s.decode_s
    del warm
    cold_s = 0.0
    for rid in hits:
        cold, cold_rec, dt = serve([reqs()[rid]])
        cold_s += dt
        (lw, mw, _), (lc, mc, pages) = record[rid], cold_rec[rid]
        check(not pages, "a fresh server's admission hit")
        check(torch.equal(lw, lc), f"request {rid}: hit admission logits != cold")
        check(all(torch.equal(a, b) for a, b in zip(cache_tensors(mw), cache_tensors(mc))),
              f"request {rid}: hit admission cache bytes != cold")
        check(np.array_equal(outputs[rid], np.asarray(cold.done[rid].output)),
              f"request {rid}: hit tokens != cold tokens")
        del cold, cold_rec
    comp, bf16 = compressed_bytes_per_token(cfg, engine)
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    emit({"phase": "serve_prefix", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.hd, "qk_norm": cfg.qk_norm, "vocab": cfg.vocab,
          "weights_gb": cfg.param_count() * 2 / 1e9, "engine_s": built,
          "page_size": engine.ecfg.page_size, "pool_pages": engine.pack_cfg.pool_pages,
          "system_prompt": PREFIX_SYS, "suffixes": list(PREFIX_SUFFIXES),
          "max_new": PREFIX_NEW, "k_spec": [ks.widths, ks.counts],
          "v_spec": [vs.widths, vs.counts], "prefix_lookups": s.prefix_lookups,
          "prefix_hits": s.prefix_hits, "prefix_pages_shared": s.prefix_pages_shared,
          "prefix_evictions": s.prefix_evictions, "pages_reserved_peak": s.pages_reserved_peak,
          "suffix_only_bound": bound, "prefill_chunks": s.prefill_chunks,
          "decode_steps": s.decode_steps, "k5_launches": launches, "wall_s": wall,
          "decode_s": s.decode_s, "decode_tok_s": decode_tok_s,
          "peak_memory_bytes": peak, "cold_runs": len(hits), "cold_runs_s": cold_s,
          "hits_bitwise_equal_cold": True,
          "compressed_bytes_per_token": comp, "bf16_bytes_per_token": bf16,
          "compression_ratio": bf16 / comp})
    free_engine(engine)
    return {"launches": launches}


# serve_moe / serve_vlm / encode: the MoE family, the VLM and the encoder
MOE_PROMPTS = (320, 700, 1000, 450, 260, 900)
MOE_NEW = 16  # 32 before PR 26
MOONSHOT_PROMPTS = (320, 700, 450, 900)
MOONSHOT_NEW = 16  # 32 before PR 26
VLM_TOKENS, VLM_NEW = 512, 32
ENCODE_FRAMES = 1024


def device_bytes_per_token(cache) -> float:
    """Bytes a token of context holds in a dense cache on the card: tier
    payload words, pack mins and shifts, and the f32 scale and zero, over
    every layer, per (row, token) of capacity."""
    total = 0
    for layer in cache:
        for t in (layer.k, layer.v):
            total += sum(x.numel() * x.element_size() for tier in t.tiers
                         for x in (tier.payload, tier.mins, tier.shifts))
            total += sum(x.numel() * x.element_size() for x in (t.scale, t.zero))
    rows, cap = cache[0].n_comp.shape[0], cache[0].k.scale.shape[-1]
    return total / (rows * cap)


def routing_summary(log) -> dict:
    """C and dropped routed choices per call site of an MoE routing log
    (one host read)."""
    import torch

    out: dict = {}
    if not log:
        return out
    dropped = torch.stack([c.dropped.sum() for c in log]).tolist()
    for c, d in zip(log, dropped):
        s = out.setdefault(c.site, {"calls": 0, "tokens": 0, "dropped_choices": 0,
                                    "capacity": set()})
        s["calls"] += 1
        s["tokens"] += c.T
        s["dropped_choices"] += int(d)
        s["capacity"].add(c.C)
    for s in out.values():
        s["capacity"] = sorted(s["capacity"])
    return out


def moe_server_run(engine, cfg, prompts, max_new, drafter=None, log_routing=False):
    """Serve ``prompts`` on a fresh SlotServer over ``engine`` with every
    launch count set to 0 first. Returns (outputs, stats, wall s, K2 and K5
    launches, routing summary, requests a verify pass dropped a routed
    choice of)."""
    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.models import moe
    from repro_torch.serving import Request, SlotServer

    server = SlotServer(engine, drafter=drafter)
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, tokens=p, max_new=max_new))
    verify_dropped: set = set()
    verify = engine.decode_verify

    def traced_verify(cache, toks, *a, **kw):
        rows = [x.req.rid if x is not None else None for x in server.slots]
        n0 = len(log)
        out = verify(cache, toks, *a, **kw)
        hit = torch.stack([c.dropped.view(len(rows), -1).sum(1) for c in log[n0:]]).sum(0)
        verify_dropped.update(rid for rid, h in zip(rows, hit.tolist())
                              if rid is not None and h)
        return out

    if drafter is not None:
        engine.decode_verify = traced_verify
    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    # the plain timed runs record nothing
    logged = log_routing or drafter is not None
    try:
        with moe.routing_log() if logged else contextlib.nullcontext([]) as log:
            t0 = time.perf_counter()
            done = {r.rid: r for r in server.run()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine.__dict__.pop("decode_verify", None)
    check(len(done) == len(prompts), f"{cfg.name}: not every request finished")
    outs = {rid: np.asarray(r.output) for rid, r in done.items()}
    for out in outs.values():
        check(out.shape == (max_new,) and (out >= 0).all() and (out < cfg.vocab).all(),
              f"{cfg.name}: an output out of the vocabulary")
    k2, k5 = fused_packed_attention.launches, fused_packed_attention_paged.launches
    return (outs, server.stats, wall, k2, k5,
            routing_summary(log) if log_routing else {}, verify_dropped)


def moe_routing_on_card(engine, cfg, prompt) -> dict:
    """One prefill chunk (a full page of ``prompt``), one monolithic
    prefill and one decode step with the routing log keeping tensors: each
    call's top-k indices, positions, keep mask and slots on the card equal
    those ``moe.route`` computes on the CPU from the same logits copied to
    the host, but where the card's top-k gap is below 1e-6 (a tie the
    two softmaxes may round apart: counted)."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    E, k = cfg.n_experts, cfg.moe_topk
    with moe.routing_log(keep_tensors=True) as log:
        scratch = engine.chunk_init(len(prompt))
        engine.chunk_step(scratch, prompt[:256], 0)
        logits, cache = engine.prefill({"tokens": prompt[None, :512]})
        engine.decode(cache, torch.argmax(logits, -1).to(torch.int32)[:, None])
    torch.cuda.synchronize()
    out = {"calls": 0, "tokens": 0, "ties": 0}
    for c in log:
        r, cpu = c.routing, moe.route(c.logits.cpu(), E, k)
        check(r.C == cpu.C, f"routing on the card: C {r.C} != CPU {cpu.C}")
        tie = (r.gap.cpu() < 1e-6).numpy()
        for f in ("idx", "pos", "keep", "slot"):
            a, b = getattr(r, f).cpu().numpy(), getattr(cpu, f).numpy()
            a, b = a.reshape(c.T, -1), b.reshape(c.T, -1)
            # a tie at one token moves the later positions of its experts
            bad = np.nonzero((a != b).any(1))[0]
            check(len(bad) == 0 or tie[bad[0]],
                  f"routing on the card ({c.site}, {f}) != CPU at token {bad[:4]}")
        out["calls"] += 1
        out["tokens"] += c.T
        out["ties"] += int(tie.sum())
    out["sites"] = sorted({c.site for c in log})
    check(out["sites"] == ["chunk", "decode", "prefill"], f"routed sites {out['sites']}")
    return out


def phase_serve_moe(device) -> dict:
    """qwen2-moe-a2.7b at full width and depth, 6 requests of MOE_NEW new
    tokens, in four runs: (a) dense, chunked admission; (b) paged (pages of
    256), bitwise equal to (a); (c) dense, spec_k 4 with the replay drafter,
    bitwise equal to (a) for every request no verify pass dropped a routed
    choice of (at least one); (d) dense, monolithic admission, its
    agreement with (a) reported (C follows the chunk's length in one and
    the prompt's in the other). The routing on the card equals the CPU's.
    Then moonshot-v1-16b-a3b at full width and depth, dense, 4 requests of
    16 new tokens. K2 (K5) launches n_layers x decode steps."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.serving import Engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, engine = config_engine("qwen2-moe-a2.7b", device, 30, prefill_chunk_pages=1)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n) for n in MOE_PROMPTS]
    variant = lambda **kw: Engine(cfg, engine.params, engine.pack_cfg, dataclasses.replace(
        engine.ecfg, calibrate=False, **kw))
    runs, total = {}, {"dense": 0, "paged": 0}
    plan = [("a_dense_chunked", engine, None), ("b_paged_chunked", variant(
        paged=True, page_size=256), None), ("c_dense_spec", variant(spec_decode=True), 3),
            ("d_dense_monolithic", variant(prefill_chunk_pages=0), None)]
    for name, eng, corrupt in plan:
        drafter = None
        if corrupt is not None:
            drafter = ReplayDrafter({tuple(int(t) for t in p): runs["a_dense_chunked"][0][i]
                                     for i, p in enumerate(prompts)}, cfg.vocab, corrupt)
        outs, s, wall, k2, k5, routing, vdrop = moe_server_run(
            eng, cfg, prompts, MOE_NEW, drafter, log_routing=name == "a_dense_chunked")
        runs[name] = (outs, s)
        paged = eng.ecfg.paged
        used, unused = (k5, k2) if paged else (k2, k5)
        if drafter is None:
            check(used == cfg.n_layers * s.decode_steps and unused == 0,
                  f"serve_moe {name}: attention launches {used} (other {unused}) != "
                  f"{cfg.n_layers} x {s.decode_steps} steps")
        else:
            want = cfg.n_layers * (s.decode_steps - s.spec_launches
                                   + (SPEC_K + 1) * s.spec_launches)
            check(s.spec_launches > 0 and used == want and unused == 0,
                  f"serve_moe {name}: attention launches {used} != {want}")
        base = runs["a_dense_chunked"][0]
        agree = {rid: int(np.argmin(np.append(out == base[rid], False)))
                 for rid, out in outs.items()}  # tokens equal before the first miss
        if name == "b_paged_chunked":
            check(all(np.array_equal(outs[r], base[r]) for r in base),
                  "serve_moe: paged tokens != dense tokens")
        clean = sorted(set(outs) - vdrop)
        if drafter is not None:
            check(len(clean) >= 1, "serve_moe: every request had a verify drop")
            for rid in clean:
                check(np.array_equal(outs[rid], base[rid]),
                      f"serve_moe: spec request {rid} (no verify drop) != plain")
        total["paged" if paged else "dense"] += used
        entry = {"phase": "serve_moe", "arch": cfg.name, "run": name,
                 "requests": len(prompts), "prompts": list(MOE_PROMPTS), "max_new": MOE_NEW,
                 "decode_steps": s.decode_steps, "prefill_chunks": s.prefill_chunks,
                 "k2_launches": k2, "k5_launches": k5, "wall_s": wall, "decode_s": s.decode_s,
                 "decode_tok_s": (s.tokens_out - s.admitted) / s.decode_s,
                 "tokens_equal_to_a": agree}
        if routing:
            entry["routing"] = routing
        if drafter is not None:
            entry.update(verify_passes=s.spec_launches, drafted=s.spec_drafted,
                         accepted=s.spec_accepted, verify_dropped=sorted(vdrop),
                         bitwise_equal_plain=clean)
        emit(entry)
    comp, bf16 = compressed_bytes_per_token(cfg, engine)
    dense_cache = engine.alloc_slot_cache()
    dev_bytes = device_bytes_per_token(dense_cache)
    del dense_cache
    card_routing = moe_routing_on_card(engine, cfg, prompts[2])
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    emit({"phase": "serve_moe", "arch": cfg.name, "summary": True,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd, "experts": cfg.n_experts,
          "top_k": cfg.moe_topk, "shared_experts": cfg.n_shared_experts,
          "d_ff_expert": cfg.d_ff_expert, "vocab": cfg.vocab,
          "params": cfg.param_count(), "active_params": cfg.active_param_count(),
          "weights_gb": cfg.param_count() * 2 / 1e9, "engine_s": built,
          "k_spec": [ks.widths, ks.counts], "v_spec": [vs.widths, vs.counts],
          "compressed_bytes_per_token": comp, "device_bytes_per_token": dev_bytes,
          "bf16_bytes_per_token": bf16, "routing_on_card_equals_cpu": card_routing,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    for _, eng, _ in plan:  # the variants share the weights
        eng.params = None
    del plan, runs, eng
    free_engine(engine)
    del engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, engine = config_engine("moonshot-v1-16b-a3b", device, 31, prefill_chunk_pages=0)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in MOONSHOT_PROMPTS]
    outs, s, wall, k2, k5, routing, _ = moe_server_run(engine, cfg, prompts, MOONSHOT_NEW,
                                                       log_routing=True)
    check(k2 == cfg.n_layers * s.decode_steps and k5 == 0,
          f"moonshot: K2 launches {k2} != {cfg.n_layers} x {s.decode_steps} steps")
    total["dense"] += k2
    comp, bf16 = compressed_bytes_per_token(cfg, engine)
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    emit({"phase": "serve_moe", "arch": cfg.name, "run": "dense_monolithic",
          "n_layers": cfg.n_layers, "experts": cfg.n_experts, "top_k": cfg.moe_topk,
          "shared_experts": cfg.n_shared_experts, "vocab": cfg.vocab,
          "params": cfg.param_count(), "weights_gb": cfg.param_count() * 2 / 1e9,
          "engine_s": built, "requests": len(prompts), "prompts": list(MOONSHOT_PROMPTS),
          "max_new": MOONSHOT_NEW, "k_spec": [ks.widths, ks.counts],
          "v_spec": [vs.widths, vs.counts], "decode_steps": s.decode_steps,
          "k2_launches": k2, "wall_s": wall, "decode_s": s.decode_s,
          "decode_tok_s": (s.tokens_out - s.admitted) / s.decode_s, "routing": routing,
          "compressed_bytes_per_token": comp, "bf16_bytes_per_token": bf16,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    free_engine(engine)
    return total


def phase_serve_vlm(device) -> dict:
    """internvl2-2b at full width and depth: Engine.generate at B=2 over
    256 random patch embeddings before 512 text tokens, 32 new tokens. K2
    launches n_layers x decode steps; the prefill's logits finite."""
    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )

    t0 = time.perf_counter()
    cfg, engine = config_engine("internvl2-2b", device, 32, prefill_chunk_pages=0)
    built = time.perf_counter() - t0
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, VLM_TOKENS)),
             "patches": rng.normal(size=(2, cfg.n_patches, cfg.d_model))}
    logits, _ = engine.prefill(batch)
    check(bool(torch.isfinite(logits).all()), "serve_vlm: prefill logits not finite")
    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    t0 = time.perf_counter()
    toks, cache = engine.generate(batch, VLM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = fused_packed_attention.launches
    steps = VLM_NEW  # generate's loop decodes once a token, the last one too
    check(k2 == cfg.n_layers * steps and fused_packed_attention_paged.launches == 0,
          f"serve_vlm: K2 launches {k2} != {cfg.n_layers} x {steps} steps")
    check(toks.shape == (2, VLM_NEW) and (toks >= 0).all() and (toks < cfg.vocab).all(),
          "serve_vlm: tokens out of the vocabulary")
    held = int(cache[0].n_comp[0] + cache[0].n_resid[0])
    check(held == cfg.n_patches + VLM_TOKENS + steps,
          f"serve_vlm: the cache holds {held} tokens")
    comp, bf16 = compressed_bytes_per_token(cfg, engine)
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    emit({"phase": "serve_vlm", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_kv_heads": cfg.n_kv_heads, "G": cfg.n_heads // cfg.n_kv_heads,
          "head_dim": cfg.hd, "batch": 2, "patches": cfg.n_patches,
          "text_tokens": VLM_TOKENS, "max_new": VLM_NEW, "engine_s": built,
          "k_spec": [ks.widths, ks.counts], "v_spec": [vs.widths, vs.counts],
          "k2_launches": k2, "generate_s": wall,
          "generate_tok_s": 2 * VLM_NEW / wall, "compressed_bytes_per_token": comp,
          "bf16_bytes_per_token": bf16})
    free_engine(engine)
    return {"launches": k2}


def phase_encode(device) -> None:
    """hubert-xlarge at full width and depth: encode of B=2 x 1024 random
    frames (non-causal attention, no cache): [2, 1024, 1280], finite; the
    device time of one call by CUDA events."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import get_model, transformer

    cfg = get_arch("hubert-xlarge")
    params = get_model(cfg).init(torch.Generator(device=device).manual_seed(33), cfg)
    gen = torch.Generator(device=device).manual_seed(34)
    frames = torch.randn((2, ENCODE_FRAMES, cfg.d_model), generator=gen, device=device)
    out = transformer.encode(params, cfg, {"frames": frames})  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = transformer.encode(params, cfg, {"frames": frames})
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tuple(out.shape) == (2, ENCODE_FRAMES, cfg.d_model),
          f"encode: output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "encode: output not finite")
    emit({"phase": "encode", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": 2, "frames": ENCODE_FRAMES,
          "params": cfg.param_count(), "device_ms": start.elapsed_time(end),
          "wall_s": wall, "frames_per_s": 2 * ENCODE_FRAMES / wall})
    del params, out


# serve_rwkv / serve_rglru: the recurrent families at full width and depth
RWKV_PROMPTS = (320, 700, 1000, 450, 260, 900)  # 700, 1000, 450, 260: a sequential tail
RWKV_NEW = 16  # 32 before PR 26
RGLRU_PROMPTS = (2048, 700, 450, 900, 260)
RGLRU_NEW = (200, 16, 16, 16, 16)  # the 2048-token row flushes at steps 129 and 193


def solo(eng, prompt, max_new: int) -> list:
    """A request run alone at the server's height: admitted as
    ``SlotServer`` admits it (page-sized chunks, the last fused with the
    insert; monolithic when the engine's chunks are off or the prompt fits
    one), in row 0 of a ``max_batch``-row table with the other rows free,
    decoded a step at a time. Returns its tokens."""
    import numpy as np
    import torch

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


def row_chunked_vs_mono(engine, mono, tokens) -> dict:
    """One prompt admitted by 256-token chunks on ``engine`` and in one
    prefill on ``mono`` (the same weights): the last-token logits and every
    leaf of the admitted state row."""
    import torch

    from repro_torch.utils import tree_flatten

    S = len(tokens)
    bounds = list(range(0, S, 256)) + [S]
    scratch = engine.chunk_init(S)
    for s0, s1 in zip(bounds[:-2], bounds[1:-1]):
        _, scratch = engine.chunk_step(scratch, tokens[s0:s1], s0)
    l_chunk, chunked = engine.chunk_final(engine.alloc_slot_cache(), 0, scratch,
                                          tokens[bounds[-2]:], bounds[-2])
    l_mono, whole = mono.insert_request(mono.alloc_slot_cache(), 0, tokens)
    return {"prompt": S, "chunks": len(bounds) - 1,
            "logits_max_abs_diff": float((l_mono - l_chunk).abs().max()),
            "logits_bitwise_equal": bool(torch.equal(l_mono, l_chunk)),
            "state_bitwise_equal": all(torch.equal(a, b) for a, b in
                                       zip(tree_flatten(chunked)[0], tree_flatten(whole)[0]))}


def recurrent_run(engine, cfg, prompts, news, seed: int):
    """Serve ``prompts`` (``news`` new tokens each) on a fresh SlotServer,
    the K2 launch count from 0. Returns (requests by rid, stats, K2
    launches, wall s, the window caches' n_comp of each row at its
    retirement)."""
    import numpy as np
    import torch

    from repro_torch.kernels.packed_attention import (
        fused_packed_attention,
        fused_packed_attention_paged,
    )
    from repro_torch.serving import Request, SlotServer

    rng = np.random.default_rng(seed)
    server = SlotServer(engine)
    for i, (n, m) in enumerate(zip(prompts, news)):
        server.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, n), max_new=m))
    retired, free_slot = [], engine.free_slot

    def record(cache, slot):
        if cfg.window:
            retired.append(int(cache.cache[0].n_comp[slot]))
        return free_slot(cache, slot)

    engine.free_slot = record
    fused_packed_attention.launches = fused_packed_attention_paged.launches = 0
    t0 = time.perf_counter()
    done = {r.rid: r for r in server.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.free_slot = free_slot
    check(fused_packed_attention_paged.launches == 0, f"{cfg.name}: K5 launched")
    check(len(done) == len(prompts), f"{cfg.name}: not every request finished")
    for r in done.values():
        out = np.asarray(r.output)
        check(out.shape == (r.max_new,) and (out >= 0).all() and (out < cfg.vocab).all(),
              f"{cfg.name} request {r.rid}: output out of the vocabulary")
    return done, server.stats, fused_packed_attention.launches, wall, retired


def phase_serve_rwkv(device) -> dict:
    """rwkv6-1.6b at full width and depth (24 layers, d_model 2048, 32 WKV
    heads of 64, vocab 65,536; random bf16 weights from a seeded
    torch.Generator) through SlotServer, 4 slots, chunked admission of one
    256-token page a step: 6 requests (prompts 320/700/1000/450/260/900,
    four with a sub-chunk WKV tail, five longer than a chunk), RWKV_NEW new
    tokens each. Every request bitwise equal to its solo control at the
    server's height; the same requests through monolithic admission
    bitwise equal; one 1000-token admission's logits and state row equal
    chunked and monolithic. No kernel: rwkv6 keeps no KV cache."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.serving import Engine
    from repro_torch.utils import tree_bytes

    t0 = time.perf_counter()
    cfg, engine = config_engine("rwkv6-1.6b", device, 30, prefill_chunk_pages=1)
    built = time.perf_counter() - t0
    check(engine.pack_cfg.k_spec_static is None, "rwkv6 calibrated a KV spec")
    torch.cuda.reset_peak_memory_stats()
    news = (RWKV_NEW,) * len(RWKV_PROMPTS)
    done, s, k2, wall, _ = recurrent_run(engine, cfg, RWKV_PROMPTS, news, 7)
    check(k2 == 0, f"rwkv6 launched K2 {k2} times")
    mono = Engine(cfg, engine.params, engine.pack_cfg,
                  dataclasses.replace(engine.ecfg, calibrate=False, prefill_chunk_pages=0))
    mdone, ms, _, mwall, _ = recurrent_run(mono, cfg, RWKV_PROMPTS, news, 7)
    agree = {rid: float(np.mean(np.asarray(r.output) == np.asarray(mdone[rid].output)))
             for rid, r in done.items()}
    row_check = row_chunked_vs_mono(engine, mono, done[2].tokens)
    check(all(a == 1.0 for a in agree.values()) and row_check["logits_bitwise_equal"]
          and row_check["state_bitwise_equal"],
          f"rwkv6: chunked != monolithic admission: {agree}, {row_check}")
    t1 = time.perf_counter()
    for rid, r in done.items():
        check(solo(engine, r.tokens, r.max_new) == list(r.output),
              f"rwkv6 request {rid} differs from its solo control")
    ctl_s = time.perf_counter() - t1
    emit({"phase": "serve_rwkv", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "wkv_heads": cfg.wkv_heads, "vocab": cfg.vocab,
          "weights_gb": cfg.param_count() * 2 / 1e9, "engine_s": built,
          "requests": len(RWKV_PROMPTS), "prompts": list(RWKV_PROMPTS), "max_new": RWKV_NEW,
          "decode_steps": s.decode_steps, "prefill_chunks": s.prefill_chunks,
          "slot_reuses": s.slot_reuses, "wall_s": wall, "decode_s": s.decode_s,
          "decode_tok_s": (s.tokens_out - s.admitted) / s.decode_s,
          "monolithic_wall_s": mwall,
          "monolithic_decode_tok_s": (ms.tokens_out - ms.admitted) / ms.decode_s,
          "chunked_eq_monolithic": agree, "row_chunked_vs_monolithic": row_check,
          "bitwise_equal_solo": True, "solo_controls_s": ctl_s,
          "state_bytes_per_row": tree_bytes(engine.alloc_slot_cache()) // engine.ecfg.max_batch,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    del mono, done, mdone
    free_engine(engine)
    return {"launches": 0}


def phase_serve_rglru(device) -> dict:
    """recurrentgemma-9b at full width and depth (38 layers: 12 groups of
    two RG-LRU blocks and a local-attention block, then 2 RG-LRU blocks;
    d_model 4096, 16 query heads over 1 kv head of 256, window 2048, LRU
    width 4096, vocab 256,000; random weights), policy packkv (calibrated
    over the window), 4 slots, chunked admission: 5 requests (prompts
    2048/700/450/900/260; 200 new tokens for the 2048-token one, so its
    rings flush at decode steps 129 and 193 over the two oldest blocks, 32
    for the others). K2 launched once an attention layer and decode step
    (G = 16, D = 256), the long row's n_comp at retirement = 2048 + 128;
    every request bitwise equal to its solo control at the server's
    height; the 2048-token admission's logits and state row bitwise equal
    chunked and monolithic.
    Then K2 and K5 at this shape (B = 4, H_kv = 1, G = 16, D = 256, a
    2048-token window, the engine's calibrated spec) against their plain
    versions, timed beside the byte bound and SDPA."""
    import dataclasses

    import torch

    from repro_torch.serving import Engine
    from repro_torch.utils import tree_bytes

    t0 = time.perf_counter()
    cfg, engine = config_engine("recurrentgemma-9b", device, 31, prefill_chunk_pages=1)
    built = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    done, s, k2, wall, retired = recurrent_run(engine, cfg, RGLRU_PROMPTS, RGLRU_NEW, 8)
    n_attn = cfg.n_layers // 3
    check(k2 > 0 and k2 == n_attn * s.decode_steps,
          f"recurrentgemma-9b: K2 launches {k2} != {n_attn} x {s.decode_steps} steps")
    check(max(retired) == cfg.window + 128,
          f"recurrentgemma-9b: the long row's n_comp {max(retired)}, not a wrapped "
          f"{cfg.window + 128}")
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    for rid, r in done.items():
        check(solo(engine, r.tokens, r.max_new) == list(r.output),
              f"recurrentgemma-9b request {rid} differs from its solo control")
    ctl_s = time.perf_counter() - t1
    mono = Engine(cfg, engine.params, engine.pack_cfg,
                  dataclasses.replace(engine.ecfg, calibrate=False, prefill_chunk_pages=0))
    row_check = row_chunked_vs_mono(engine, mono, done[0].tokens)
    check(row_check["logits_bitwise_equal"] and row_check["state_bitwise_equal"],
          f"recurrentgemma-9b: chunked != monolithic admission: {row_check}")
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    window = engine.alloc_slot_cache()
    emit({"phase": "serve_rglru", "arch": cfg.name, "n_layers": cfg.n_layers,
          "attention_layers": n_attn, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd, "window": cfg.window,
          "lru_dim": cfg.lru_dim, "vocab": cfg.vocab,
          "weights_gb": cfg.param_count() * 2 / 1e9, "engine_s": built,
          "k_spec": [ks.widths, ks.counts], "v_spec": [vs.widths, vs.counts],
          "requests": len(RGLRU_PROMPTS), "prompts": list(RGLRU_PROMPTS),
          "max_new": list(RGLRU_NEW), "n_comp_at_retirement": sorted(retired),
          "decode_steps": s.decode_steps, "k2_launches": k2,
          "prefill_chunks": s.prefill_chunks, "slot_reuses": s.slot_reuses,
          "wall_s": wall, "decode_s": s.decode_s,
          "decode_tok_s": (s.tokens_out - s.admitted) / s.decode_s,
          "bitwise_equal_solo": True, "solo_controls_s": ctl_s,
          "row_chunked_vs_monolithic": row_check,
          "window_cache_bytes": tree_bytes(window.cache),
          "state_bytes": tree_bytes(window), "peak_memory_bytes": peak})
    del mono, done, window
    # K2 and K5 at the family's decode shape under its calibrated spec
    gen = torch.Generator(device=device).manual_seed(9)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    B, G = engine.ecfg.max_batch, cfg.n_heads // cfg.n_kv_heads
    kernel = k2_row("calibrated", cfg.name, B, cfg.n_kv_heads, G, cfg.hd, ks, vs, gen, flush)
    paged = k5_rows(cfg.name, B, cfg.n_kv_heads, G, cfg.hd, ks, vs, (64, 256), gen, flush)
    free_engine(engine)
    return {"launches": k2, "k2": kernel, "k5": paged}


# train: minicpm-2b at full width and depth under its own WSD schedule
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet), at 700 W


def plain_wsd_lr(step: int, lr: float, warmup: int, total: int, decay_frac: float):
    """The WSD schedule's written formula in numpy f32 (the yardstick of
    ``training.optimizer.make_schedule`` on the card)."""
    import numpy as np

    f = np.float32
    ds = int(total * (1 - decay_frac))
    if step < warmup:
        x = f(step) / f(max(warmup, 1))
    elif step < ds:
        x = f(1.0)
    else:
        x = f(1.0) - min(max(f(step - ds) / f(max(total - ds, 1)), f(0.0)), f(1.0))
    return f(lr) * x


def phase_train(device, card: str) -> None:
    """minicpm-2b trained at full width and depth (40 layers, d_model 2304,
    36 heads of 64, d_ff 5760, vocab 122,753; random bf16 weights from a
    seeded torch.Generator) for TRAIN_STEPS steps of 4 x 1024 tokens from
    ShardedTokenStream, AdamW under the config's own WSD schedule
    (warmup 1, total TRAIN_STEPS, lr 1e-3), grad_accum 1: every loss and
    grad norm finite, the last loss below the first, the lr of every step
    within an f32 ulp of the plain f32 formula. Reports each step's loss,
    grad norm and ms (host clock around the step and the loss's host
    read), the median step, tokens a second, 6 N tokens / step time as a
    share of the bf16 peak, and the peak memory."""
    import gc
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_arch, minicpm_2b
    from repro_torch.data import ShardedTokenStream
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_training, make_schedule, make_train_step
    from repro_torch.utils import tree_flatten

    cfg = get_arch("minicpm-2b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params, opt = init_training(api, cfg, torch.Generator(device=device).manual_seed(40))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_flatten(params)[0])
    n_matmul = n_params - params["embed"].numel()  # the table is looked up
    oc = OptConfig(lr=1e-3, schedule=minicpm_2b.TRAIN_SCHEDULE, warmup_steps=1,
                   total_steps=TRAIN_STEPS)
    sched = make_schedule(oc)
    step_fn = make_train_step(api, cfg, oc, grad_accum=1)
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=TRAIN_BATCH,
                                seq=TRAIN_SEQ, seed=0)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, lrs, ms = [], [], [], []
    lr_err = 0.0
    for _ in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(device) for k, v in stream.next_batch().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        step = int(m["step"])
        lr = float(sched(m["step"]))
        want = plain_wsd_lr(step, oc.lr, oc.warmup_steps, oc.total_steps, oc.decay_frac)
        lr_err = max(lr_err, abs(lr - float(want)))
        lrs.append(lr)
        print(f"train step {step}: loss {losses[-1]:.4f} grad_norm {gnorms[-1]:.4f} "
              f"lr {lr:.6g} {ms[-1]:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"minicpm-2b training: a loss or grad norm is not finite: {losses} {gnorms}")
    check(losses[-1] < losses[0], f"minicpm-2b training: loss did not fall: {losses}")
    ulp = float(np.spacing(np.float32(oc.lr)))
    check(lr_err <= ulp, f"WSD lr off the plain f32 formula by {lr_err} (> {ulp})")
    step_ms = statistics.median(ms[1:])  # the first step allocates
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads, "head_dim": cfg.hd,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": n_params,
          "matmul_params": n_matmul, "schedule": oc.schedule, "lr": oc.lr,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "grad_accum": 1, "init_s": init_s, "losses": losses, "grad_norms": gnorms,
          "lrs": lrs, "lr_max_abs_err_vs_plain_f32": lr_err, "step_ms": ms,
          "median_step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
          "six_n_tokens_share_of_bf16_peak": 6 * n_matmul * tokens / (step_ms / 1e3)
          / BF16_FLOPS, "bf16_peak_flops": BF16_FLOPS,
          "peak_memory_bytes": peak, "nvidia_smi": card})
    del params, opt, m, batch
    gc.collect()
    torch.cuda.empty_cache()


LAUNCH_STEPS = 10  # 40 before PR 26: cut to make room for train_dp
LAUNCH_ARGS = ["--arch", "smollm-135m", "--steps", str(LAUNCH_STEPS), "--batch", "8",
               "--seq", "256", "--grad-accum", "2", "--schedule", "wsd",
               "--ckpt-every", str(LAUNCH_STEPS // 2), "--seed", "0"]


def npz_diff(a: str, b: str) -> dict:
    """Leaves of two arrays.npz files that differ: {key: max abs diff}
    (bf16 leaves read through their bits); empty when every leaf is
    bitwise equal."""
    import numpy as np
    import torch

    out = {}
    with np.load(a) as fa, np.load(b) as fb:
        check(sorted(fa.files) == sorted(fb.files), f"{a} and {b} hold other leaves")
        for k in fa.files:
            x, y = fa[k], fb[k]
            if x.tobytes() == y.tobytes():
                continue
            if x.dtype == np.uint16:  # bf16 bits
                x, y = (torch.from_numpy(z.view(np.int16).copy()).view(torch.bfloat16)
                        .float().numpy() for z in (x, y))
            out[k] = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
    return out


def phase_train_launch(device, card: str) -> None:
    """smollm-135m at full width (30 layers, d_model 576, 163 M parameters:
    a 1.6 GB checkpoint with the moments) through ``launch.train.main``:
    batch 8 x 256 tokens, grad_accum 2, WSD, lr 3e-4. Run A: 10 steps,
    a checkpoint every 5; run B: A's step-5 checkpoint alone in a fresh
    directory (what a run preempted after step 5 leaves), then --resume
    to 10. A's and B's step-10 checkpoints must be bitwise equal leaf for
    leaf (parameters, moments, step). Then one step at grad_accum 1 against
    one at 2 from the same parameters (lr 1e-3, warmup 1): the loss within
    1e-3 and every parameter within 5e-3, the reference's own bounds; and,
    since Adam's first step moves a parameter by ~lr whatever its gradient,
    the gradients: the grad norm within 1e-2 relative and each first
    moment within 0.1 of its leaf's max abs (the bars of
    tests/test_torch_training.py::test_grad_accum_holds_gradients)."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import ShardedTokenStream
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_training, make_train_step
    from repro_torch.utils import tree_flatten, tree_map

    def run(argv: list) -> tuple[str, float]:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            check(launch_train.main(argv) == 0, f"train launcher failed: {argv}")
        return buf.getvalue(), time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        out_a, s_a = run(LAUNCH_ARGS + ["--ckpt-dir", a])
        mid = f"step_{LAUNCH_STEPS // 2:08d}"
        shutil.copytree(os.path.join(a, mid), os.path.join(b, mid))
        out_b2, s_b2 = run(LAUNCH_ARGS + ["--ckpt-dir", b, "--resume"])
        for line in (out_a + out_b2).splitlines():
            print(f"launcher: {line}", flush=True)
        check(f"resumed from step {LAUNCH_STEPS // 2}" in out_b2,
              f"run B did not resume from step {LAUNCH_STEPS // 2}")
        ckpt = lambda d: os.path.join(d, f"step_{LAUNCH_STEPS:08d}", "arrays.npz")
        ckpt_bytes = os.path.getsize(ckpt(a))
        diff = npz_diff(ckpt(a), ckpt(b))
    if diff:
        emit({"phase": "train_launch", "resumed_vs_uninterrupted_max_abs_diff": diff})
    check(not diff, f"resumed run differs from the uninterrupted one: {diff}")
    # grad_accum 1 against 2, one step from the same parameters
    cfg = get_arch("smollm-135m")
    api = get_model(cfg)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             ShardedTokenStream(vocab=cfg.vocab, batch_per_host=8, seq=256,
                                seed=1).next_batch().items()}
    p1, o1 = init_training(api, cfg, torch.Generator(device=device).manual_seed(41))
    p2, o2 = tree_map(torch.clone, p1), tree_map(torch.clone, o1)
    p1, o1, m1 = make_train_step(api, cfg, oc, grad_accum=1)(p1, o1, batch)
    p2, o2, m2 = make_train_step(api, cfg, oc, grad_accum=2)(p2, o2, batch)
    loss_diff = abs(float(m1["loss"]) - float(m2["loss"]))
    param_diff = max(float((x.float() - y.float()).abs().max())
                     for x, y in zip(tree_flatten(p1)[0], tree_flatten(p2)[0]))
    g1, g2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    norm_gap = abs(g1 - g2) / g1
    mu_gap = max(float((x - y).abs().max() / x.abs().max())
                 for x, y in zip(tree_flatten(o1.mu)[0], tree_flatten(o2.mu)[0]))
    check(loss_diff < 1e-3 and param_diff < 5e-3 and norm_gap <= 1e-2 and mu_gap <= 0.1,
          f"grad_accum 1 vs 2: loss {loss_diff}, params {param_diff}, "
          f"grad norm {norm_gap} relative, first moments {mu_gap} of a leaf's max")
    emit({"phase": "train_launch", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(), "argv": LAUNCH_ARGS,
          "checkpoint_bytes": ckpt_bytes, "run_a_s": s_a,
          "run_b_resumed_s": s_b2, "resumed_bitwise_equal_uninterrupted": True,
          "grad_accum_1_vs_2": {"loss_abs_diff": loss_diff,
                                "param_max_abs_diff": param_diff,
                                "grad_norms": [g1, g2], "grad_norm_rel_gap": norm_gap,
                                "first_moment_max_rel_gap": mu_gap,
                                "losses": [float(m1["loss"]), float(m2["loss"])]},
          "nvidia_smi": card})
    del p1, p2, o1, o2, batch
    torch.cuda.empty_cache()


DP_RANKS, DP_STEPS, DP_BATCH, DP_SEQ, DP_SEED = 2, 2, 8, 256, 42


def leaf_digests(tree) -> dict:
    """{path: sha256 of the leaf's bytes} (bf16 through its int16 bits)."""
    import hashlib

    import torch

    from repro_torch.utils import tree_flatten_with_path

    out = {}
    for path, x in tree_flatten_with_path(tree)[0]:
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        out[".".join(path)] = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
    return out


def dp_setup(device, smoke: bool):
    """smollm-135m's model (its smoke config to rehearse on the CPU),
    optimizer config and batches of the train_dp phase (the ranks and the
    control make the same ones)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import ShardedTokenStream
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig

    cfg = get_arch("smollm-135m", smoke=smoke)
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=DP_BATCH, seq=DP_SEQ,
                                seed=DP_SEED)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in stream.next_batch().items()}
               for _ in range(DP_STEPS)]
    return cfg, get_model(cfg), OptConfig(lr=1e-3, warmup_steps=1, total_steps=10), batches


def cuda_sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def train_dp_rank(rank: int, world: int, d: str, dev: str, smoke: bool) -> None:
    """One rank of the train_dp phase (spawned: this module is its main)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.distributed.exchange import sum_in_rank_order
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import init_training, make_train_step
    from repro_torch.training.train import (
        _accumulate,
        _row_block,
        gather_opt_state,
        shard_opt_state,
    )
    from repro_torch.utils import tree_flatten

    device = torch.device(dev)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'init')}",
                            world_size=world, rank=rank)
    try:
        cfg, api, oc, batches = dp_setup(device, smoke)
        mesh = make_debug_mesh(data=world, device=device)
        params, opt = init_training(api, cfg, torch.Generator(device=device).manual_seed(DP_SEED))
        specs = sharding.opt_state_specs(params, mesh)
        opt = shard_opt_state(opt, specs, mesh)
        step_fn = make_train_step(api, cfg, oc, 1, accum_pspecs=specs)
        cuda = device.type == "cuda"
        cuda_sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        metrics, ms = [], []
        sharding.set_active_mesh(mesh)
        try:
            for b in batches:
                cuda_sync(device)
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, b)
                metrics.append([float(m["loss"]), float(m["grad_norm"]), int(m["step"])])
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() if cuda else None
            # the exchange alone: this rank's gradients of its rows, summed
            # in rank order as the step sums them
            leaves, treedef = tree_flatten(params)
            _, grads = _accumulate(api, cfg, leaves, treedef, _row_block(batches[0], mesh), 1)
            dist.barrier()
            cuda_sync(device)
            t0 = time.perf_counter()
            for g in grads:
                sum_in_rank_order(g, mesh.dp_group, world)
            cuda_sync(device)
            exchange_ms = (time.perf_counter() - t0) * 1e3
            grad_bytes = sum(g.numel() * g.element_size() for g in grads)
            del grads
        finally:
            sharding.set_active_mesh(None)
        full = gather_opt_state(opt, specs, params, mesh)
        local_moment_bytes = sum(x.numel() * 4 for x in tree_flatten(opt.mu)[0]) * 2
        torch.save({"metrics": metrics, "ms": ms, "peak": peak, "exchange_ms": exchange_ms,
                    "grad_bytes": grad_bytes, "moment_bytes": local_moment_bytes,
                    "params": leaf_digests(params), "mu": leaf_digests(full.mu),
                    "nu": leaf_digests(full.nu)}, os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_train_dp(device, card: str, smoke: bool = False) -> None:
    """Two ranks on this one card, against this process's grad_accum 2
    run (see the module docstring, phase 20)."""
    import gc
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.training import init_training, make_train_step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as d:
        t0 = time.perf_counter()
        mp.spawn(train_dp_rank, args=(DP_RANKS, d, str(device), smoke), nprocs=DP_RANKS,
                 join=True)
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    cfg, api, oc, batches = dp_setup(device, smoke)
    params, opt = init_training(api, cfg, torch.Generator(device=device).manual_seed(DP_SEED))
    step_fn = make_train_step(api, cfg, oc, grad_accum=DP_RANKS)
    metrics, ms = [], []
    for b in batches:
        cuda_sync(device)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        metrics.append([float(m["loss"]), float(m["grad_norm"]), int(m["step"])])
        ms.append((time.perf_counter() - t0) * 1e3)
    want = {"params": leaf_digests(params), "mu": leaf_digests(opt.mu),
            "nu": leaf_digests(opt.nu)}
    for r, res in enumerate(ranks):
        check(res["metrics"] == metrics,
              f"train_dp rank {r}: metrics {res['metrics']} != grad_accum 2's {metrics}")
        for part in ("params", "mu", "nu"):
            bad = [k for k, v in want[part].items() if res[part].get(k) != v]
            check(not bad and res[part].keys() == want[part].keys(),
                  f"train_dp rank {r}: {part} differ from grad_accum 2's: {bad[:8]}")
    emit({"phase": "train_dp", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(), "ranks": DP_RANKS,
          "device": f"{device} shared", "backend": "gloo", "zero1": True,
          "batch": DP_BATCH, "seq": DP_SEQ, "steps": DP_STEPS,
          "metrics_loss_gnorm_step": metrics, "bitwise_equal_grad_accum_2": True,
          "rank_step_ms": [res["ms"] for res in ranks],
          "rank_peak_memory_bytes": [res["peak"] for res in ranks],
          "exchange_ms": [res["exchange_ms"] for res in ranks],
          "exchange_grad_bytes": ranks[0]["grad_bytes"],
          "rank_moment_bytes": [res["moment_bytes"] for res in ranks],
          "control_step_ms": ms, "ranks_wall_s": ranks_s, "nvidia_smi": card})
    del params, opt, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


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
        for shape, B, h_kv, G, _ in MATVEC_SHAPES:
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



# storage: the paper's storage tier (quantize -> repack -> bit-pack, the
# block stream) over llama2-7b's full-width K/V and synthetic K/V of the
# same shape
STORAGE_TOKENS = 512  # one prompt: 8 blocks of 64 a (layer, kv head); 1024 before PR 26
STORAGE_MODES = ("none", "median_v", "greedy_joint")
STORAGE_SAMPLE_BLOCKS = 2  # blocks 0-1 of every head of the first and last layer
STORAGE_SEED = 21  # input A's prompt; input B's K and V streams
STORAGE_GROUP = 8  # input B's layers a worker task
STORAGE_WORKERS = 2  # worker processes making input B (more slow input A's launches)
# the storage-tier benchmarks' llama2-7b-like profile; V carries token
# categories and half the channel outliers
STORAGE_K_PROFILE = dict(channel_scale=2.0, smooth=0.88, noise=0.20,
                         outlier_frac=0.05, spike_frac=0.10, spike_mag=4.0)
STORAGE_V_PROFILE = dict(STORAGE_K_PROFILE, n_patterns=4, pattern_scale=1.2,
                         outlier_frac=0.025)


def model_kv(engine, cfg, tokens: int, seed: int):
    """Every layer's K and V of one random prompt, prefilled with policy
    'none' on dense storage as the engine's calibration does: f32 [layers
    x kv heads, tokens, head dim] each."""
    import dataclasses

    import numpy as np
    import torch

    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, (1, tokens))
    none_cfg = dataclasses.replace(engine.pack_cfg, policy="none", paged=False)
    _, cache = engine.api.prefill(engine.params, cfg, none_cfg, tokens,
                                  {"tokens": torch.as_tensor(prompt, dtype=torch.int32,
                                                             device=engine.device)})
    check(all(int(c.n_comp.min()) == tokens for c in cache),
          "the prefill left tokens outside the raw region")
    k = torch.cat([c.raw_k[0].float() for c in cache])
    v = torch.cat([c.raw_v[0].float() for c in cache])
    return k, v


def synthetic_part(layers: int, n_kv: int, hd: int, tokens: int, seed: int,
                   part: int, group: int):
    """``synthetic_kv`` of ``layers`` layers of a model's K (part 0) or V
    (part 1), layers as the batch, from the fixed stream (seed, part,
    group): f32 numpy [layers x kv heads, tokens, head dim]. Runs in a
    worker process."""
    import numpy as np

    from repro_torch.data import synthetic_kv

    rng = np.random.default_rng(np.random.SeedSequence([seed, part, group]))
    profile = STORAGE_V_PROFILE if part else STORAGE_K_PROFILE
    x = synthetic_kv(rng, layers, n_kv, tokens, hd, **profile)
    return x.reshape(-1, tokens, hd)


def part_cr(stream, part: str) -> float:
    """K- or V-only storage ratio, counted as the storage-tier tables count
    it: a block's total bits plus 32 bits a token."""
    bits = vals = 0
    for e in stream.entries:
        blk = e.k_block if part == "k" else e.v_block
        bits += blk.total_bits() + e.n_tokens * 32
        vals += e.n_tokens * blk.shape[1]
    return vals * 16 / bits


def raw_bytes(t):
    """A tensor's bytes, flat (to compare any dtype bitwise)."""
    import torch

    return t.contiguous().reshape(-1).view(torch.uint8)


def entry_arrays(e) -> dict:
    """One stream entry's integer and metadata fields on the host."""
    return {"perm": e.perm.cpu(), "k_meta": e.k_meta.cpu(), "v_meta": e.v_meta.cpu(),
            **{f"{p}_{f}": getattr(getattr(e, f"{p}_block"), f).cpu()
               for p in ("k", "v") for f in ("payload", "widths", "mins")}}


def storage_checks(k, v, stream) -> float:
    """On the card, every block of ``stream`` (which ``extend`` filled
    from k, v [H, L, D]) re-encoded chunk by chunk: the bit-packing round
    trip exact, every value within half a scale (plus the f32 rounding of
    x - lo and of the quotient) of its decode, and the payload bits equal
    to the stream's. Returns the encode's device ms (CUDA events)."""
    import torch

    from repro_torch.core import block_format as bf
    from repro_torch.core.bitpack import unpack_block

    D = k.shape[-1]
    kb, vb = k.reshape(-1, bf.BLOCK, D), v.reshape(-1, bf.BLOCK, D)
    total_ms, bits = 0.0, 0
    for s in range(0, kb.shape[0], bf.EXTEND_CHUNK_BLOCKS):
        xs = (kb[s:s + bf.EXTEND_CHUNK_BLOCKS], vb[s:s + bf.EXTEND_CHUNK_BLOCKS])
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        enc = bf.encode_blocks(*xs, stream.pack_size, stream.repack_mode,
                               stream.k_quant, stream.v_quant)
        b.record()
        b.synchronize()
        total_ms += a.elapsed_time(b)
        rows = enc.perm.unsqueeze(-1)
        for x, packed, meta, quant in ((xs[0], enc.k, enc.k_meta, stream.k_quant),
                                       (xs[1], enc.v, enc.v_meta, stream.v_quant)):
            q, _, _ = bf.quant_tokenwise(x, quant)
            q = q.gather(1, rows.expand_as(q))
            check(torch.equal(unpack_block(packed), q), "unpack(pack(q)) != q")
            xp = x.gather(1, rows.expand_as(x))
            scale, lo = meta[..., :1], meta[..., 1:]
            dec = q.double() * scale.double() + lo.double()
            eps = torch.finfo(torch.float32).eps
            bound = (scale.double() * (0.5 + quant.max_q * eps)
                     + (xp.abs() + lo.abs()).double() * eps)
            check(bool(((xp.double() - dec).abs() <= bound).all()),
                  "a decoded value off by more than half a scale")
            bits += int(packed.total_bits().sum())
    want = sum(e.k_block.total_bits() + e.v_block.total_bits() for e in stream.entries)
    check(bits == want, f"re-encoded bits {bits} != the stream's {want}")
    return total_ms


def storage_sample(k, v, stream, n_heads: int, n_kv: int) -> dict:
    """The device stream's entries of blocks 0-1 of every head of the first
    and last layer against the plain CPU path (``append``, one block at a
    time) on the same values: perm, scale / zero, widths, minima, payload
    words and the serialized stream with its directory, bitwise."""
    import torch

    from repro_torch.core.block_format import BLOCK, CompressedKVStream

    nb = k.shape[1] // BLOCK
    heads = list(range(n_kv)) + list(range(n_heads - n_kv, n_heads))
    picked = [h * nb + b for h in heads for b in range(STORAGE_SAMPLE_BLOCKS)]
    plain = CompressedKVStream(pack_size=stream.pack_size, repack_mode=stream.repack_mode,
                               k_quant=stream.k_quant, v_quant=stream.v_quant)
    kc, vc = k.cpu(), v.cpu()
    t0 = time.perf_counter()
    for i in picked:
        h, b = divmod(i, nb)
        tokens = slice(b * BLOCK, (b + 1) * BLOCK)
        plain.append(kc[h, tokens], vc[h, tokens], h, b * BLOCK)
    plain_s = time.perf_counter() - t0
    dev = CompressedKVStream(pack_size=stream.pack_size, repack_mode=stream.repack_mode,
                             entries=[stream.entries[i] for i in picked])
    for d, p in zip(dev.entries, plain.entries):
        check((d.head, d.token_start) == (p.head, p.token_start), "sample out of order")
        da, pa = entry_arrays(d), entry_arrays(p)
        for name in da:
            check(torch.equal(raw_bytes(da[name]), raw_bytes(pa[name])),
                  f"{stream.repack_mode}: block ({d.head}, {d.token_start}) {name} "
                  "differs between the card and the CPU path")
    (dflat, ddir), (pflat, pdir) = dev.serialize(), plain.serialize()
    check(ddir == pdir and torch.equal(dflat.cpu(), pflat),
          f"{stream.repack_mode}: the serialized sample differs")
    return {"sample_blocks": len(picked), "sample_words": int(pflat.numel()),
            "sample_plain_cpu_s": plain_s}


def phase_storage(engine, cfg, card: str) -> None:
    """The storage tier over llama2-7b's full-width K/V (input A, the
    model's own prefill; input B, ``synthetic_kv`` of the same shape):
    for each repack mode the K, V and joint ratios beside KIVI's at the
    same rel scale, the bytes a token beside the compute tier's and
    bf16's, the pipeline's device time, and the checks."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    # input B is made on the host, STORAGE_GROUP layers a task, by worker
    # processes while input A runs
    check(cfg.n_layers % STORAGE_GROUP == 0, f"{cfg.n_layers} layers in groups of "
          f"{STORAGE_GROUP}")
    groups = range(cfg.n_layers // STORAGE_GROUP)
    with ProcessPoolExecutor(STORAGE_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        t_in = time.perf_counter()
        futures = [[pool.submit(synthetic_part, STORAGE_GROUP, cfg.n_kv_heads, cfg.hd,
                                STORAGE_TOKENS, STORAGE_SEED, part, g) for g in groups]
                   for part in (0, 1)]
        storage_input(engine, cfg, card, "model",
                      model_kv(engine, cfg, STORAGE_TOKENS, STORAGE_SEED))
        ks, vs = (torch.cat([torch.from_numpy(f.result()).cuda() for f in fs])
                  for fs in futures)
        synth_s = time.perf_counter() - t_in
    storage_input(engine, cfg, card, "synthetic", (ks, vs),
                  {"synthetic_ready_s": synth_s})
    del ks, vs
    torch.cuda.empty_cache()


def storage_input(engine, cfg, card: str, source: str, kv, extra=None) -> None:
    """The storage phase's rows of one input (k, v f32 [H, L, D] on the
    card), one a repack mode."""
    import gc

    import torch

    from repro_torch.core.block_format import BLOCK, CompressedKVStream
    from repro_torch.core.kivi import kivi_cr_from_rel_scale

    k, v = kv
    comp_bytes, bf16_bytes = compressed_bytes_per_token(cfg, engine)
    n_heads = cfg.n_layers * cfg.n_kv_heads
    check(tuple(k.shape) == tuple(v.shape) == (n_heads, STORAGE_TOKENS, cfg.hd)
          and bool(torch.isfinite(k).all() and torch.isfinite(v).all()),
          f"{source}: K/V misshapen or not finite")
    for mode in STORAGE_MODES:
        stream = CompressedKVStream(pack_size=8, repack_mode=mode)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        stream.extend(k, v)
        b.record()
        b.synchronize()
        wall = time.perf_counter() - t0
        blocks = len(stream.entries)
        check(blocks == n_heads * STORAGE_TOKENS // BLOCK, f"{blocks} blocks")
        encode_ms = storage_checks(k, v, stream)
        sample = (storage_sample(k, v, stream, n_heads, cfg.n_kv_heads)
                  if mode != "none" else {})
        kivi_k = kivi_cr_from_rel_scale(stream.k_quant.rel_scale)
        kivi_v = kivi_cr_from_rel_scale(stream.v_quant.rel_scale)
        kivi_joint = 2 / (1 / kivi_k + 1 / kivi_v)  # K and V hold as many values
        k_cr, v_cr = part_cr(stream, "k"), part_cr(stream, "v")
        joint = stream.compression_ratio()
        total_bits = stream.total_bits()
        emit({"phase": "storage", "input": source, "repack": mode, "pack_size": 8,
              "k_rel": stream.k_quant.rel_scale, "v_rel": stream.v_quant.rel_scale,
              "blocks": blocks, "shape": [n_heads, STORAGE_TOKENS, cfg.hd],
              "k_cr": k_cr, "v_cr": v_cr, "joint_cr": joint,
              "kivi_k_cr": kivi_k, "kivi_v_cr": kivi_v, "kivi_joint_cr": kivi_joint,
              "gain_over_kivi_pct": {"k": (k_cr / kivi_k - 1) * 100,
                                     "v": (v_cr / kivi_v - 1) * 100,
                                     "joint": (joint / kivi_joint - 1) * 100},
              "storage_bytes_per_token": total_bits / 8 / STORAGE_TOKENS,
              "compute_tier_bytes_per_token": comp_bytes,
              "bf16_bytes_per_token": bf16_bytes,
              "extend_ms": a.elapsed_time(b), "extend_wall_s": wall,
              "encode_device_ms": encode_ms,
              "blocks_per_s": blocks / (encode_ms / 1e3),
              **sample, **(extra or {}), "nvidia_smi": card})
        del stream
        gc.collect()


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
    timed(phase_storage, engine, cfg, card)
    # smollm-135m's engine: its calibrated spec is the kernel phases' D=64
    # one; serve_configs serves it first
    smollm = config_engine("smollm-135m", device, 10, prefill_chunk_pages=0)
    engines = {128: engine, 64: smollm[1]}

    k2 = timed(phase_kernel, engines, device)
    k5 = timed(phase_kernel_paged, engines, device)
    serve = timed(phase_serve, engine, cfg, device)
    serve_paged = timed(phase_serve_paged, engine, cfg, serve)
    spec = timed(phase_serve_spec, engine, cfg, serve, serve_paged)
    del serve_paged["engine"]
    timed(phase_spec_rows, engine, cfg)
    preempt = timed(phase_serve_preempt, engine, cfg)
    session = timed(phase_serve_session, engine, cfg)
    faults = timed(phase_serve_faults, engine, cfg)
    mesh = timed(phase_serve_mesh, engine, cfg, serve, serve_paged, device)
    mv = timed(phase_matvec, engine, device)
    configs = timed(phase_serve_configs, smollm, device)
    # qwen3-32b's 65.5 GB of weights need the card to themselves
    del smollm, engines, params
    free_engine(engine)
    del engine
    prefix = timed(phase_serve_prefix, device)
    moe_runs = timed(phase_serve_moe, device)
    vlm = timed(phase_serve_vlm, device)
    timed(phase_encode, device)
    timed(phase_serve_rwkv, device)
    rglru = timed(phase_serve_rglru, device)
    timed(phase_train, device, card)
    timed(phase_train_launch, device, card)
    timed(phase_train_dp, device, card)
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    print(card, flush=True)
    row = lambda name, source, replaces, k, launches: {
        "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": k["library_ms"]}
    emit({"kernels": [
        row("fused_packed_attention", "packed_attention.cu",
            "src/repro/kernels/packed_attention.py:172", k2,
            serve["launches"] + spec["dense"] + configs["launches"] + preempt["dense"]
            + session["dense"] + mesh["dense"] + moe_runs["dense"] + vlm["launches"]
            + rglru["launches"]),
        row("fused_packed_attention_paged", "packed_attention.cu",
            "src/repro/kernels/packed_attention.py:375", k5,
            serve_paged["launches"] + spec["paged"] + prefix["launches"] + preempt["paged"]
            + session["paged"] + faults["paged"] + mesh["paged"] + moe_runs["paged"]),
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
