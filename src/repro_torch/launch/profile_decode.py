"""Where a decode step's time goes: torch.profiler over the serving engine.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode

Builds the engine as ``chip_smoke.py``'s serve phases do (``--arch``,
llama2-7b by default, at full width, random weights, policy packkv,
capacity 2048, decode_chunk 8; ``--paged``: the page pool, ``--page-size``
tokens a page), admits ``--batch`` requests of ``--prompt-len`` tokens in
one step (monolithic admission), runs one decode launch as warm-up, then
profiles ``--launches`` more. Prints one JSON line whose ``plain`` block
holds, per decode step: wall and device-busy milliseconds, the device's
idle share, the bf16 GEMMs' device time (cuBLAS kernels), K2's (dense) or
K5's (paged) device time and launches, and the kernels that took the most
device time. On a CPU (``--smoke --device cpu``) it profiles the host only.

``--spec-k K`` adds a ``verify`` block, the same per pass: ``--launches``
speculative verify passes over the same requests on a speculative engine
sharing the weights, its drafter proposing K tokens a row every launch (no
backoff, no watchdog), so each launch is one pass over a window of K + 1
positions. Both engines run their decode GEMMs at that window's height.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import ARCHS, get_arch
from ..core.policy import get_policy
from ..distributed import StragglerMonitor
from ..models import get_model
from ..serving import Engine, EngineConfig, Request, SlotServer

ATTENTION_KERNEL = "packed_attention_span_kernel"  # K2 and K5 (csrc)


class FixedDrafter:
    """Proposes ``k`` copies of token 1 for every row: a verify pass of a
    full window each launch, whatever the acceptance."""

    def seed(self, slot, tokens):
        pass

    def extend(self, slot, tokens):
        pass

    def drop(self, slot):
        pass

    def draft(self, slot, k):
        return [1] * k


def profile(server: SlotServer, launches: int, cuda: bool, top: int) -> dict:
    """Profile ``launches`` scheduler steps; per model pass (a plain decode
    step or a verify pass): wall and device-busy ms, the idle share, the
    GEMMs' and the attention kernel's device ms and the top kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    steps0 = server.stats.decode_steps
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(launches):
            server.step()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = server.stats.decode_steps - steps0
    kernels: dict[str, list] = {}  # device events only: kernels and copies
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    rows = sorted(((us, name, n) for name, (us, n) in kernels.items()), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    # cuBLAS's GEMM kernels (nvjet_* on Hopper; *gemm* elsewhere)
    gemm_ms = sum(us for us, name, _ in rows
                  if name.startswith("nvjet") or "gemm" in name.lower()) / 1e3
    attn = [(us, n) for us, name, n in rows if ATTENTION_KERNEL in name]
    return {
        "passes": steps, "wall_ms_per_pass": wall * 1e3 / steps,
        "device_busy_ms_per_pass": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / (wall * 1e3) if cuda else None,
        "gemm_ms_per_pass": gemm_ms / steps,
        "attention_ms_per_pass": sum(us for us, _ in attn) / 1e3 / steps,
        "attention_launches_per_pass": sum(n for _, n in attn) / steps,
        "top_kernels": [{"name": k[:80], "calls": c, "ms_per_pass": us / 1e3 / steps}
                        for us, k, c in rows[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b",
                    choices=sorted(n for n, c in ARCHS.items() if c.input_mode == "tokens"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--launches", type=int, default=2)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="also profile verify passes over windows of K + 1")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=args.device).manual_seed(0)
    engine = Engine(cfg, get_model(cfg).init(gen, cfg), get_policy("packkv"),
                    EngineConfig(capacity=args.capacity, max_batch=args.batch,
                                 decode_chunk=8, device=args.device,
                                 prefill_chunk_pages=0, paged=args.paged,
                                 page_size=args.page_size,
                                 # the decode GEMMs at the verify window's height
                                 spec_k=args.spec_k or EngineConfig.spec_k))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len) for _ in range(args.batch)]

    def admitted(eng, **kw):
        server = SlotServer(eng, **kw)
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, tokens=p, max_new=8 * (args.launches + 2)))
        server.step()  # admission + one decode launch (warm-up)
        return server

    cuda = engine.device.type == "cuda"
    out = {
        "arch": cfg.name, "device": args.device, "paged": args.paged,
        "name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "batch": args.batch, "prompt_len": args.prompt_len,
        "plain": profile(admitted(engine), args.launches, cuda, args.top),
    }
    if args.spec_k:
        spec = Engine(cfg, engine.params, engine.pack_cfg, dataclasses.replace(
            engine.ecfg, calibrate=False, spec_decode=True, spec_k=args.spec_k,
            spec_backoff=0))
        # a monitor that never excludes: every launch stays a verify pass
        server = admitted(spec, drafter=FixedDrafter(),
                          straggler=StragglerMonitor(patience=1 << 30))
        out["spec_k"] = args.spec_k
        out["verify"] = profile(server, args.launches, cuda, args.top)
        if server.stats.spec_launches < args.launches:
            raise RuntimeError("a profiled launch ran plain, not a verify pass")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
