"""Where a decode step's time goes: torch.profiler over the serving engine.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode

Builds the engine as ``chip_smoke.py``'s serve phases do (llama2-7b at
full width, random weights, policy packkv, capacity 2048, decode_chunk 8;
``--paged``: the page pool, ``--page-size`` tokens a page), admits
``--batch`` requests of ``--prompt-len`` tokens in one step (monolithic
admission), runs one decode launch as warm-up, then profiles
``--launches`` more. Prints one JSON
line: wall and device-busy milliseconds per decode step, the device's
idle share, and the kernels that took the most device time. On a CPU
(``--smoke --device cpu``) it profiles the host only.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_arch
from ..core.policy import get_policy
from ..models import get_model
from ..serving import Engine, EngineConfig, Request, SlotServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--launches", type=int, default=2)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=256)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=args.device).manual_seed(0)
    engine = Engine(cfg, get_model(cfg).init(gen, cfg), get_policy("packkv"),
                    EngineConfig(capacity=args.capacity, max_batch=args.batch,
                                 decode_chunk=8, device=args.device,
                                 prefill_chunk_pages=0, paged=args.paged,
                                 page_size=args.page_size))
    server = SlotServer(engine)
    rng = np.random.default_rng(0)
    for i in range(args.batch):
        server.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, args.prompt_len),
                              max_new=8 * (args.launches + 2)))
    server.step()  # admission + one decode launch (warm-up)
    cuda = engine.device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    steps0 = server.stats.decode_steps
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.launches):
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
    out = {
        "arch": cfg.name, "device": args.device, "paged": args.paged,
        "name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "batch": args.batch, "prompt_len": args.prompt_len,
        "decode_steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / (wall * 1e3) if cuda else None,
        "top_kernels": [{"name": k[:80], "calls": c, "ms_per_step": us / 1e3 / steps}
                        for us, k, c in rows[:args.top]],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
