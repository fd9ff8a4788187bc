"""Where a training step's time goes: torch.profiler over make_train_step.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      [--arch minicpm-2b --batch 4 --seq 1024]

Builds ``--arch`` at full width with random weights and its train step
(``make_train_step``, grad_accum 1, AdamW at lr 1e-3 with warmup 1 under
WSD), as ``chip_smoke.py``'s train phase does, on batches of ``--batch``
x ``--seq`` tokens from ShardedTokenStream. Two warm-up steps, then
three steps timed by the host clock after a synchronize, then three under
torch.profiler. Then ``adamw_update`` alone, the function the step ends
in, three times on a gradient tree shaped as the parameters (its work
does not depend on the values): the step's AdamW share. Prints one JSON
line: the median step ms and AdamW ms, per profiled step the wall and
device-busy ms, the idle share, the device ms of the products (cuBLAS
kernels), elementwise kernels, reductions and copies, the kernels that
took the most device time, and the step's peak memory. On a CPU
(``--smoke --device cpu``) it profiles the host only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..configs import ARCHS, get_arch
from ..data import ShardedTokenStream
from ..models import get_model
from ..training import OptConfig, adamw_update, init_training, make_train_step
from ..utils import tree_flatten, tree_map

STEPS = 3  # timed, then profiled, steps (after two warm-up steps)
TOP = 12  # kernels listed

# device kernels by what they do, from their names (the first match wins)
KINDS = (("gemm", ("nvjet", "gemm", "cutlass")),
         ("reduce", ("reduce_kernel",)),
         ("copy", ("memcpy", "memset", "copy", "cat", "index")),
         ("elementwise", ("elementwise",)))


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(key in low for key in keys):
            return k
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = get_arch(args.arch, smoke=args.smoke)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch}: profile_train takes token archs")
    api = get_model(cfg)
    oc = OptConfig(lr=1e-3, schedule="wsd", warmup_steps=1, total_steps=2 + 3 * STEPS)
    params, opt = init_training(api, cfg, torch.Generator(device=device).manual_seed(0))
    train_step = make_train_step(api, cfg, oc)
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=args.batch, seq=args.seq)

    def step() -> float:
        nonlocal params, opt
        batch = {k: torch.from_numpy(v).to(device) for k, v in stream.next_batch().items()}
        params, opt, m = train_step(params, opt, batch)
        return float(m["loss"])

    def timed(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    losses = [step() for _ in range(2)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(STEPS):
        step_ms.append(timed(lambda: losses.append(step())))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            losses.append(step())
        wall = (time.perf_counter() - t0) * 1e3 / STEPS
    peak = torch.cuda.max_memory_allocated() if cuda else None
    grads = tree_map(torch.ones_like, params)
    adamw_ms = [timed(lambda: adamw_update(grads, opt, params, oc)) for _ in range(STEPS)]

    kernels: dict[str, list] = {}  # device events only: kernels and copies
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    rows = sorted(((us, name, n) for name, (us, n) in kernels.items()), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3 / STEPS
    by_kind: dict[str, float] = {}
    for us, name, _ in rows:
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + us / 1e3 / STEPS
    print(json.dumps({
        "arch": cfg.name, "params": sum(p.numel() for p in tree_flatten(params)[0]),
        "batch": args.batch, "seq": args.seq,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "losses": losses,
        "step_ms": statistics.median(step_ms),
        "adamw_ms": statistics.median(adamw_ms),
        "profiled_wall_ms_per_step": wall,
        "device_busy_ms_per_step": busy if cuda else None,
        "idle_share": 1.0 - busy / wall if cuda else None,
        "device_ms_per_step_by_kind": by_kind if cuda else None,
        "top_kernels": [{"name": k[:80], "calls": c // STEPS, "ms_per_step": us / 1e3 / STEPS}
                        for us, k, c in rows[:TOP]],
        "peak_memory_bytes": peak,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
