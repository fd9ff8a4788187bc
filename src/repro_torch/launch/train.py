"""Training launcher: data stream -> train step -> checkpoints (the torch
port of ``repro/launch/train.py``, on one device).

Fault tolerance:
  * atomic checkpoints every --ckpt-every steps (AsyncCheckpointer);
  * --resume restores the latest committed checkpoint and the data
    stream's state, so a resumed run continues the uninterrupted one;
  * StragglerMonitor times each step (ended by the loss's host read, which
    waits for the device); on 'exclude' the launcher prints the elastic
    downscale plan the fleet controller would enact before relaunching
    with --resume.

Example (on a CUDA GPU; add ``--device cpu --smoke`` to run on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

The reference's ``--mesh`` (a device mesh) belongs to the multi-device
port and is not taken here.
"""
from __future__ import annotations

import argparse

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs import get_arch
from ..data import ShardedTokenStream
from ..distributed import StragglerMonitor, downscale_plan
from ..models import get_model
from ..training import OptConfig, init_opt_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd", "constant"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch}: train launcher supports token archs; "
                         "see examples/ for frames/patches training")
    api = get_model(cfg)
    opt_cfg = OptConfig(lr=args.lr, schedule=args.schedule,
                        total_steps=args.steps, warmup_steps=max(args.steps // 10, 1))
    device = torch.device(args.device)
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=args.batch,
                                seq=args.seq, seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen, cfg)
    opt_state = init_opt_state(params)
    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt_state), extra = restore(args.ckpt_dir, last,
                                                 (params, opt_state), device)
            stream.restore(extra["stream"])
            start_step = last
            print(f"resumed from step {last}")

    step_fn = make_train_step(api, cfg, opt_cfg, args.grad_accum)
    monitor = StragglerMonitor()
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in stream.next_batch().items()}
            monitor.start()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step: the monitor's stop
            verdict = monitor.stop()
            if verdict == "exclude":
                print(f"straggler exclusion requested: "
                      f"{downscale_plan((1, 1), 'exclude-straggler')}")
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} [{verdict}]")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.submit(step + 1, (params, opt_state), {"stream": stream.state()})
    finally:
        if ckpt:
            ckpt.close()
    print("training done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
