"""End-to-end driver: train a ~135M-parameter model for a few hundred
steps (the torch port of examples/train_smollm.py).

Uses the FULL smollm-135m config (30 layers x 576) on the synthetic Zipf
stream, with the WSD schedule, gradient accumulation, async checkpointing
and straggler monitoring: the whole training substrate at quickstart
scale. Several ranks train it data-parallel through
``python -m repro_torch.launch.train --mesh debug`` under torchrun.

Run:  PYTHONPATH=src python examples/torch/train_smollm.py [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_arch
from repro_torch.data import ShardedTokenStream
from repro_torch.distributed import StragglerMonitor
from repro_torch.models import get_model
from repro_torch.training import OptConfig, init_opt_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "packkv_smollm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_arch("smollm-135m")  # FULL 135M config
    api = get_model(cfg)
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.0f}M params on {dev}")

    opt_cfg = OptConfig(lr=6e-4, schedule="wsd", warmup_steps=20,
                        total_steps=args.steps)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = init_opt_state(params)
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=args.batch,
                                seq=args.seq)
    start = 0
    if args.resume and (last := latest_step(args.ckpt_dir)) is not None:
        (params, opt), extra = restore(args.ckpt_dir, last, (params, opt), dev)
        stream.restore(extra["stream"])
        start = last
        print(f"resumed from step {last}")

    step_fn = make_train_step(api, cfg, opt_cfg, args.grad_accum)
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    monitor = StragglerMonitor()
    t0 = time.time()
    loss = float("nan")
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in stream.next_batch().items()}
        monitor.start()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        verdict = monitor.stop()
        if step % 20 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"lr-phase {'warmup' if step < 20 else 'stable/decay'}  "
                  f"{tok_s:,.0f} tok/s  [{verdict}]")
        if (step + 1) % 100 == 0:
            ckpt.submit(step + 1, (params, opt), {"stream": stream.state()})
    ckpt.close()
    print(f"done: final loss {loss:.4f} in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
