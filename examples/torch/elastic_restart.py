"""Fault-tolerance drill: preemption + elastic restart + straggler
exclusion (the torch port of examples/elastic_restart.py).

Simulates the fleet-controller loop: train, get preempted mid-run (we just
stop), restart from the latest committed checkpoint on a different mesh
(an elastic downscale after a straggler exclusion), and check that the
replayed steps' losses are bitwise those of the uninterrupted run. A
checkpoint holds full arrays: a restart on another 'data' size re-slices
the AdamW moments to it (``python -m repro_torch.launch.train --resume``
under ``torchrun``); this drill restarts on one rank.

Run:  PYTHONPATH=src python examples/torch/elastic_restart.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_arch
from repro_torch.data import ShardedTokenStream
from repro_torch.distributed import StragglerMonitor, downscale_plan
from repro_torch.models import get_model
from repro_torch.training import OptConfig, init_opt_state, make_train_step


def run_segment(start: int, stop: int, params, opt, stream, step_fn, ckpt, dev):
    losses = {}
    for step in range(start, stop):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in stream.next_batch().items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses[step] = float(metrics["loss"])
        if (step + 1) % 5 == 0:
            ckpt.submit(step + 1, (params, opt), {"stream": stream.state()})
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    ckpt_dir = tempfile.mkdtemp(prefix="packkv_elastic_")
    try:
        cfg = get_arch("smollm-135m", smoke=True)
        api = get_model(cfg)
        opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=40)
        stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=4, seq=128)
        step_fn = make_train_step(api, cfg, opt_cfg)

        # ---- run 1: train 12 steps, checkpointing every 5; then "preempted"
        params = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
        opt = init_opt_state(params)
        ckpt = AsyncCheckpointer(ckpt_dir)
        params, opt, l1 = run_segment(0, 12, params, opt, stream, step_fn, ckpt, dev)
        ckpt.close()
        print(f"run 1 preempted at step 12 (latest checkpoint: "
              f"step {latest_step(ckpt_dir)})")

        # ---- straggler detection triggers an elastic downscale decision
        mon = StragglerMonitor(patience=2)
        for dt in (1.0, 1.0, 1.0, 1.0, 9.0, 9.5):
            verdict = mon.observe(dt)
        plan = downscale_plan((2, 16, 16), "exclude-straggler")
        print(f"straggler verdict: {verdict} -> elastic plan "
              f"{plan.old_shape} -> {plan.new_shape}")

        # ---- run 2: restore from the latest checkpoint on one rank
        params2 = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
        opt2 = init_opt_state(params2)
        last = latest_step(ckpt_dir)
        (params2, opt2), extra = restore(ckpt_dir, last, (params2, opt2), dev)
        stream2 = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=4, seq=128)
        stream2.restore(extra["stream"])
        ckpt2 = AsyncCheckpointer(ckpt_dir)
        _, _, l2 = run_segment(last, 15, params2, opt2, stream2, step_fn, ckpt2, dev)
        ckpt2.close()

        # the overlapping steps must match the uninterrupted trajectory bitwise
        overlap = [s for s in l1 if s in l2]
        drift = max(abs(l1[s] - l2[s]) for s in overlap)
        print(f"steps {overlap} replayed after restart; max loss drift {drift:.2e}")
        assert all(l1[s] == l2[s] for s in overlap), "restart is not deterministic!"
        print("elastic restart drill PASSED")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
