"""Training launcher: data stream -> train step -> checkpoints (the torch
port of ``repro/launch/train.py``).

Fault tolerance:
  * atomic checkpoints every --ckpt-every steps (AsyncCheckpointer);
  * --resume restores the latest committed checkpoint and the data
    stream's state, so a resumed run continues the uninterrupted one;
  * StragglerMonitor times each step (ended by the loss's host read, which
    waits for the device); on 'exclude' the launcher prints the elastic
    downscale plan the fleet controller would enact before relaunching
    with --resume.

--mesh debug|prod|prod-multi, the reference's choices. Run alone,
``debug`` is one rank, (data 1, model 1). Started as n ranks by
``torchrun --nproc-per-node n`` (or inside an initialized process group)
it is ``make_debug_mesh(data=n)``: every rank reads the same global batch
from the stream, the step splits it by rows and exchanges gradients in
rank order (``training/train.py``), and AdamW's moments are ZeRO-1 slices
over 'data'. ``prod`` asks for 16 x 16 ranks and ``prod-multi`` for 2 x
16 x 16 (they refuse any other world size): there the 16 'model' ranks
of a line are tensor parallel, each holding its blocks of the
parameters and moments (``sharding.train_state_specs``). Each rank takes
cuda:LOCAL_RANK when the machine has a card a rank, and shares cuda:0
otherwise; the backend is NCCL when every rank has a card of its own and
gloo otherwise (on the CPU too). Rank 0 alone prints and writes
checkpoints, in the single-process format (full arrays: every rank's
blocks are gathered first), so --resume at any mesh re-slices them: an
elastic restart.

Example (on a CUDA GPU; add ``--device cpu --smoke`` to run on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch smollm-135m --steps 20 --batch 8 --seq 256
"""
from __future__ import annotations

import argparse
import os

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_sliced
from ..configs import get_arch
from ..data import ShardedTokenStream
from ..distributed import StragglerMonitor, downscale_plan
from ..distributed import sharding as shd
from ..models import get_model
from ..training import OptConfig, init_opt_state, make_train_step
from .mesh import make_debug_mesh, make_production_mesh


def _process_group(device: str) -> tuple[str, bool]:
    """(this rank's device, whether this call made the process group).

    Under torchrun (WORLD_SIZE > 1) or an existing group, a rank asked for
    'cuda' takes cuda:LOCAL_RANK when the node has a card for each of its
    ranks, and shares cuda:0 otherwise; a named device ('cuda:0', 'cpu')
    is taken as it is. With no group yet, one is made from the
    environment: NCCL only when each rank has a card of its own (it is
    then made the rank's current device), else gloo (NCCL refuses two
    ranks on one card)."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and not dist.is_initialized():
        return device, False
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                 dist.get_world_size() if dist.is_initialized() else world))
    own_card = device == "cuda" and torch.cuda.device_count() >= n_local
    if device == "cuda":
        device = f"cuda:{local}" if own_card else "cuda:0"
    if dist.is_initialized():
        return device, False
    if own_card:
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device(device))
    else:
        dist.init_process_group("gloo")
    return device, True


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
    ap.add_argument("--mesh", default="debug", choices=["debug", "prod", "prod-multi"])
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
    device, made_group = _process_group(args.device)
    try:
        return _train(args, cfg, api, opt_cfg, device)
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, cfg, api, opt_cfg, device: str) -> int:
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = {
        "debug": lambda: make_debug_mesh(data=world, device=device),
        "prod": lambda: make_production_mesh(device=device),
        "prod-multi": lambda: make_production_mesh(multi_pod=True, device=device),
    }[args.mesh]()
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    device = mesh.device
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=args.batch,
                                seq=args.seq, seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen, cfg)
    opt_state = init_opt_state(params)
    zero = shd.opt_state_specs(params, mesh) if mesh.size > 1 else None
    pspecs = shd.param_specs(params, mesh) if mesh.shape.get("model", 1) > 1 else None
    # this rank's blocks of the state: 'model' and ZeRO-1 'data'
    state_specs = shd.train_state_specs(params, mesh) if mesh.size > 1 else None
    start_step = 0
    last = latest_step(args.ckpt_dir) if args.resume and args.ckpt_dir else None
    if last is not None:
        (params, opt_state), extra = restore_sliced(
            args.ckpt_dir, last, (params, opt_state), state_specs, mesh, device)
        stream.restore(extra["stream"])
        start_step = last
        say(f"resumed from step {last}")
    elif state_specs is not None:
        params, opt_state = shd.shard_tree((params, opt_state), state_specs, mesh)
    if mesh.size > 1:
        say(f"mesh {dict(mesh.shape)}: {mesh.size} ranks on "
            f"{dist.get_backend()}, moments ZeRO-1 over 'data'"
            + (f", tensor parallel over 'model' {mesh.model_size}" if pspecs else ""))

    step_fn = make_train_step(api, cfg, opt_cfg, args.grad_accum, param_pspecs=pspecs,
                              accum_pspecs=zero)
    ckpt = (AsyncCheckpointer(args.ckpt_dir, specs=state_specs, mesh=mesh)
            if args.ckpt_dir else None)
    monitor = StragglerMonitor()
    shd.set_active_mesh(mesh if mesh.size > 1 else None)
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in stream.next_batch().items()}
            monitor.start()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step: the monitor's stop
            verdict = monitor.stop()
            if verdict == "exclude":
                say(f"straggler exclusion requested: "
                    f"{downscale_plan(tuple(mesh.devices.shape), 'exclude-straggler')}")
            if step % 5 == 0 or step == args.steps - 1:
                say(f"step {step}: loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} [{verdict}]")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.submit(step + 1, (params, opt_state), {"stream": stream.state()})
    finally:
        shd.set_active_mesh(None)
        if ckpt:
            ckpt.close()
    say("training done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
