"""Rank-side helpers of the data-parallel tests (tests/test_torch_dp_train.py
on the CPU, tests/test_torch_gpu.py on the card): a process group over a
rendezvous file, seeded batches, a few train steps of one config under a
mesh (or as the single-process control) and bitwise comparison of the
results. Spawned ranks import this module, so it imports neither JAX nor
the reference."""
import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import SMOKES, get_arch
from repro_torch.distributed import sharding
from repro_torch.models import get_model
from repro_torch.training import OptConfig, init_opt_state, make_train_step
from repro_torch.training.train import gather_opt_state, shard_opt_state
from repro_torch.utils import tree_flatten_with_path

OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)


@contextlib.contextmanager
def process_group(rank: int, world: int, init_file: str):
    """A gloo group over ``init_file`` (no TCP port: two test files may
    spawn ranks at once), destroyed on the way out."""
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def token_batches(cfg, seed: int, n: int, B: int, S: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def flat(tree) -> dict:
    return {".".join(p): x.detach().cpu().clone()
            for p, x in tree_flatten_with_path(tree)[0]}


def run_steps(name: str, batches: list, *, mesh=None, grad_accum: int = 1,
              zero: bool = True, device="cpu", smoke: bool = True,
              seed: int = 0, init: str | None = None, first: bool = False) -> dict:
    """``len(batches)`` steps of config ``name`` from ``seed``'s init (or
    the parameters saved at ``init``): under ``mesh`` (set active for the
    run; ZeRO-1 moments when ``zero``) or, with mesh None, as one process.
    Returns each step's metrics and the final parameters and (full)
    moments on the CPU; with ``first``, also the parameters and first
    moments after the first step (``"first"``)."""
    cfg = SMOKES[name] if smoke else get_arch(name)
    api = get_model(cfg)
    if init is None:
        params = api.init(torch.Generator(device=device).manual_seed(seed), cfg)
    else:
        params = torch.load(init, map_location=device)
    opt = init_opt_state(params)
    specs = sharding.opt_state_specs(params, mesh) if mesh is not None and zero else None
    if specs is not None:
        opt = shard_opt_state(opt, specs, mesh)
    step_fn = make_train_step(api, cfg, OPT, grad_accum, accum_pspecs=specs)
    whole = lambda o: o if specs is None else gather_opt_state(o, specs, params, mesh)
    metrics, out = [], {}
    sharding.set_active_mesh(mesh)
    try:
        for b in batches:
            tb = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            params, opt, m = step_fn(params, opt, tb)
            metrics.append({k: v.detach().cpu().clone() for k, v in m.items()})
            if first and len(metrics) == 1:
                out["first"] = {"params": flat(params), "mu": flat(whole(opt).mu)}
    finally:
        sharding.set_active_mesh(None)
    opt = whole(opt)
    return dict(out, metrics=metrics, params=flat(params), mu=flat(opt.mu),
                nu=flat(opt.nu), step=opt.step.cpu().clone())


def bits(x: torch.Tensor) -> bytes:
    return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def bitwise_diff(a: dict, b: dict) -> list[str]:
    """What differs between two ``run_steps`` results, bit for bit: the
    metrics of each step, every parameter, both moments and the step."""
    out = []
    for i, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        out += [f"step {i} {k}: {ma[k]} vs {mb[k]}" for k in ma if bits(ma[k]) != bits(mb[k])]
    for part in ("params", "mu", "nu"):
        assert a[part].keys() == b[part].keys(), part
        out += [f"{part} {k}" for k in a[part] if bits(a[part][k]) != bits(b[part][k])]
    if bits(a["step"]) != bits(b["step"]):
        out.append("step")
    return out


def save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


# -- the rank groups of tests/test_torch_dp_train.py -----------------------

DP_MODELS = ("llama2-7b", "qwen2-moe-a2.7b", "rwkv6-1.6b")
# the models whose data = 2 step is also held against the reference's
# step under a (data = 2) mesh: they start from its init (``init_path``)
REF_MODELS = ("llama2-7b", "qwen2-moe-a2.7b")
B, S, STEPS = 4, 64, 2  # global batch rows, sequence, steps a run
PSUM_CASES = [(bits, shape) for bits in (2, 4, 8) for shape in ((8, 16), (10, 10))]
PSUM_ROW = 64  # (8, 16) is two rows of 64; (10, 10) pads its last row


def psum_replicas(n: int, bits: int, shape) -> np.ndarray:
    """Every replica's gradient leaf [n, *shape] for a compressed mean."""
    return np.random.default_rng([n, bits, *shape]).normal(
        size=(n, *shape)).astype(np.float32)


def _psum_outputs(world: int, rank: int) -> dict:
    from repro_torch.distributed.grad_compress import (
        GradCompressConfig,
        compressed_psum_mean,
    )

    out = {}
    for bits, shape in PSUM_CASES:
        g = {"w": torch.from_numpy(psum_replicas(world, bits, shape)[rank])}
        cfg = GradCompressConfig(bits=bits, row=PSUM_ROW)
        out[(bits, shape)] = compressed_psum_mean(g, cfg, dist.group.WORLD)["w"]
    return out


def launch_args(ckpt_dir: str) -> list[str]:
    return ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--schedule", "wsd",
            "--ckpt-dir", ckpt_dir]


def init_path(d: str, name: str) -> str | None:
    """The reference's init of ``name`` as port tensors, or None (the
    port's own init from seed 0)."""
    return os.path.join(d, f"init_{name}.pt") if name in REF_MODELS else None


def dp2_rank(rank: int, world: int, d: str) -> None:
    """Two ranks: data = 2 runs of every DP model (ZeRO-1; REF_MODELS from
    the reference's init, which the caller saved in ``d``), replicated
    moments, the fallback batch of 3 rows, data 2 x grad_accum 2, the
    compressed mean and launcher run 1; then rank 0 alone, at the same
    thread count: the single-process controls and the launcher's resume
    at --grad-accum 2 from run 1's step-2 checkpoint."""
    import shutil

    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    res: dict = {}
    llama = token_batches(SMOKES["llama2-7b"], 0, STEPS, B, S)
    with process_group(rank, world, os.path.join(d, "init2")):
        mesh = make_debug_mesh(data=world, device="cpu")
        for name in DP_MODELS:
            res[name, "dp"] = run_steps(name, token_batches(SMOKES[name], 0, STEPS, B, S),
                                        mesh=mesh, init=init_path(d, name),
                                        first=name in REF_MODELS)
        res["replicated"] = run_steps("llama2-7b", llama, mesh=mesh, zero=False,
                                      init=init_path(d, "llama2-7b"))
        res["fallback", "dp"] = run_steps(
            "llama2-7b", token_batches(SMOKES["llama2-7b"], 1, STEPS, 3, S), mesh=mesh)
        res["accum2", "dp"] = run_steps("llama2-7b", llama, mesh=mesh, grad_accum=2)
        res["psum"] = _psum_outputs(world, rank)
        assert launch_train.main(launch_args(os.path.join(d, "run1"))) == 0
        dist.barrier()
    if rank == 0:
        for name in DP_MODELS:
            res[name, "ctl"] = run_steps(name, token_batches(SMOKES[name], 0, STEPS, B, S),
                                         grad_accum=world, init=init_path(d, name))
        res["fallback", "ctl"] = run_steps(
            "llama2-7b", token_batches(SMOKES["llama2-7b"], 1, STEPS, 3, S))
        res["accum4", "ctl"] = run_steps("llama2-7b", llama, grad_accum=4)
        run2 = os.path.join(d, "run2")
        shutil.copytree(os.path.join(d, "run1", "step_00000002"),
                        os.path.join(run2, "step_00000002"))
        assert launch_train.main(launch_args(run2) + ["--resume", "--grad-accum", "2"]) == 0
    save(res, os.path.join(d, f"dp2_rank{rank}.pt"))


def dp4_rank(rank: int, world: int, d: str) -> None:
    """Four ranks: llama2-7b at data = 4 (ZeRO-1) and the compressed mean;
    then rank 0 alone: the grad_accum = 4 control."""
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    res: dict = {}
    llama = token_batches(SMOKES["llama2-7b"], 0, STEPS, B, S)
    with process_group(rank, world, os.path.join(d, "init4")):
        res["dp"] = run_steps("llama2-7b", llama, mesh=make_debug_mesh(data=world, device="cpu"))
        res["psum"] = _psum_outputs(world, rank)
    if rank == 0:
        res["ctl"] = run_steps("llama2-7b", llama, grad_accum=world)
    save(res, os.path.join(d, f"dp4_rank{rank}.pt"))


def gpu_dp2_rank(rank: int, world: int, d: str) -> None:
    """Two ranks sharing cuda:0 over gloo (ZeRO-1): llama2-7b and
    qwen2-moe-a2.7b smoke at data = 2; then rank 0 alone: the grad_accum
    = 2 controls on the same card."""
    from repro_torch.launch.mesh import make_debug_mesh

    dev = "cuda:0"
    res: dict = {}
    models = ("llama2-7b", "qwen2-moe-a2.7b")
    with process_group(rank, world, os.path.join(d, "init_gpu")):
        mesh = make_debug_mesh(data=world, device=dev)
        for name in models:
            res[name, "dp"] = run_steps(name, token_batches(SMOKES[name], 0, STEPS, B, S),
                                        mesh=mesh, device=dev)
    if rank == 0:
        for name in models:
            res[name, "ctl"] = run_steps(name, token_batches(SMOKES[name], 0, STEPS, B, S),
                                         grad_accum=world, device=dev)
    save(res, os.path.join(d, f"gpu_dp2_rank{rank}.pt"))
