"""Rank-side helpers of the tensor-parallel tests (tests/test_torch_tp_train.py
on the CPU, tests/test_torch_gpu.py on the card): the runs each rank group
makes and the checks of the exchange functions. Spawned ranks import this
module, so it imports neither JAX nor the reference."""
import os

import torch

import torch_dp_helpers as h
from repro_torch.configs import SMOKES

# every token family, at its smoke config
TP_MODELS = ("llama2-7b", "smollm-135m", "qwen3-32b", "qwen2-moe-a2.7b",
             "rwkv6-1.6b", "recurrentgemma-9b")
# the models also held against the reference's own mesh steps, from its init
REF_MODELS = ("llama2-7b", "qwen2-moe-a2.7b")
B, S, STEPS = 4, 64, 2
OPT = h.OPT
CKPT_STEP = 1


def batches(name: str, n: int = STEPS, rows: int = B) -> list:
    return h.token_batches(SMOKES[name], 0, n, rows, S)


# f32 runs of the layouts the TP models do not take: a stream no 'model'
# axis of 2 divides (63 positions: every rank holds it whole) in each
# kind of block, and the VLM's patch prefix ahead of its tokens
LAYOUTS = {"odd": ("llama2-7b", 63), "odd_moe": ("qwen2-moe-a2.7b", 63),
           "odd_rwkv": ("rwkv6-1.6b", 63), "odd_rglru": ("recurrentgemma-9b", 63),
           "patches": ("internvl2-2b", S)}


def layout_batches(kind: str) -> list:
    import numpy as np

    name, seq = LAYOUTS[kind]
    cfg = SMOKES[name]
    if cfg.input_mode == "tokens":
        return h.token_batches(cfg, 0, STEPS, B, seq)
    rng = np.random.default_rng(0)
    nt = seq - cfg.n_patches
    return [{"tokens": rng.integers(0, cfg.vocab, (B, nt)).astype(np.int32),
             "patches": rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, cfg.vocab, (B, nt)).astype(np.int32)}
            for _ in range(STEPS)]


def launch_args(d: str, steps: int) -> list[str]:
    """The launcher on smollm-135m smoke (one KV head: every rank computes
    every head) with a checkpoint every 2 steps under ``d``."""
    return ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", str(steps),
            "--batch", "4", "--seq", "32", "--schedule", "wsd", "--ckpt-every", "2",
            "--ckpt-dir", os.path.join(d, "launch")]


def init_path(d: str, name: str) -> str | None:
    return os.path.join(d, f"init_{name}.pt") if name in REF_MODELS else None


def run(name: str, d: str, **kw) -> dict:
    return h.run_steps(name, batches(name), init=init_path(d, name), opt=OPT, **kw)


# -- the exchange functions against their single-device forms ---------------


def function_cases(tp) -> dict:
    """Each autograd function of ``distributed.exchange`` on bf16 inputs
    every rank draws from one seed (each rank its own rank's part): the
    forward value and the input's gradient under a fixed f32 weighting of
    the output, next to the same math on one device (the weights rounded
    to bf16 as the gradient of a bf16 tensor is; sums in f32 in rank
    order, rounded once)."""
    from repro_torch.distributed import exchange as ex

    n, r = tp.size, tp.index
    gen = torch.Generator().manual_seed(7)
    bf = lambda t: t.to(torch.bfloat16)
    add = lambda ts: bf(sum(t.float() for t in ts))
    parts = bf(torch.randn((n, 2, 8, 6), generator=gen))
    whole = bf(torch.randn((n, 2, 8 * n, 6), generator=gen))
    wts = torch.randn((n, 2, 8 * n, 6), generator=gen)  # rank q weights by wts[q]
    sl = lambda t, q: t[:, 8 * q:8 * (q + 1)]
    full = torch.cat(list(parts), dim=1)  # the ranks' parts in rank order

    def grad(fn, x, w):
        x = x.clone().requires_grad_()
        y = fn(x)
        (y.float() * w).sum().backward()
        return y.detach(), x.grad

    return {
        # identity; backward: every rank's gradient added
        "copy_to": (grad(lambda x: ex.copy_to(x, tp), parts[r], sl(wts[r], 0)),
                    (parts[r], add(bf(sl(wts[q], 0)) for q in range(n)))),
        # the ranks' sum; backward: identity
        "reduce_from": (grad(lambda x: ex.reduce_from(x, tp), parts[r], sl(wts[r], 0)),
                        (add(parts), bf(sl(wts[r], 0)))),
        # the parts concatenated; backward: this rank's slice of the ranks' sum
        "gather_along": (grad(lambda x: ex.gather_along(x, 1, tp), parts[r], wts[r]),
                         (full, add(bf(sl(wts[q], r)) for q in range(n)))),
        # this rank's slice of the ranks' sum; backward: the slices gathered
        "scatter_along": (grad(lambda x: ex.scatter_along(x, 1, tp), whole[r], sl(wts[r], r)),
                          (sl(add(whole), r), bf(torch.cat([sl(wts[q], q) for q in range(n)], 1)))),
        # this rank's slice; backward: the slices gathered
        "split_along": (grad(lambda x: ex.split_along(x, 1, tp), full, sl(wts[r], r)),
                        (sl(full, r), bf(torch.cat([sl(wts[q], q) for q in range(n)], 1)))),
        # identity; the gradient on rank 0 only
        "grad_on_first": (grad(lambda x: ex.grad_on_first(x, tp), parts[r], sl(wts[r], 0)),
                          (parts[r], bf(sl(wts[r], 0)) if r == 0
                           else torch.zeros_like(bf(sl(wts[r], 0))))),
    }


def local_bytes(params) -> int:
    from repro_torch.utils import tree_flatten

    return sum(x.numel() * x.element_size() for x in tree_flatten(params)[0])


# -- the rank groups --------------------------------------------------------


def tp2_rank(rank: int, world: int, d: str) -> None:
    """Two ranks. At (data 1, model 2): every TP model's steps (REF_MODELS
    from the reference's init, with ``param_pspecs`` passed), in bf16 and
    with the parameters in f32, the LAYOUTS in f32, llama2-7b
    once more (repeatability), REF_MODELS at grad_accum 2 (the (2, 2)
    control), the exchange functions, and a checkpoint after CKPT_STEP
    steps (full arrays, rank 0 writes) with its resumed run; at (data 2,
    model 1): the checkpoint resumed. Then rank 0 alone, at the same
    thread count: the single-process controls and the checkpoint resumed
    at (1, 1)."""
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    res: dict = {}
    with h.process_group(rank, world, os.path.join(d, "init2")):
        mesh = make_debug_mesh(data=1, model=world, device="cpu")
        for name in TP_MODELS:
            res[name, "tp"] = run(name, d, mesh=mesh, first=True, pin=name in REF_MODELS)
            res[name, "tp32"] = run(name, d, mesh=mesh, f32=True)
        for kind, (name, _) in LAYOUTS.items():
            res[kind, "tp32"] = h.run_steps(name, layout_batches(kind), mesh=mesh, opt=OPT,
                                            f32=True)
        res["repeat"] = run("llama2-7b", d, mesh=mesh)
        for name in REF_MODELS:
            res[name, "accum2"] = run(name, d, mesh=mesh, grad_accum=2)
        res["functions"] = function_cases(mesh.model_lanes(0))
        res["bytes"] = tp_bytes(mesh)
        ck = os.path.join(d, "ckpt")
        res["ckpt_12"] = h.run_steps("llama2-7b", batches("llama2-7b"), mesh=mesh, opt=OPT,
                                     save_at=(CKPT_STEP, ck), first=True)
        res["resume_12"] = h.run_steps("llama2-7b", batches("llama2-7b")[CKPT_STEP:],
                                       mesh=mesh, opt=OPT, resume=(CKPT_STEP, ck))
        res["resume_21"] = h.run_steps("llama2-7b", batches("llama2-7b")[CKPT_STEP:],
                                       mesh=make_debug_mesh(data=world, model=1, device="cpu"),
                                       opt=OPT, resume=(CKPT_STEP, ck), grad_accum=1)
        # the launcher with its mesh given a 'model' axis of 2 (its own
        # --mesh prod needs 256 ranks): a full-array checkpoint at step 2
        import repro_torch.launch.train as launch_train

        make = launch_train.make_debug_mesh
        launch_train.make_debug_mesh = lambda data, device: make(data=1, model=data,
                                                                 device=device)
        try:
            res["launch_rc"] = launch_train.main(launch_args(d, 2))
        finally:
            launch_train.make_debug_mesh = make
    if rank == 0:
        # ... resumed by one process and trained 2 steps more
        res["launch_resume_rc"] = launch_train.main(launch_args(d, 4) + ["--resume"])
        for name in TP_MODELS:
            res[name, "ctl"] = run(name, d, first=True)
            res[name, "ctl32"] = run(name, d, f32=True)
        for kind, (name, _) in LAYOUTS.items():
            res[kind, "ctl32"] = h.run_steps(name, layout_batches(kind), opt=OPT, f32=True)
        res["resume_11"] = h.run_steps("llama2-7b", batches("llama2-7b")[CKPT_STEP:],
                                       opt=OPT, resume=(CKPT_STEP, ck))
        res["resume_11_accum2"] = h.run_steps("llama2-7b", batches("llama2-7b")[CKPT_STEP:],
                                              opt=OPT, resume=(CKPT_STEP, ck), grad_accum=2)
    h.save(res, os.path.join(d, f"tp2_rank{rank}.pt"))


def tp_bytes(mesh) -> dict:
    """{name: (this rank's parameter bytes, the bytes the rule's specs
    give a rank)} at every TP model's smoke config."""
    from repro_torch.distributed import sharding
    from repro_torch.models import get_model
    from repro_torch.utils import tree_flatten

    out = {}
    for name in TP_MODELS:
        cfg = SMOKES[name]
        params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
        local = sharding.shard_tree(params, sharding.storage_specs(params, mesh), mesh)
        leaves, treedef = tree_flatten(params)
        specs = sharding.spec_leaves(sharding.param_specs(params, mesh), treedef)
        rule = sum(x.numel() * x.element_size() // (mesh.model_size if "model" in spec else 1)
                   for x, spec in zip(leaves, specs))
        out[name] = (local_bytes(local), rule, local_bytes(params))
    return out


def tp4_rank(rank: int, world: int, d: str) -> None:
    """Four ranks at (data 2, model 2): REF_MODELS from the reference's
    init, ZeRO-1 moments."""
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    res: dict = {}
    with h.process_group(rank, world, os.path.join(d, "init4")):
        mesh = make_debug_mesh(data=2, model=2, device="cpu")
        for name in REF_MODELS:
            res[name, "tp"] = run(name, d, mesh=mesh, first=True)
    h.save(res, os.path.join(d, f"tp4_rank{rank}.pt"))


def gpu_tp_rank(rank: int, world: int, d: str) -> None:
    """Two or four ranks sharing cuda:0 over gloo (or four cards over
    NCCL when ``d``'s name starts with 'nccl'): llama2-7b and
    qwen2-moe-a2.7b smoke at (1, 2) and grad_accum 2 (two ranks) or (2,
    2) (four ranks)."""
    from repro_torch.launch.mesh import make_debug_mesh

    nccl = os.path.basename(d).startswith("nccl")
    dev = f"cuda:{rank}" if nccl else "cuda:0"
    if nccl:
        torch.cuda.set_device(rank)
    res: dict = {}
    with h.process_group(rank, world, os.path.join(d, "init"),
                         backend="nccl" if nccl else "gloo"):
        data = world // 2
        mesh = make_debug_mesh(data=data, model=2, device=dev)
        for name in REF_MODELS:
            res[name] = h.run_steps(name, batches(name), mesh=mesh, device=dev, opt=OPT,
                                    grad_accum=2 if data == 1 else 1)
    h.save(res, os.path.join(d, f"gpu_tp_rank{rank}_{world}.pt"))
