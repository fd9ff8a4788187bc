"""Tensor parallelism without ranks (tests/test_torch_tp_train.py spawns
them), and the CPU head product that faulted.

  * ``head_block``: the query and KV heads a rank attends over, whole KV
    groups or inside one group, every head where neither splits;
  * a rank's blocks of the training state (``train_state_specs``,
    ``shard_tree``) at full width and depth of every token family (the
    port's init on the meta device), over (data, model) = (1, 2), (2, 2)
    and (1, 4): each leaf the rule splits over 'model' is held as 1/m of
    its bytes, the MoE experts by their Fe dim where the rule splits them
    by expert, at the rule's bytes; ZeRO-1 moments as 1/(d m) where both
    split; the blocks of every coordinate put back together give every
    leaf whole, bitwise (smoke configs);
  * ``model_lanes``: None without a mesh or at a 'model' axis of 1; a
    mesh of axis sizes only cannot run a 'model' axis of 2;
  * the CPU head product's backward at the shape where torch's oneDNN
    bf16 GEMM faults on a transposed operand (32 rows, vocab 49152, width
    576), and the full smollm-135m train step at one row of 32 tokens that
    died of it, each in a subprocess: both exit 0."""
import itertools
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES, get_arch
from repro_torch.distributed import sharding as tsh
from repro_torch.models import get_model
from repro_torch.models.layers import head_block
from repro_torch.training import init_opt_state
from repro_torch.utils import MetaGenerator, tree_flatten, tree_flatten_with_path
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ("llama2-7b", "smollm-135m", "qwen3-32b", "qwen2-moe-a2.7b", "rwkv6-1.6b",
            "recurrentgemma-9b")


class Coords:
    """A mesh of axis sizes with this rank's coordinates."""

    def __init__(self, shape: dict, coords: dict):
        self.shape, self.axis_names, self.coords = shape, tuple(shape), coords
        self.size = math.prod(shape.values())


class _Lane:
    def __init__(self, size: int, index: int):
        self.size, self.index = size, index


@pytest.mark.parametrize("hq,hkv,m,want", [
    (32, 32, 2, [(0, 16, 0, 16), (16, 32, 16, 32)]),    # llama2-7b
    (64, 8, 4, [(0, 16, 0, 2), (16, 32, 2, 4), (32, 48, 4, 6), (48, 64, 6, 8)]),
    (16, 1, 2, [(0, 8, 0, 1), (8, 16, 0, 1)]),          # recurrentgemma-9b
    (4, 1, 2, [(0, 2, 0, 1), (2, 4, 0, 1)]),            # its smoke config
    (9, 3, 2, [(0, 9, 0, 3)] * 2),                      # smollm-135m: every head
    (3, 1, 2, [(0, 3, 0, 1)] * 2),                      # its smoke config
    (12, 3, 2, [(0, 12, 0, 3)] * 2),                    # 6 heads cut a group
])
def test_head_block(hq, hkv, m, want):
    assert [head_block(hq, hkv, _Lane(m, r)) for r in range(m)] == want


@pytest.fixture(scope="module")
def full_params():
    return {name: get_model(get_arch(name)).init(MetaGenerator(), get_arch(name))
            for name in FAMILIES}


def _bytes(x) -> int:
    return x.numel() * x.element_size()


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("name", FAMILIES)
def test_rank_holds_its_share_at_full_size(full_params, name, data, model):
    params = full_params[name]
    mesh = Coords({"data": data, "model": model}, {"data": data - 1, "model": model - 1})
    specs = tsh.train_state_specs(params, mesh)
    rule = tsh.param_specs(params, mesh)
    moments = tsh.opt_state_specs(params, mesh).mu
    leaves, treedef = tree_flatten_with_path(params)
    # a moment is shaped as its parameter: the params stand in for them
    store_p, store_m = tsh.shard_tree(params, specs[0], mesh), tsh.shard_tree(params, specs[1].mu, mesh)
    for (path, x), spec, mspec, p, m in zip(
            leaves, tsh.spec_leaves(rule, treedef), tsh.spec_leaves(moments, treedef),
            tree_flatten(store_p)[0], tree_flatten(store_m)[0]):
        k = model if "model" in spec else 1
        assert _bytes(p) * k == _bytes(x), path
        k *= data if "data" in mspec else 1
        assert _bytes(m) * k == _bytes(x), path
        if name == "qwen2-moe-a2.7b" and path[-1] in ("w_gate", "w_up", "w_down") \
                and "shared" not in path:
            fe = -1 if path[-1] != "w_down" else -2
            assert spec[-3] == "model"  # E = 60 splits over 2 and 4 ...
            assert p.shape[-3] == x.shape[-3]  # ... but a rank stores its Fe slice
            assert p.shape[fe] * model == x.shape[fe]


@pytest.mark.parametrize("name", FAMILIES)
def test_blocks_of_every_coordinate_make_the_state_whole(name):
    cfg = SMOKES[name]
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    opt = init_opt_state(params)
    for x in tree_flatten(opt.mu)[0] + tree_flatten(opt.nu)[0]:
        x.copy_(torch.randn(x.shape))
    shape = {"data": 2, "model": 2}
    specs = tsh.train_state_specs(params, Coords(shape, {"data": 0, "model": 0}))
    blocks = {(d, m): tsh.shard_tree((params, opt), specs, Coords(shape, {"data": d, "model": m}))
              for d, m in itertools.product(range(2), range(2))}
    flat_specs = tsh.spec_leaves(specs, tree_flatten((params, opt))[1])
    for i, (x, spec) in enumerate(zip(tree_flatten((params, opt))[0], flat_specs)):
        parts = {c: tree_flatten(b)[0][i] for c, b in blocks.items()}
        whole = _join(parts, spec)
        assert whole.dtype == x.dtype and torch.equal(whole, x), (i, spec)


def _join(parts: dict, spec) -> torch.Tensor:
    """Put the four (data, model) blocks of a leaf back together by its
    spec (model outer, data inner on a dim that takes both)."""
    axes = {a: d for d, e in enumerate(spec) for a in tsh._axes(e)}
    x = dict(parts)
    if "data" in axes:
        x = {(0, m): torch.cat([x[0, m], x[1, m]], axes["data"]) for m in range(2)}
    else:
        assert all(torch.equal(x[0, m], x[1, m]) for m in range(2))
    if "model" in axes:
        return torch.cat([x[0, 0], x[0, 1]], axes["model"])
    assert torch.equal(x[0, 0], x[0, 1])
    return x[0, 0]


def test_model_lanes():
    from repro_torch.launch.mesh import SpecMesh

    assert tsh.model_lanes(64) is None
    tsh.set_active_mesh(SpecMesh({"data": 2, "model": 1}))
    try:
        assert tsh.model_lanes(64) is None
        tsh.set_active_mesh(SpecMesh({"data": 1, "model": 2}))
        with pytest.raises(TypeError, match="TrainMesh"):
            tsh.model_lanes(64)
    finally:
        tsh.set_active_mesh(None)


def _child(code: str, timeout: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_cpu_head_backward_at_the_faulting_shape():
    r = _child("""
import torch
from repro_torch.models.layers import head_logits
torch.manual_seed(0)
h = torch.randn(1, 32, 576, dtype=torch.bfloat16, requires_grad=True)
w = torch.randn(576, 49152, dtype=torch.bfloat16, requires_grad=True)
g = torch.randn(1, 32, 49152, dtype=torch.bfloat16)
y = head_logits(h, w)
y.backward(g)
want_h = (g.float() @ w.detach().float().t()).to(torch.bfloat16)
want_w = (h.detach().float().reshape(32, 576).t() @ g.float().reshape(32, 49152))
assert torch.equal(y, h.detach() @ w.detach())
assert (h.grad.float() - want_h.float()).abs().max() <= 0.02 * want_h.float().abs().max()
assert (w.grad.float() - want_w).abs().max() <= 0.02 * want_w.abs().max()
print("ok")
""", 120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", (r.returncode, r.stderr[-2000:])


def test_full_smollm_step_one_row_of_32_tokens():
    """The step that died with SIGFPE: full smollm-135m, batch 1 x 32."""
    r = _child("""
import numpy as np, torch
from repro_torch.configs import get_arch
from repro_torch.models import get_model
from repro_torch.training import OptConfig, init_training, make_train_step
cfg = get_arch("smollm-135m")
api = get_model(cfg)
params, opt = init_training(api, cfg, torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (1, 32)).astype(np.int32))
         for k in ("tokens", "labels")}
params, opt, m = make_train_step(api, cfg, OptConfig())(params, opt, batch)
assert np.isfinite(float(m["loss"])) and int(m["step"]) == 1
print("ok", float(m["loss"]))
""", 300)
    assert r.returncode == 0 and r.stdout.startswith("ok"), (r.returncode, r.stderr[-2000:])
    assert np.isfinite(float(r.stdout.split()[1]))
