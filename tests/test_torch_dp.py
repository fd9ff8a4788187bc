"""The training half of the port's sharding rules, ``_moe_sharded`` and
the refusals, against the reference (no ranks; tests/test_torch_dp_train.py
spawns them).

  * ``param_specs``, ``opt_state_specs`` (ZeRO-1) and ``batch_specs`` equal
    ``repro``'s leaf for leaf over the parameter shapes of all eleven
    configs at full width and depth (the reference's ``jax.eval_shape``,
    the port's init under ``FakeTensorMode``: nothing is allocated), on
    duck-typed meshes {data: 2, model: 4}, {data: 16, model: 16} and
    {pod: 2, data: 16, model: 16}; with the oracles of
    tests/test_distributed.py (qwen2-moe's 60 experts fall back to the Fe
    dim, a stacked dense MLP's layer dim stays whole);
  * ``cache_specs`` over the llama2-7b and qwen3-32b smoke caches (the
    reference's leading layer dim dropped: the port keeps a cache a
    layer);
  * ``constrain`` returns its input with and without an active mesh;
  * ``_moe_sharded`` at (data, model) = (2, 1), (1, 2), (2, 2) against the
    reference's ``shard_map`` path (a child process with 4 forced host
    devices) on the qwen2-moe smoke MLP: an identity router gives both
    sides the same f32 logits, so the routing is compared exactly through
    the output; the output within MOE_ATOL, the aux loss within 1e-6;
  * an active 'model' axis of 2 makes the train step refuse, naming
    ROADMAP item 16c; ``--mesh prod`` / ``prod-multi`` refuse with the
    device count, in the reference's ``jax.make_mesh`` wording."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.distributed import sharding as jsh
from repro.models import get_model as j_get_model
from repro_torch.configs import SMOKES, get_arch
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import cache as tc
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import SpecMesh
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.training import init_opt_state, make_train_step
from repro_torch.utils import tree_flatten, tree_flatten_with_path
from torch_dp_helpers import OPT, token_batches

torch.set_num_threads(2)


class FakeMesh:
    """Duck-typed mesh (as tests/test_distributed.py builds one)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"data": 2, "model": 4}), FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16})]
MESH_IDS = ["2x4", "16x16", "2x16x16"]
# the routed + shared output (bf16, magnitudes ~1): a few bf16 ulps, the
# expert GEMMs summed in another order (tests/test_torch_moe.py's bound)
MOE_ATOL = 3e-2


def _names(path) -> tuple:
    return tuple(str(p.idx) if hasattr(p, "idx") else
                 str(getattr(p, "name", getattr(p, "key", p))) for p in path)


def _ref_specs(tree) -> dict:
    return {_names(path): tuple(spec) for path, spec in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def _port_specs(specs, like) -> dict:
    paths = [p for p, _ in tree_flatten_with_path(like)[0]]
    return dict(zip(paths, tsh.spec_leaves(specs, tree_flatten(like)[1])))


@pytest.fixture(scope="module")
def shapes():
    """{arch: (reference param shapes, port param shapes)} at full size."""
    out = {}
    for name in sorted(J_ARCHS):
        jcfg = j_get_arch(name)
        jp = jax.eval_shape(lambda k, c=jcfg: j_get_model(c).init(k, c),
                            jax.random.PRNGKey(0))
        cfg = get_arch(name)
        with FakeTensorMode():
            tp = get_model(cfg).init(torch.Generator(), cfg)
        out[name] = (jp, tp)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_and_opt_specs_match_reference(shapes, mesh):
    assert len(shapes) == 11
    for name, (jp, tp) in shapes.items():
        want = _ref_specs(jsh.param_specs(jp, mesh))
        got = _port_specs(tsh.param_specs(tp, mesh), tp)
        assert got == want, name
        jopt, topt = jsh.opt_state_specs(jp, mesh), tsh.opt_state_specs(tp, mesh)
        assert _port_specs(topt.mu, tp) == _ref_specs(jopt.mu), name
        assert _port_specs(topt.nu, tp) == _ref_specs(jopt.nu), name
        assert topt.step == tuple(jopt.step) == ()


def test_param_spec_oracles(shapes):
    """tests/test_distributed.py's oracles, on the port at full size."""
    jp, tp = shapes["qwen2-moe-a2.7b"]
    specs = tsh.param_specs(tp, FakeMesh({"data": 2, "model": 4}))
    assert specs["embed"] == ("model", None)
    # E = 60 does not divide 16: the experts fall back to the Fe dim
    big = tsh.param_specs(tp, MESHES[1])
    assert big["layers"]["mlp"]["w_gate"] == (None, None, None, "model")
    assert big["layers"]["mlp"]["w_down"] == (None, None, "model", None)
    assert all(a is None for a in big["final_ln"])
    # a stacked dense MLP [L, D, F]: the layer dim stays whole
    _, lp = shapes["llama2-7b"]
    dense = tsh.param_specs(lp, MESHES[1])["layers"]["mlp"]
    assert dense["w_gate"] == (None, None, "model")
    assert dense["w_down"] == (None, "model", None)
    # ZeRO-1: a moment adds 'data' on the first free dim that divides
    mu = tsh.opt_state_specs(lp, MESHES[1]).mu
    assert mu["layers"]["mlp"]["w_gate"] == ("data", None, "model")
    assert mu["embed"] == ("model", "data")


class _Leaf:
    def __init__(self, shape):
        self.shape, self.ndim = tuple(shape), len(shape)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("B", [1, 3, 32, 256])
def test_batch_specs_match_reference(mesh, B):
    batch = {"tokens": _Leaf((B, 4096)), "labels": _Leaf((B, 4096)),
             "patches": _Leaf((B, 256, 2048))}
    want = {k: tuple(v) for k, v in jsh.batch_specs(batch, mesh).items()}
    assert tsh.batch_specs(batch, mesh) == want
    split = B % tsh._axis_size(mesh, tsh.dp_axes(mesh)) == 0
    assert (want["tokens"][0] is not None) == split


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-32b"])
def test_cache_specs_match_reference(arch):
    cfg, jcfg = get_arch(arch, smoke=True), j_get_arch(arch, smoke=True)
    jcache = j_get_model(jcfg).alloc_cache(jcfg, jc.PackKVConfig(), 2, 512)
    tcache = get_model(cfg).alloc_cache(cfg, tc.PackKVConfig(), 2, 512, "cpu")
    for mesh in MESHES + [FakeMesh({"data": 2, "model": 2})]:
        want = {k: v[1:] for k, v in _ref_specs(jsh.cache_specs(jcache, mesh)).items()}
        got = tsh.cache_specs(tcache[0], mesh)
        assert got == want, mesh.shape
        assert tsh.serving_cache_specs(tcache[0], mesh, head_axis="model") == {
            k: v[1:] for k, v in _ref_specs(
                jsh.serving_cache_specs(jcache, mesh, head_axis="model")).items()}


def test_constrain_returns_input():
    x = torch.randn(8, 16, 32)
    assert tsh.active_mesh() is None
    assert tsh.constrain(x, "batch", "model", None) is x
    tsh.set_active_mesh(FakeMesh({"data": 2, "model": 4}))
    try:
        y = tsh.constrain(x, "batch", "model", None)
        assert y is x and torch.equal(y, x)
        with pytest.raises(KeyError):
            tsh.constrain(x, "batch", "nope", None)
    finally:
        tsh.set_active_mesh(None)
    assert tsh.active_mesh() is None


# -- _moe_sharded against the reference's shard_map ----------------------

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import SMOKES
from repro.models import moe as jmoe

cfg = SMOKES["qwen2-moe-a2.7b"]
z = np.load(sys.argv[1])  # bf16 values, sent as f32
p = {k: jnp.asarray(z[k]).astype(jnp.float32 if k == "router" else jnp.bfloat16)
     for k in ("router", "w_gate", "w_up", "w_down")}
x = jnp.asarray(z["x"]).astype(jnp.bfloat16)
out = {}
for d, m in ((2, 1), (1, 2), (2, 2)):
    mesh = jax.make_mesh((d, m), ("data", "model"))
    f = jax.jit(lambda p, x: jmoe._moe_sharded(p, x, cfg, 1.25, mesh),
                compiler_options={"xla_allow_excess_precision": False})
    o, aux = f(p, x)
    out[f"out_{d}{m}"] = np.asarray(o.astype(jnp.float32))
    out[f"aux_{d}{m}"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


@pytest.fixture(scope="module")
def moe_case(tmp_path_factory):
    """The qwen2-moe smoke MLP of layer 0 with an identity router, hidden
    states whose router logits favour the low experts (their capacity
    binds), and the reference's outputs at the three meshes."""
    cfg = j_get_arch("qwen2-moe-a2.7b", smoke=True)
    E, D = cfg.n_experts, cfg.d_model
    params = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(1), cfg)
    mlp = {k: np.asarray(params["layers"]["mlp"][k][0])
           for k in ("router", "w_gate", "w_up", "w_down")}
    mlp["router"] = np.zeros((D, E), np.float32)
    mlp["router"][np.arange(E), np.arange(E)] = 1.0
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, D))
    score = rng.normal(size=(4, 32, E)) + np.linspace(1.5, 0.0, E)
    x[..., :E] = 0.25 * np.argsort(np.argsort(score, axis=-1), axis=-1)
    x = _bf16(x)
    d = tmp_path_factory.mktemp("moe")
    np.savez(d / "in.npz", **{k: np.asarray(v, np.float32)
                             for k, v in dict(mlp, x=x).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    subprocess.run([sys.executable, "-c", _CHILD, str(d / "in.npz"), str(d / "out.npz")],
                   check=True, env=env, timeout=300)
    with np.load(d / "out.npz") as f:
        ref = dict(f)
    return mlp, x, ref


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_moe_sharded_matches_reference(moe_case, data, model):
    mlp, x, ref = moe_case
    cfg = SMOKES["qwen2-moe-a2.7b"]
    p = {k: tensor_from_numpy(v, "cpu") for k, v in mlp.items()}
    mesh = FakeMesh({"data": data, "model": model})
    out, aux = tmoe._moe_sharded(p, tensor_from_numpy(x, "cpu"), cfg, 1.25, mesh)
    want = ref[f"out_{data}{model}"]
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0, atol=MOE_ATOL)
    np.testing.assert_allclose(float(aux), float(ref[f"aux_{data}{model}"]), rtol=1e-6)
    # the capacity follows each block's own token count: the one-block
    # dispatch of the whole batch routes otherwise (capacity binds)
    if data == 2:
        whole, _ = tmoe._moe_sharded(p, tensor_from_numpy(x, "cpu"), cfg, 1.25,
                                     FakeMesh({"data": 1, "model": model}))
        assert not torch.equal(whole, out)
    # the blocks are each the single-device dispatch of their rows
    blocks = [tmoe._dispatch_compute(
        tensor_from_numpy(x[b * 4 // data:(b + 1) * 4 // data], "cpu").reshape(-1, cfg.d_model),
        tensor_from_numpy(x[b * 4 // data:(b + 1) * 4 // data], "cpu").reshape(
            -1, cfg.d_model).float() @ p["router"],
        p["w_gate"], p["w_up"], p["w_down"], cfg.n_experts, cfg.moe_topk, 1.25)[0]
        for b in range(data)]
    single = torch.cat(blocks).view_as(out)
    if model == 1:
        assert torch.equal(single, out)
    else:  # Fe partials added in model order: within the bf16 rounding
        np.testing.assert_allclose(out.float().numpy(), single.float().numpy(),
                                   rtol=0, atol=MOE_ATOL)


# -- refusals --------------------------------------------------------------


def test_model_axis_refused_naming_16c():
    cfg = SMOKES["llama2-7b"]
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in token_batches(cfg, 0, 1, 2, 16)[0].items()}
    step = make_train_step(api, cfg, OPT)
    tsh.set_active_mesh(SpecMesh({"data": 1, "model": 2}))
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP item 16c"):
            step(params, init_opt_state(params), batch)
    finally:
        tsh.set_active_mesh(None)
    # the same step without the mesh runs
    _, _, m = step(params, init_opt_state(params), batch)
    assert np.isfinite(float(m["loss"]))
    # the reference's gradient pins are the 'model' axis's too
    with pytest.raises(NotImplementedError, match="ROADMAP item 16c"):
        make_train_step(api, cfg, OPT, param_pspecs=tsh.param_specs(params, SpecMesh(
            {"data": 1, "model": 2})))


@pytest.mark.parametrize("mesh,shape", [("prod", "(16, 16)"), ("prod-multi", "(2, 16, 16)")])
def test_launcher_prod_mesh_refuses_with_device_count(mesh, shape):
    with pytest.raises(ValueError) as e:
        launch_train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                           "--steps", "1", "--mesh", mesh])
    assert str(e.value) == f"Number of devices 1 must be >= the product of mesh_shape {shape}"
    assert tsh.active_mesh() is None
