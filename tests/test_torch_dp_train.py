"""Data-parallel training over gloo ranks on the CPU (the ranks are
spawned once a group and do every rank-side check; tests/torch_dp_helpers.py
holds their code). Each rank and its single-process control run at one
thread, in the same process where they are compared bitwise.

  * the data = 2 steps of llama2-7b and qwen2-moe-a2.7b smoke, from the
    reference's init, against the reference's own steps with the batch
    sharded over a (data = 2, model = 1) mesh (``set_active_mesh`` set,
    so its MoE dispatches each data block alone; a child process with 4
    forced host devices, run while the ranks run): every step's loss and
    grad norm, and the parameters and first moments after the first step,
    by item 15's bars. (A second step's MoE moments are not held: there
    the port's grad_accum = 2 step parts from the reference's
    single-device grad_accum = 2 step as far as from its mesh step, by up
    to 0.23 of a leaf's max: ROADMAP Queue 3.);
  * a data = 2 step equals the single-process grad_accum = 2 step bitwise
    (every step's loss, grad norm and step; every parameter; both
    moments, gathered whole from the ZeRO-1 slices) for llama2-7b,
    qwen2-moe-a2.7b (its MoE dispatches a rank's rows alone, as the
    control dispatches a microbatch) and rwkv6-1.6b smoke; data = 4
    equals grad_accum = 4 for llama2-7b;
  * ZeRO-1 moments equal replicated moments bitwise;
  * a batch of 3 rows over data = 2 is replicated (``batch_specs``'
    fallback) and equals the single-process step bitwise;
  * data = 2 with grad_accum = 2 sums in another order than grad_accum =
    4: held by item 15's bars (loss 1e-3, parameters 5e-3, grad norm 1e-2
    relative, first moments 0.1 of a leaf's max);
  * the launcher: two ranks train 4 steps with a checkpoint every 2; one
    process resumes run 1's step-2 checkpoint at --grad-accum 2, and its
    step-4 checkpoint equals run 1's byte for byte, leaf for leaf;
  * ``compressed_psum_mean`` over 2 and 4 ranks is byte-exact against the
    reference under ``jax.vmap(..., axis_name="data")`` at bits 2, 4 and 8,
    on a leaf of whole rows and on one whose last row is padded."""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_helpers as h
from repro.configs import SMOKES
from repro.distributed import grad_compress as jgc
from repro.models import get_model as ref_model
from repro_torch.configs import SMOKES as PORT_SMOKES
from repro_torch.convert import params_from_numpy

# the reference's train step under a (data = 2, model = 1) mesh: params and
# moments replicated, each batch leaf placed by ``batch_specs``
_REF_CHILD = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SMOKES
from repro.distributed import sharding as shd
from repro.models import get_model
from repro.training.optimizer import OptConfig, init_opt_state
from repro.training.train import make_train_step

d = sys.argv[1]
with open(os.path.join(d, "ref_in.pkl"), "rb") as f:
    inputs = pickle.load(f)
# Auto axes: under this JAX's default (Explicit) axes the embedding's
# gather of a data-sharded batch does not trace
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rep = NamedSharding(mesh, P())
shd.set_active_mesh(mesh)
out = {}
with mesh:
    for name, (params, batches) in inputs.items():
        cfg = SMOKES[name]
        api = get_model(cfg)
        params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), rep)
        opt = jax.device_put(init_opt_state(params), rep)
        step = jax.jit(make_train_step(api, cfg, OptConfig(**OPT)),
                       compiler_options={"xla_allow_excess_precision": False})
        tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
        metrics = []
        for b in batches:
            specs = shd.batch_specs(b, mesh)
            b = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k]))
                 for k, v in b.items()}
            params, opt, m = step(params, opt, b)
            metrics.append({k: np.asarray(v) for k, v in m.items()})
            if len(metrics) == 1:
                out[name] = {"params": tree(params), "mu": tree(opt.mu)}
        out[name]["metrics"] = metrics
shd.set_active_mesh(None)
with open(os.path.join(d, "ref_out.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def _spawn(fn, world: int, d) -> list[dict]:
    mp.spawn(fn, args=(world, str(d)), nprocs=world, join=True)
    name = fn.__name__.removesuffix("_rank")
    return [torch.load(os.path.join(d, f"{name}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """The two-rank group, started from the reference's init of
    REF_MODELS (saved in the run's directory as port tensors), while a
    child runs the reference's mesh step on the same init and batches
    (its result in ``ref_out.pkl``, its output in ``ref_child.log``)."""
    d = tmp_path_factory.mktemp("dp2")
    inputs = {}
    for name in h.REF_MODELS:
        cfg = SMOKES[name]
        params = jax.tree_util.tree_map(
            np.asarray, ref_model(cfg).init(jax.random.PRNGKey(0), cfg))
        torch.save(params_from_numpy(params, PORT_SMOKES[name], "cpu"),
                   h.init_path(str(d), name))
        inputs[name] = (params, h.token_batches(cfg, 0, h.STEPS, h.B, h.S))
    with open(d / "ref_in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    oc = h.OPT
    script = f"OPT = dict(lr={oc.lr!r}, warmup_steps={oc.warmup_steps!r}, " \
             f"total_steps={oc.total_steps!r})\n" + _REF_CHILD
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    with open(d / "ref_child.log", "wb") as log:
        child = subprocess.Popen([sys.executable, "-c", script, str(d)], env=env,
                                 stdout=log, stderr=subprocess.STDOUT)
        try:
            ranks = _spawn(h.dp2_rank, 2, d)
        finally:
            child.wait(timeout=300)
    return ranks, d


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    return _spawn(h.dp4_rank, 4, tmp_path_factory.mktemp("dp4"))


@pytest.mark.parametrize("name", h.DP_MODELS)
def test_data2_equals_grad_accum2_bitwise(dp2, name):
    (r0, r1), _ = dp2
    assert h.bitwise_diff(r0[name, "dp"], r0[name, "ctl"]) == []
    assert h.bitwise_diff(r1[name, "dp"], r0[name, "ctl"]) == []  # every rank
    assert int(r0[name, "dp"]["step"]) == h.STEPS


def test_data4_equals_grad_accum4_bitwise(dp4):
    ctl = dp4[0]["ctl"]
    for r in dp4:
        assert h.bitwise_diff(r["dp"], ctl) == []


def test_zero1_equals_replicated_moments(dp2):
    (r0, _), _ = dp2
    assert h.bitwise_diff(r0["llama2-7b", "dp"], r0["replicated"]) == []


def test_batch_fallback_equals_single_process(dp2):
    (r0, r1), _ = dp2
    for r in (r0, r1):
        assert h.bitwise_diff(r["fallback", "dp"], r0["fallback", "ctl"]) == []


def _within_item15_bars(got: dict, want: dict) -> None:
    """Every step's loss within 1e-3 and grad norm within 1e-2 relative,
    the same step count; every parameter within 5e-3; each first moment
    within 0.1 of its leaf's max."""
    _metrics_within_item15_bars(got["metrics"], want["metrics"])
    _state_within_item15_bars(got, want)


def _metrics_within_item15_bars(got: list, want: list) -> None:
    assert len(got) == len(want) == h.STEPS
    for mg, mw in zip(got, want):
        assert abs(float(mg["loss"]) - float(mw["loss"])) < 1e-3
        gw = float(mw["grad_norm"])
        assert abs(float(mg["grad_norm"]) - gw) / gw <= 1e-2
        assert int(mg["step"]) == int(mw["step"])


def _state_within_item15_bars(got: dict, want: dict) -> None:
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        assert float((got["params"][k].float() - w.float()).abs().max()) < 5e-3, k
    for k, w in want["mu"].items():
        gap = float((got["mu"][k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert gap <= 0.1, k


def test_data2_accum2_within_item15_bars(dp2):
    (r0, _), _ = dp2
    _within_item15_bars(r0["accum2", "dp"], r0["accum4", "ctl"])


@pytest.mark.parametrize("name", h.REF_MODELS)
def test_data2_step_matches_reference_mesh_step(dp2, name):
    (r0, _), d = dp2
    out = d / "ref_out.pkl"
    assert out.exists(), (d / "ref_child.log").read_text()[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)[name]
    cfg = PORT_SMOKES[name]
    got = r0[name, "dp"]
    _metrics_within_item15_bars(got["metrics"], ref["metrics"])
    _state_within_item15_bars(got["first"], {
        "params": h.flat(params_from_numpy(ref["params"], cfg, "cpu")),
        "mu": h.flat(params_from_numpy(ref["mu"], cfg, "cpu"))})


def test_launcher_two_ranks_resumed_on_one_process(dp2):
    _, d = dp2
    ck = lambda run: os.path.join(d, run, "step_00000004", "arrays.npz")
    with np.load(ck("run1")) as a, np.load(ck("run2")) as b:
        assert sorted(a.files) == sorted(b.files)
        diff = [k for k in a.files if a[k].tobytes() != b[k].tobytes()]
    assert diff == []


def _ref_psum(n: int, bits: int, shape) -> np.ndarray:
    cfg = jgc.GradCompressConfig(bits=bits, row=h.PSUM_ROW)
    f = jax.vmap(lambda x: jgc.compressed_psum_mean({"w": x}, cfg, axis="data")["w"],
                 axis_name="data")
    return np.asarray(f(jnp.asarray(h.psum_replicas(n, bits, shape))))


@pytest.mark.parametrize("case", h.PSUM_CASES, ids=[f"b{b}-{s[0]}x{s[1]}" for b, s in h.PSUM_CASES])
def test_compressed_psum_mean_matches_reference(dp2, dp4, case):
    bits, shape = case
    for ranks in (dp2[0], dp4):
        want = _ref_psum(len(ranks), bits, shape)
        for r, res in enumerate(ranks):
            got = res["psum"][case].numpy()
            assert got.shape == shape
            assert got.tobytes() == want[r].tobytes(), (len(ranks), r)
