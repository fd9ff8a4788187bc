"""Tensor-parallel training over gloo ranks on the CPU (the ranks are
spawned once a group and make every rank-side run; tests/torch_tp_helpers.py
holds their code). Each rank and its single-process control run at one
thread, in the same process where they are compared.

  * every token family (llama2-7b, smollm-135m, qwen3-32b, qwen2-moe-a2.7b,
    rwkv6-1.6b, recurrentgemma-9b smoke) at (data 1, model 2) against the
    single-process step from the same init, by item 15's bars (loss 1e-3,
    grad norm 1e-2 relative, parameters 5e-3, first moments 0.1 of a
    leaf's max): with f32 parameters every step's loss and grad norm and
    the final state; with bf16 parameters the first step's loss, every
    step's grad norm and the state after the first step (the second
    step's loss moves by up to ~2.5e-3 between two equivalent bf16
    computations: AdamW's first update rounds each bf16 parameter, and
    bf16 gradients that differ by rounding round some the other way;
    ROADMAP Queue 3); both ranks report the same; in f32 likewise a
    stream of 63 positions, which 2 does not divide (every rank holds it
    whole: llama2-7b, qwen2-moe-a2.7b, rwkv6-1.6b, recurrentgemma-9b),
    and internvl2-2b's patch prefix;
  * (data 2, model 2) equals (1, 2) at grad_accum 2 bitwise (llama2-7b and
    qwen2-moe-a2.7b, ZeRO-1 moments), and a second (1, 2) run of
    llama2-7b equals the first bitwise;
  * (1, 2) and (2, 2) of llama2-7b and qwen2-moe-a2.7b, from the
    reference's init, against the reference's own steps under the same
    meshes (parameters placed by ``to_named(param_specs)``,
    ``param_pspecs`` and ``accum_pspecs`` passed, ``set_active_mesh`` set;
    a child process with 4 forced host devices, run while the ranks run):
    the first step's loss, every step's grad norm and the state after the
    first step by item 15's bars, and llama2-7b's second loss too;
  * the exchange functions (``copy_to``, ``reduce_from``, ``gather_along``,
    ``scatter_along``, ``split_along``, ``grad_on_first``): values and
    gradients against their single-device forms;
  * a rank holds 1/2 of every leaf the rule splits over 'model' (the MoE
    experts by Fe at the rule's bytes);
  * a checkpoint written at (1, 2) holds full arrays; resumed at (1, 2) it
    equals the uninterrupted run bitwise, at (2, 1) it equals the (1, 1)
    resume at grad_accum 2 bitwise, and at (1, 1) it is within item 15's
    bars of the (1, 2) run;
  * the launcher over a (1, 2) mesh (its mesh factory given a 'model'
    axis: ``--mesh prod`` needs 256 ranks) writes full-array checkpoints,
    and one process resumes them."""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_helpers as dh
import torch_tp_helpers as h
from repro.configs import SMOKES
from repro.models import get_model as ref_model
from repro_torch.checkpoint import restore
from repro_torch.configs import SMOKES as PORT_SMOKES
from repro_torch.convert import params_from_numpy
from repro_torch.models import get_model
from repro_torch.training import init_opt_state
from test_torch_dp_train import _metrics_within_item15_bars, _state_within_item15_bars
from torch_threads import one_torch_thread  # noqa: F401

# the reference's train step under (data, model) = (1, 2) and (2, 2)
_REF_CHILD = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import SMOKES
from repro.distributed import sharding as shd
from repro.models import get_model
from repro.training.optimizer import OptConfig, init_opt_state
from repro.training.train import make_train_step

d = sys.argv[1]
with open(os.path.join(d, "ref_in.pkl"), "rb") as f:
    inputs = pickle.load(f)
out = {}
for shape in ((1, 2), (2, 2)):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shd.set_active_mesh(mesh)
    with mesh:
        for name, (params, batches) in inputs.items():
            cfg = SMOKES[name]
            api = get_model(cfg)
            params = jax.tree_util.tree_map(jnp.asarray, params)
            pspecs = shd.param_specs(params, mesh)
            ospecs = shd.opt_state_specs(params, mesh)
            params = jax.device_put(params, shd.to_named(pspecs, mesh))
            opt = jax.device_put(init_opt_state(params), shd.to_named(ospecs, mesh))
            step = jax.jit(make_train_step(api, cfg, OptConfig(**OPT), param_pspecs=pspecs,
                                           accum_pspecs=ospecs.mu),
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
                    out[name, shape] = {"params": tree(params), "mu": tree(opt.mu)}
            out[name, shape]["metrics"] = metrics
    shd.set_active_mesh(None)
# the MoE's single-device steps, at grad_accum 1 and 2 (each row block
# routed alone, as a data rank's): the oracle of its mesh steps' losses
# and state (ROADMAP Queue 3)
for name, (params, batches) in inputs.items():
    cfg = SMOKES[name]
    if cfg.family != "moe":
        continue
    for accum in (1, 2):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        opt = init_opt_state(p)
        step = jax.jit(make_train_step(get_model(cfg), cfg, OptConfig(**OPT), accum),
                       compiler_options={"xla_allow_excess_precision": False})
        metrics = []
        for b in batches:
            p, opt, m = step(p, opt, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: np.asarray(v) for k, v in m.items()})
            if len(metrics) == 1:
                out[name, "single", accum] = {"params": tree(p), "mu": tree(opt.mu)}
        out[name, "single", accum]["metrics"] = metrics
with open(os.path.join(d, "ref_out.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def _spawn(fn, world: int, d) -> list[dict]:
    mp.spawn(fn, args=(world, str(d)), nprocs=world, join=True)
    name = fn.__name__.removesuffix("_rank")
    return [torch.load(os.path.join(d, f"{name}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two-rank group's results, the four-rank group's, the run's
    directory), started from the reference's init of REF_MODELS (saved
    there as port tensors), while a child runs the reference's mesh steps
    on the same init and batches (``ref_out.pkl``, its output in
    ``ref_child.log``)."""
    d = tmp_path_factory.mktemp("tp")
    inputs = {}
    for name in h.REF_MODELS:
        cfg = SMOKES[name]
        params = jax.tree_util.tree_map(
            np.asarray, ref_model(cfg).init(jax.random.PRNGKey(0), cfg))
        torch.save(params_from_numpy(params, PORT_SMOKES[name], "cpu"),
                   h.init_path(str(d), name))
        inputs[name] = (params, h.batches(name))
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
            two = _spawn(h.tp2_rank, 2, d)
            four = _spawn(h.tp4_rank, 4, d)
        finally:
            child.wait(timeout=300)
    return two, four, d


def _ref(d, name: str, shape) -> dict:
    out = d / "ref_out.pkl"
    assert out.exists(), (d / "ref_child.log").read_text()[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)[(name, shape) if isinstance(shape[0], int) else (name, *shape)]


def _step1_within_item15_bars(got: dict, want: dict) -> None:
    """bf16 parameters: the first step's loss, every step's grad norm and
    the state after the first step, by item 15's bars (a second step's
    loss sits at the noise of bf16 parameters, ROADMAP Queue 3)."""
    assert len(got["metrics"]) == len(want["metrics"]) == h.STEPS
    _metrics_within_item15_bars(got["metrics"][:1] * h.STEPS, want["metrics"][:1] * h.STEPS)
    for mg, mw in zip(got["metrics"], want["metrics"]):
        gw = float(mw["grad_norm"])
        assert abs(float(mg["grad_norm"]) - gw) / gw <= 1e-2
        assert int(mg["step"]) == int(mw["step"])
    _state_within_item15_bars(got["first"], want["first"])


@pytest.mark.parametrize("name", h.TP_MODELS)
def test_model2_within_item15_bars_of_single_process(runs, name):
    (r0, r1), _, _ = runs
    # f32 parameters: every step and the final state
    _metrics_within_item15_bars(r0[name, "tp32"]["metrics"], r0[name, "ctl32"]["metrics"])
    _state_within_item15_bars(r0[name, "tp32"], r0[name, "ctl32"])
    _step1_within_item15_bars(r0[name, "tp"], r0[name, "ctl"])
    for kind in ("tp", "tp32"):  # every rank: the same step
        assert dh.bitwise_diff(r1[name, kind], r0[name, kind]) == []


@pytest.mark.parametrize("kind", sorted(h.LAYOUTS))
def test_replicated_stream_and_patch_prefix_within_item15_bars(runs, kind):
    (r0, r1), _, _ = runs
    _metrics_within_item15_bars(r0[kind, "tp32"]["metrics"], r0[kind, "ctl32"]["metrics"])
    _state_within_item15_bars(r0[kind, "tp32"], r0[kind, "ctl32"])
    assert dh.bitwise_diff(r1[kind, "tp32"], r0[kind, "tp32"]) == []


@pytest.mark.parametrize("name", h.REF_MODELS)
def test_data2_model2_equals_model2_grad_accum2_bitwise(runs, name):
    (r0, _), four, _ = runs
    for r in four:
        assert dh.bitwise_diff(r[name, "tp"], r0[name, "accum2"]) == []
        assert int(r[name, "tp"]["step"]) == h.STEPS


def test_repeated_runs_bitwise(runs):
    (r0, r1), _, _ = runs
    assert dh.bitwise_diff(r0["repeat"], r0["llama2-7b", "tp"]) == []
    assert dh.bitwise_diff(r1["repeat"], r0["llama2-7b", "tp"]) == []


def _ref_state(ref: dict, cfg) -> dict:
    return {"metrics": ref["metrics"], "first": {
        "params": dh.flat(params_from_numpy(ref["params"], cfg, "cpu")),
        "mu": dh.flat(params_from_numpy(ref["mu"], cfg, "cpu"))}}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", h.REF_MODELS)
def test_mesh_step_matches_reference_mesh_step(runs, name, shape):
    (r0, _), four, d = runs
    ref = _ref(d, name, shape)
    got = r0[name, "tp"] if shape == (1, 2) else four[0][name, "tp"]
    cfg = PORT_SMOKES[name]
    if cfg.family == "dense":  # every step's loss and grad norm, the first state
        _step1_within_item15_bars(got, _ref_state(ref, cfg))
        _metrics_within_item15_bars(got["metrics"], ref["metrics"])
        return
    # the MoE: the reference's mesh step rounds each 'model' partial sum to
    # bf16, and its routing then parts from its own single-device step's by
    # more than the bars (ROADMAP Queue 3); the port's mesh step rounds as
    # the single device does, so it is held against the reference's
    # single-device step over the same row blocks, and against the mesh
    # step's grad norms
    single = _ref(d, name, ("single", shape[0]))
    _step1_within_item15_bars(got, _ref_state(single, cfg))
    for mg, mw in zip(got["metrics"], ref["metrics"]):
        gw = float(mw["grad_norm"])
        assert abs(float(mg["grad_norm"]) - gw) / gw <= 1e-2


@pytest.mark.parametrize("fn", ["copy_to", "reduce_from", "gather_along", "scatter_along",
                                "split_along", "grad_on_first"])
def test_exchange_function_values_and_gradients(runs, fn):
    (r0, r1), _, _ = runs
    for res in (r0, r1):
        (y, g), (y_want, g_want) = res["functions"][fn]
        assert y.dtype == g.dtype == torch.bfloat16
        assert torch.equal(y, y_want), fn
        assert torch.equal(g, g_want), fn


@pytest.mark.parametrize("name", h.TP_MODELS)
def test_rank_holds_its_share_of_every_split_leaf(runs, name):
    (r0, r1), _, _ = runs
    for res in (r0, r1):
        local, rule, full = res["bytes"][name]
        assert local == rule < full


def test_checkpoint_full_arrays_resume_at_other_meshes(runs):
    (r0, r1), _, d = runs
    cfg = PORT_SMOKES["llama2-7b"]
    like = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    (params, opt), _ = restore(os.path.join(d, "ckpt"), h.CKPT_STEP,
                               (like, init_opt_state(like)), "cpu")
    first = r0["ckpt_12"]["first"]
    assert first["params"].keys() == dh.flat(params).keys()
    for k, v in dh.flat(params).items():  # full arrays, the gathered blocks
        assert v.shape == first["params"][k].shape and torch.equal(v, first["params"][k]), k
    for k, v in dh.flat(opt.mu).items():
        assert torch.equal(v, first["mu"][k]), k
    # resumed at (1, 2): the uninterrupted run's second step, bitwise
    for r in (r0, r1):
        res, ctl = r["resume_12"], r0["ckpt_12"]
        assert dh.bitwise_diff(dict(res, metrics=[]), dict(ctl, metrics=[])) == []
        assert [m["loss"] for m in res["metrics"]] == [m["loss"] for m in ctl["metrics"][1:]]
    # resumed at (2, 1): the (1, 1) resume at grad_accum 2, bitwise
    for r in (r0, r1):
        assert dh.bitwise_diff(r["resume_21"], r0["resume_11_accum2"]) == []
    # resumed at (1, 1): item 15's bars of the (1, 2) run
    _state_within_item15_bars(r0["resume_11"], r0["ckpt_12"])


def test_launcher_model_axis_checkpoint_resumed_by_one_process(runs):
    (r0, r1), _, d = runs
    assert r0["launch_rc"] == r1["launch_rc"] == 0
    assert r0["launch_resume_rc"] == 0
    cfg = PORT_SMOKES["smollm-135m"]
    like = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    for step in (2, 4):  # the (1, 2) run's checkpoint, then the resumed one's
        (params, opt), extra = restore(os.path.join(d, "launch"), step,
                                       (like, init_opt_state(like)), "cpu")
        for k, v in dh.flat(params).items():  # full arrays
            assert v.shape == dh.flat(like)[k].shape, k
        assert int(opt.step) == step and "stream" in extra
