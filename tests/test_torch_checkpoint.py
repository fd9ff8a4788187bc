"""Step checkpoints, gradient compression, the elastic plan and the train
launcher of the torch port, on the CPU: tests/test_checkpoint.py's cases
on the port's ``save`` / ``restore`` / ``gc_old`` / ``AsyncCheckpointer``,
the leaves of a params + OptState tree byte-equal to the reference's
``save`` of the same tree, ``grad_compress`` against the reference, and
the launcher's refusal and resume == uninterrupted."""
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save as ref_save
from repro.configs import SMOKES
from repro.distributed import fault as ref_fault
from repro.distributed import grad_compress as ref_gc
from repro.models import get_model as ref_model
from repro.training import optimizer as ro
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    gc_old,
    latest_step,
    restore,
    save,
)
from repro_torch.configs import SMOKES as PORT_SMOKES
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.distributed import downscale_plan
from repro_torch.distributed import grad_compress as gc
from repro_torch.launch import train as launch_train
from repro_torch.training import OptState
from repro_torch.utils import tree_flatten
from torch_threads import one_torch_thread  # noqa: F401


def _tree(rng):
    return {
        "w": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
        "b16": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)).to(torch.bfloat16),
        "opt": OptState(mu={"w": torch.zeros((8, 16))}, nu={"w": torch.ones((8, 16))},
                        step=torch.tensor(7, dtype=torch.int32)),
    }


def _assert_tree_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_tensor_leaves_restore_without_ml_dtypes(tmp_path, rng, monkeypatch):
    """A bf16 tensor leaf never needs ml_dtypes; a bf16 array leaf (the
    reference's kind) refuses with a clear error where it is missing."""
    import ml_dtypes

    t = _tree(rng)
    arr = {"a": np.ones(3, ml_dtypes.bfloat16)}
    save(str(tmp_path / "t"), 1, t)
    save(str(tmp_path / "n"), 1, arr)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    got, _ = restore(str(tmp_path / "t"), 1, t, device="cpu")
    _assert_tree_equal(t, got)
    with pytest.raises(ImportError, match="ml_dtypes is not installed"):
        restore(str(tmp_path / "n"), 1, arr, device="cpu")


def test_roundtrip(tmp_path, rng):
    t = _tree(rng)
    save(str(tmp_path), 5, t, {"stream": {"step": 5, "seed": 0}})
    assert latest_step(str(tmp_path)) == 5
    got, extra = restore(str(tmp_path), 5, t, device="cpu")
    assert extra["stream"]["step"] == 5
    _assert_tree_equal(t, got)  # bf16 kept


def test_uncommitted_checkpoint_invisible(tmp_path, rng):
    t = _tree(rng)
    save(str(tmp_path), 5, t)
    d = os.path.join(str(tmp_path), "step_00000009")  # a torn write
    os.makedirs(d)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{}")
    assert latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), 9, t, device="cpu")


def test_structure_mismatch_rejected(tmp_path, rng):
    t = _tree(rng)
    save(str(tmp_path), 1, t)
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"different": t["w"]}, device="cpu")


def test_gc_keeps_latest(tmp_path, rng):
    t = _tree(rng)
    for s in (1, 2, 3, 4):
        save(str(tmp_path), s, t)
    gc_old(str(tmp_path), keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_async_checkpointer(tmp_path, rng):
    t = _tree(rng)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ck.submit(s, t, {"s": s})
    ck.close()
    assert latest_step(str(tmp_path)) == 30
    assert not os.path.exists(os.path.join(str(tmp_path), "step_00000010"))
    got, extra = restore(str(tmp_path), 30, t, device="cpu")
    assert extra["s"] == 30
    _assert_tree_equal(t, got)


def test_async_snapshot_taken_at_submit(tmp_path, rng):
    """``submit`` copies to the host before it returns: an in-place update
    right after it (as the optimizer's) does not reach the saved step."""
    t = _tree(rng)
    want = {k: v.clone() for k, v in t.items() if k != "opt"}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.submit(1, t)
    t["w"].add_(1.0)
    t["b16"].mul_(2)
    t["opt"].mu["w"].fill_(3.0)
    ck.close()
    got, _ = restore(str(tmp_path), 1, t, device="cpu")
    assert torch.equal(got["w"], want["w"]) and torch.equal(got["b16"], want["b16"])
    assert torch.equal(got["opt"].mu["w"], torch.zeros((8, 16)))


def test_async_error_surfaces(tmp_path, rng):
    t = _tree(rng)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.submit(1, t)
    with pytest.raises(OSError):
        ck.close()


def _model_and_state(name="llama2-7b"):
    """The reference's params and a one-step OptState, and the port's
    copies of them (as numpy crosses)."""
    cfg = SMOKES[name]
    api = ref_model(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state, _ = ro.adamw_update(grads, ro.init_opt_state(params), params,
                                       ro.OptConfig(warmup_steps=1))
    nn = lambda t: jax.tree_util.tree_map(np.asarray, t)
    pcfg = PORT_SMOKES[name]
    port = (params_from_numpy(nn(params), pcfg, "cpu"),
            opt_state_from_numpy(nn(state.mu), nn(state.nu), np.asarray(state.step),
                                 pcfg, "cpu"))
    return (params, state), port


def test_leaves_byte_equal_to_reference(tmp_path):
    """The same params + OptState saved by each package: every leaf of
    arrays.npz byte-equal (keys, dtypes, shapes, bytes), and the manifests'
    n_leaves, dtypes and extra equal."""
    ref_tree, port_tree = _model_and_state()
    extra = {"stream": {"step": 3, "seed": 0}}
    ref_save(str(tmp_path / "r"), 3, ref_tree, extra)
    save(str(tmp_path / "p"), 3, port_tree, extra)
    d = lambda who: tmp_path / who / "step_00000003"
    with np.load(d("r") / "arrays.npz") as r, np.load(d("p") / "arrays.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            assert r[k].dtype == p[k].dtype and r[k].shape == p[k].shape, k
            assert r[k].tobytes() == p[k].tobytes(), k
    mr = json.loads((d("r") / "manifest.json").read_text())
    mp = json.loads((d("p") / "manifest.json").read_text())
    for key in ("step", "n_leaves", "dtypes", "extra"):
        assert mr[key] == mp[key], key
    assert os.path.exists(d("r") / "COMMIT") and os.path.exists(d("p") / "COMMIT")
    # tree_hash is each package's own fingerprint of its structure
    got, _ = restore(str(tmp_path / "p"), 3, port_tree, device="cpu")
    _assert_tree_equal(port_tree, got)


# ---------------------------------------------------------------------------
# gradient compression and the elastic plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,row,n", [(8, 64, 64 * 64), (4, 100, 1000), (2, 256, 1000)])
def test_grad_compress_matches_reference(bits, row, n, rng):
    """compress_leaf / decompress_leaf against the reference's op by op:
    q, scale, zero and the residual byte-exact (with a residual fed back
    in); the decompressed leaf byte-exact; wire_bits and the ratio equal."""
    g = rng.normal(size=(n,)).astype(np.float32)
    g[:row] = 0.25  # a constant row: scale 1 where hi == lo
    resid = rng.normal(size=(n + (-n) % row,)).astype(np.float32) * 0.01
    cfg, rcfg = gc.GradCompressConfig(bits=bits, row=row), ref_gc.GradCompressConfig(bits=bits, row=row)
    for r in (None, resid):
        got = gc.compress_leaf(torch.from_numpy(g), cfg, None if r is None else torch.from_numpy(r))
        want = ref_gc.compress_leaf(jnp.asarray(g), rcfg, None if r is None else jnp.asarray(r))
        for a, b in zip(got, want):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        out = gc.decompress_leaf(*got[:3], g.shape).numpy()
        assert out.tobytes() == np.asarray(ref_gc.decompress_leaf(*want[:3], g.shape)).tobytes()
    leaves = {"w": torch.zeros(n), "b": torch.zeros((3, 7))}
    ref_leaves = {"w": jnp.zeros(n), "b": jnp.zeros((3, 7))}
    assert gc.wire_bits(leaves, cfg) == ref_gc.wire_bits(ref_leaves, rcfg)
    assert gc.compression_ratio(leaves, cfg) == ref_gc.compression_ratio(ref_leaves, rcfg)


def test_grad_compress_roundtrip_bound(rng):
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    out, _ = gc.roundtrip_grads(g, gc.GradCompressConfig(bits=8, row=64), None)
    rows = g["w"].numpy().reshape(-1, 64)
    bound = (rows.max(1) - rows.min(1)).max() / (2 ** 8 - 1)
    assert float((out["w"] - g["w"]).abs().max()) <= bound * 0.51 + 1e-6


def test_grad_compress_error_feedback_reduces_bias(rng):
    """tests/test_distributed.py's bias test on the port: with error
    feedback the accumulated compressed sum tracks the true sum."""
    cfg = gc.GradCompressConfig(bits=2, row=256)
    g = {"w": torch.from_numpy(rng.normal(size=(1024,)).astype(np.float32))}
    true_sum, ef_sum, nf_sum = (np.zeros(1024) for _ in range(3))
    resid = gc.init_residuals(g, cfg)
    for _ in range(20):
        true_sum += g["w"].numpy()
        out_ef, resid = gc.roundtrip_grads(g, cfg, resid)
        ef_sum += out_ef["w"].numpy()
        out_nf, _ = gc.roundtrip_grads(g, cfg, None)
        nf_sum += out_nf["w"].numpy()
    err_ef = np.abs(ef_sum - true_sum).mean()
    err_nf = np.abs(nf_sum - true_sum).mean()
    assert err_ef < err_nf * 0.5, (err_ef, err_nf)


@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (2, 16, 16), (3, 4), (8,)])
def test_downscale_plan_matches_reference(shape):
    got = downscale_plan(shape, "exclude-straggler")
    want = ref_fault.downscale_plan(shape, "exclude-straggler")
    assert (got.old_shape, got.new_shape, got.reason, got.new_device_count) == \
        (want.old_shape, want.new_shape, want.reason, want.new_device_count)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["internvl2-2b", "hubert-xlarge"])
def test_launcher_refuses_non_token_archs(arch):
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert str(e.value) == (f"{arch}: train launcher supports token archs; "
                            "see examples/ for frames/patches training")


def test_launcher_resume_equals_uninterrupted(tmp_path, capsys):
    """8 steps uninterrupted against a --resume to 8 from that run's step-4
    checkpoint, copied alone into a fresh directory as a preempted run
    would leave it (WSD, grad_accum 2): the step-8 checkpoints bitwise
    equal (params, moments, step) and their stream states equal."""
    common = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "8",
              "--batch", "4", "--seq", "32", "--grad-accum", "2", "--schedule", "wsd",
              "--ckpt-every", "4", "--lr", "1e-3"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert launch_train.main(common + ["--ckpt-dir", a]) == 0
    shutil.copytree(os.path.join(a, "step_00000004"), os.path.join(b, "step_00000004"))
    assert latest_step(b) == 4
    assert launch_train.main(common + ["--ckpt-dir", b, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and out.count("training done") == 2
    da, db = (os.path.join(x, "step_00000008") for x in (a, b))
    with np.load(os.path.join(da, "arrays.npz")) as ra, \
            np.load(os.path.join(db, "arrays.npz")) as rb:
        assert sorted(ra.files) == sorted(rb.files)
        for k in ra.files:
            assert ra[k].tobytes() == rb[k].tobytes(), k
    ma = json.loads(open(os.path.join(da, "manifest.json")).read())
    mb = json.loads(open(os.path.join(db, "manifest.json")).read())
    assert ma["extra"] == mb["extra"] == {"stream": {"step": 8, "seed": 0}}
