"""The port's examples (examples/torch/) run to completion on the CPU at a
few steps, and no file of the port, its examples or chip_smoke.py imports
JAX or the reference.

  * quickstart: calibrate, prefill, append, decode through the fused
    entry point (its plain version here) against the ref path and the
    uncompressed attention; the cache is smaller than bf16;
  * serve_packkv: the same requests through an uncompressed and a PackKV
    engine;
  * train_smollm: the full smollm-135m config, 2 steps of 2 x 64 tokens
    at grad_accum 2, with a checkpoint directory;
  * elastic_restart: the smoke model preempted and restarted from its
    checkpoint, the replayed losses bitwise equal (the example asserts it)."""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch"


def _run(name: str, argv: list) -> str:
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def test_quickstart():
    out = _run("quickstart", ["--device", "cpu"])
    delta = float(re.search(r"max \|delta\| vs the ref path: (\S+)", out).group(1))
    assert delta < 1e-4, out
    ratio = float(re.search(r"-> ([\d.]+)x", out).group(1))
    assert ratio > 1.0, out
    assert "compressed 512 tokens" in out


def test_serve_packkv():
    out = _run("serve_packkv", ["--device", "cpu", "--requests", "4", "--max-new", "6"])
    assert out.count("served 4 requests") == 2, out
    assert "greedy-token agreement" in out


def test_train_smollm(tmp_path):
    out = _run("train_smollm", ["--device", "cpu", "--steps", "2", "--batch", "2",
                                "--seq", "64", "--ckpt-dir", str(tmp_path)])
    assert "smollm-135m: 163M params" in out and "step    1" in out
    assert re.search(r"done: final loss \d+\.\d+", out), out


def test_elastic_restart():
    out = _run("elastic_restart", ["--device", "cpu"])
    assert "max loss drift 0.00e+00" in out
    assert "elastic restart drill PASSED" in out


@pytest.mark.parametrize("where", ["src/repro_torch", "examples/torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_reference(where):
    path = ROOT / where
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    bad = [f"{f.relative_to(ROOT)}: {line.strip()}" for f in files
           for line in f.read_text().splitlines()
           if re.match(r"^\s*(import|from) (jax|repro)\b", line)]
    assert files and bad == []
