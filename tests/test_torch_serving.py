"""The torch port's serving slice (llama2-7b-smoke, dense PackKV cache)
against the JAX reference, with the reference's weights carried across by
``convert.params_from_numpy``, plus the port's import isolation.

The reference engine is compiled without excess precision (its written
bf16 rounding), as ``torch_port_helpers.EXACT`` says. Logits agree within
LOGIT_ATOL: four bf16 ulps at the smoke model's logit magnitudes (2..4),
the rounding of bf16 matmuls summed in another order. Greedy tokens must
be equal until the reference's top-2 margin drops below that tolerance
(a tie the rounding may break either way)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.cache import PackKVConfig as JPack
from repro.models import get_model as j_get_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SlotServer as JSlotServer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.cache import PackKVConfig
from repro_torch.serving import Engine, EngineConfig, Request, SlotServer
from torch_port_helpers import (
    EXACT,
    LOGIT_ATOL,
    margin,
    spec_tuple,
    steps_before_tie,
)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CAP = 256


@pytest.fixture(scope="module")
def smoke():
    cfg = j_get_arch("llama2-7b", smoke=True)
    jparams = j_get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch("llama2-7b", smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


def _ref_engine(cfg, params, policy, **kw):
    """The reference engine with every dispatch compiled by EXACT."""
    def lane_jit(self, fn, *, static=(), donate=()):
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEngine, "_lane_jit", lane_jit)
        return JEngine(cfg, params, JPack(policy=policy),
                       JEngineConfig(capacity=CAP, prefill_chunk_pages=0,
                                     backend="xla", **kw))


def _engines(smoke, policy, **kw):
    cfg, jparams, tcfg, tparams = smoke
    je = _ref_engine(cfg, jparams, policy, **kw)
    te = Engine(tcfg, tparams, PackKVConfig(policy=policy),
                EngineConfig(capacity=CAP, device="cpu", **kw))
    for a, b in ((te.pack_cfg.k_spec_static, je.pack_cfg.k_spec_static),
                 (te.pack_cfg.v_spec_static, je.pack_cfg.v_spec_static)):
        assert (a is None) == (b is None) and (a is None or spec_tuple(a) == spec_tuple(b))
    return je, te


def test_layers_match_reference():
    """rmsnorm / swiglu / RoPE in bf16 within one bf16 ulp-level rounding,
    flash_attention (two 1024-query chunks, the causal skip) in f32."""
    from repro.models import layers as jl

    from repro_torch.convert import tensor_from_numpy
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(3)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    T = lambda a: tensor_from_numpy(a, "cpu")
    f32 = lambda t: t.to(torch.float32).numpy()
    x, w = bf(rng.normal(size=(2, 5, 64))), bf(1 + 0.1 * rng.normal(size=(64,)))
    np.testing.assert_allclose(f32(tl.rmsnorm(T(x), T(w))),
                               np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(w)), np.float32),
                               rtol=1e-2, atol=1e-2)
    wg, wu, wd = (bf(rng.normal(size=s) / 8) for s in ((64, 96), (64, 96), (96, 64)))
    np.testing.assert_allclose(
        f32(tl.swiglu(T(x), T(wg), T(wu), T(wd))),
        np.asarray(jl.swiglu(*map(jnp.asarray, (x, wg, wu, wd))), np.float32),
        rtol=2e-2, atol=2e-2)
    q = bf(rng.normal(size=(2, 3, 5, 32)))
    pos = np.array([0, 7, 100, 1000, 4095])
    np.testing.assert_allclose(f32(tl.apply_rope(T(q), torch.from_numpy(pos))),
                               np.asarray(jl.apply_rope(jnp.asarray(q), jnp.asarray(pos)),
                                          np.float32), rtol=1e-2, atol=1e-2)
    S = 2048
    qf = rng.normal(size=(1, 4, S, 16)).astype(np.float32)
    kf, vf = (rng.normal(size=(1, 2, S, 16)).astype(np.float32) for _ in range(2))
    want = jax.jit(jl.flash_attention)(*map(jnp.asarray, (qf, kf, vf)))
    got = tl.flash_attention(*map(torch.from_numpy, (qf, kf, vf)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):  # a prompt above 1024 must be a multiple of it
        tl.flash_attention(*(torch.zeros((1, 1, 1500, 8)) for _ in range(3)))


@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_logits_and_greedy_tokens_match_reference(smoke, policy):
    """Prefill and 16 decode steps: logits within LOGIT_ATOL, greedy tokens
    equal (margin rule), at least 8 steps compared."""
    je, te = _engines(smoke, policy, max_batch=1)
    toks = np.random.default_rng(0).integers(0, 512, (1, 127))
    jl, jcache = je.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tcache = te.prefill({"tokens": toks})
    compared, tie = 0, False
    for step in range(17):
        want, got = np.asarray(jl)[0], tl.numpy()[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        tie = tie or margin(want) < LOGIT_ATOL
        if not tie:
            assert got.argmax() == want.argmax(), step
            compared += 1
        tok = np.asarray([[want.argmax()]], np.int32)  # both follow the reference
        if step < 16:
            jl, jcache = je.decode(jcache, jnp.asarray(tok))
            tl, tcache = te.decode(tcache, tok)
    assert compared >= 8


def _requests(cls, rng):
    lens, max_new = (127, 90, 191, 127, 60), (80, 30, 70, 20, 75)
    return [cls(rid=i, tokens=rng.integers(0, 512, n), max_new=m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def test_slot_server_matches_generate_and_reference(smoke):
    """5 requests through 2 slots (slot reuse, per-row flushes): each
    request's tokens equal the port's own B=1 generate, and the reference
    SlotServer's until the first near-tie of the B=1 run."""
    je, te = _engines(smoke, "packkv", max_batch=2, decode_chunk=8)
    server = SlotServer(te)
    for r in _requests(Request, np.random.default_rng(5)):
        server.submit(r)
    done = {r.rid: r for r in server.run()}
    assert server.stats.slot_reuses == 3 and server.stats.completed == 5
    jserver = JSlotServer(je)
    for r in _requests(JRequest, np.random.default_rng(5)):
        jserver.submit(r)
    ref = {r.rid: np.asarray(r.output) for r in jserver.run()}
    compared = []
    for rid, req in done.items():
        out = np.asarray(req.output)
        gen, cache = te.generate({"tokens": req.tokens[None]}, req.max_new)
        np.testing.assert_array_equal(out, gen[0], err_msg=f"request {rid}")
        if rid == 0:  # 127 prompt + 79 appends: the residual flushed once
            assert cache[0].n_comp.tolist() == [128]
        b1, n = steps_before_tie(te, req.tokens, req.max_new)
        assert b1 == list(out[:n])
        np.testing.assert_array_equal(out[:n], ref[rid][:n], err_msg=f"request {rid}")
        compared.append(n)
    print("tokens compared with the reference per request:", compared)
    assert sum(compared) >= 40, compared


def test_per_token_launches_equal_chunked_launches(smoke):
    """decode_chunk=1 (one launch per token, free rows re-zeroed by the
    scheduler) gives the same tokens as 8-step launches."""
    _, _, tcfg, tparams = smoke
    outs = []
    for chunk in (1, 8):
        te = Engine(tcfg, tparams, PackKVConfig(),
                    EngineConfig(capacity=CAP, max_batch=2, decode_chunk=chunk,
                                 device="cpu"))
        server = SlotServer(te)
        for r in _requests(Request, np.random.default_rng(5))[2:]:
            server.submit(r)
        outs.append({r.rid: list(r.output) for r in server.run()})
    assert outs[0] == outs[1]


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--smoke", "--device", "cpu", "--requests", "3", "--max-new",
                 "5", "--prompt-len", "96", "--batch", "2", "--capacity",
                 "256"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 15 tokens" in out and "fused kernel launches: 0" in out


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro(\s|$|\.|,)|from repro(\.|\s))",
                        re.M)


def test_port_sources_import_no_jax_or_reference():
    for f in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert not _FORBIDDEN.search(f.read_text()), f
    assert not _FORBIDDEN.search((ROOT / "chip_smoke.py").read_text())


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr


def test_chip_smoke_refuses_without_cuda():
    """No CPU fallback: without a card the script fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr + r.stdout
    assert '"ok": true' not in r.stdout
