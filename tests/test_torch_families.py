"""The torch port's VLM (internvl2-2b smoke: a patch-embedding prefix) and
encoder (hubert-xlarge smoke: frame inputs, ``encode``) against the JAX
reference, with the reference's weights carried across by
``convert.params_from_numpy`` and the reference compiled without excess
precision (``torch_port_helpers.EXACT``).

  * internvl2-2b: the prefill of 16 patches and 112 tokens, B = 2: the
    last-token logits within LOGIT_ATOL, and every layer's cache
    byte-exact with the reference's ``prefill_cache`` of the port's own
    K/V (zero-points under the FMA rule; past layer 0 the two packages'
    K/V carry other bf16 roundings); the engines' calibrated specs
    (tokens, then patches, from one generator) byte-exact; 8 decode steps
    of ``Engine.generate``'s loop teacher-forced by the reference's greedy
    tokens, logits within LOGIT_ATOL and the tokens equal under the margin
    rule; ``SlotServer`` refuses the engine with ValueError, as the
    reference's does.
  * hubert-xlarge: ``encode`` of 2 x 96 frames (non-causal attention, the
    final norm, no cache) within ENC_ATOL of the reference's.
  * ``launch/serve.py`` refuses both configs with the reference's
    messages.
  * ``params_from_numpy`` on the moe, vlm and encoder families: the same
    keys, shapes and dtypes as the reference's tree and as the port's own
    init (the MoE router f32, its ``shared`` dict nested; no embedding for
    frame inputs)."""
import dataclasses
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro.serving import engine as je
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import cache as tc
from repro_torch.models import get_model
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as te
from torch_port_helpers import (
    EXACT,
    LOGIT_ATOL,
    assert_cache_equal,
    jit_exact,
    margin,
    spec_tuple,
)

torch.set_num_threads(2)

# hubert's final hidden states (bf16 after the final norm, magnitudes ~1-4)
# after two layers: a few bf16 ulps, the matmuls summed in another order
ENC_ATOL = 6e-2


def _params(name):
    cfg = j_get_arch(name, smoke=True)
    jparams = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch(name, smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def vlm():
    return _params("internvl2-2b")


def _lane_jit(self, fn, *, static=(), donate=()):
    return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                   compiler_options=EXACT)


def test_vlm_prefill_and_generate_match_reference(vlm):
    cfg, jparams, tcfg, tparams = vlm
    CAP = 256
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 112))
    patches = rng.normal(size=(2, cfg.n_patches, cfg.d_model))
    # the engines calibrate on 128 tokens and then 16 patches of one generator
    eng = te.Engine(tcfg, tparams, tc.PackKVConfig(),
                    te.EngineConfig(capacity=CAP, max_batch=2, calib_tokens=128,
                                    device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.Engine, "_lane_jit", _lane_jit)
        jeng = je.Engine(cfg, jparams, jc.PackKVConfig(),
                         je.EngineConfig(capacity=CAP, max_batch=2, calib_tokens=128,
                                         backend="xla", prefill_chunk_pages=0))
    for a, b in ((eng.pack_cfg.k_spec_static, jeng.pack_cfg.k_spec_static),
                 (eng.pack_cfg.v_spec_static, jeng.pack_cfg.v_spec_static)):
        assert spec_tuple(a) == spec_tuple(b)

    batch = {"tokens": toks, "patches": patches}
    jl, jcache = jeng.prefill({"tokens": jnp.asarray(toks, jnp.int32),
                               "patches": jnp.asarray(patches, jnp.float32)})
    tl, tcache = eng.prefill(batch)
    S = cfg.n_patches + toks.shape[1]
    assert int(tcache[0].n_comp[0]) + int(tcache[0].n_resid[0]) == S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
    # every layer's cache == the reference's prefill_cache of the port's K/V
    _, traw = get_model(tcfg).prefill(
        tparams, tcfg, tc.PackKVConfig(policy="none"), CAP,
        {"tokens": torch.from_numpy(toks), "patches": torch.from_numpy(patches).float()})
    pack = jeng.pack_cfg
    compress = jit_exact(jax.vmap(lambda k, v: jc.prefill_cache(
        jc.alloc_layer_cache(pack, 2, cfg.n_kv_heads, cfg.hd, CAP), k, v)))
    port_kv = [jnp.asarray(np.stack([getattr(r, a)[..., :S, :].to(torch.float32).numpy()
                                     for r in traw]), jnp.bfloat16)
               for a in ("raw_k", "raw_v")]
    want = jax.tree_util.tree_map(np.asarray, compress(*port_kv))
    fma = ((pack.k_quant().max_q + 1) // 2, (pack.v_quant().max_q + 1) // 2)
    for i, layer in enumerate(tcache):
        assert_cache_equal(layer, jax.tree_util.tree_map(lambda a: a[i], want), fma)

    # Engine.generate's loop, teacher-forced by the reference's tokens
    compared, margins = 0, [[], []]
    for step in range(9):
        want_l = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want_l, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        for b in range(2):
            margins[b].append(margin(want_l[b]))
            if margin(want_l[b]) >= LOGIT_ATOL:
                assert tl.numpy()[b].argmax() == want_l[b].argmax(), (b, step)
                compared += 1
        tok = want_l.argmax(-1).astype(np.int32)[:, None]
        if step < 8:
            jl, jcache = jeng.decode(jcache, jnp.asarray(tok))
            tl, tcache = eng.decode(tcache, tok)
    assert compared >= 10, compared
    # generate itself: tokens equal until the reference's first near-tie
    gen, _ = eng.generate(batch, 8)
    jgen, _ = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32),
                             "patches": jnp.asarray(patches, jnp.float32)}, 8)
    assert gen.shape == (2, 8)
    for b in range(2):
        n = next((i for i, m in enumerate(margins[b]) if m < LOGIT_ATOL), 8)
        np.testing.assert_array_equal(gen[b, :n], np.asarray(jgen)[b, :n])

    with pytest.raises(ValueError, match="tokens_patches"):
        te.SlotServer(eng)
    with pytest.raises(ValueError, match="tokens_patches"):
        je.SlotServer(jeng)


def test_encoder_encode_matches_reference():
    cfg, jparams, tcfg, tparams = _params("hubert-xlarge")
    assert "embed" not in tparams and not cfg.causal
    frames = np.random.default_rng(5).normal(size=(2, 96, cfg.d_model))
    want = jit_exact(partial(jtf.encode, cfg=cfg))(
        jparams, batch={"frames": jnp.asarray(frames, jnp.float32)})
    got = ttf.encode(tparams, tcfg, {"frames": torch.from_numpy(frames).float()})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 96, cfg.d_model)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=ENC_ATOL)
    # non-causal: the first frame's state depends on the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    other = ttf.encode(tparams, tcfg, {"frames": torch.from_numpy(moved).float()})
    assert not torch.equal(other[:, 0], got[:, 0])


def _ref_serve_message(monkeypatch, name) -> str:
    from repro.launch import serve as jserve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", name, "--smoke", "--requests",
                                      "1", "--max-new", "2", "--prompt-len", "64",
                                      "--capacity", "256", "--backend", "xla"])
    with pytest.raises(SystemExit) as e:
        jserve.main()
    return str(e.value)


@pytest.mark.parametrize("name", ["hubert-xlarge", "internvl2-2b"])
def test_serve_cli_refuses_like_reference(monkeypatch, name):
    from repro_torch.launch.serve import main

    want = _ref_serve_message(monkeypatch, name)
    with pytest.raises(SystemExit) as e:
        main(["--arch", name, "--smoke", "--device", "cpu", "--requests", "1",
              "--max-new", "2", "--prompt-len", "64", "--capacity", "256"])
    assert str(e.value) == want


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "internvl2-2b", "hubert-xlarge"])
def test_params_from_numpy_new_families(name):
    cfg = j_get_arch(name, smoke=True)
    tcfg = get_arch(name, smoke=True)
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    tparams = params_from_numpy(jparams, tcfg, "cpu")
    own = get_model(tcfg).init(torch.Generator().manual_seed(0), tcfg)
    dtypes = {np.dtype("float32"): torch.float32, np.dtype(jnp.bfloat16): torch.bfloat16}

    def walk(j, t, o, path=""):
        assert j.keys() == t.keys() == o.keys(), path
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k], o[k], f"{path}{k}.")
                continue
            assert tuple(t[k].shape) == j[k].shape == tuple(o[k].shape), path + k
            assert t[k].dtype == dtypes[j[k].dtype] == o[k].dtype, path + k

    walk(jparams, tparams, own)
    if cfg.family == "moe":
        mlp = tparams["layers"]["mlp"]
        assert mlp["router"].dtype == torch.float32
        assert mlp["w_gate"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                       cfg.d_ff_expert)
        assert mlp["shared"]["w_down"].shape == (
            cfg.n_layers, cfg.n_shared_experts * cfg.d_ff_expert, cfg.d_model)
    assert ("embed" in tparams) == (cfg.input_mode != "frames")
    with pytest.raises(ValueError):  # a tree of another family
        params_from_numpy(jparams, dataclasses.replace(
            tcfg, family="dense" if cfg.family == "moe" else "moe"), "cpu")
