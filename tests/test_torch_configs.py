"""The torch port's other dense configs (smollm-135m, minicpm-2b,
minitron-4b, qwen3-32b) against the JAX reference: qk-norm, GQA at G = 3,
a head dim decoupled from d_model, an odd vocabulary.

For each smoke config, with the reference's weights carried across by
``convert.params_from_numpy`` and the reference compiled without excess
precision (``torch_port_helpers.EXACT``):

  * the calibrated ``TierSpec``s equal the reference's (each package
    calibrates on its own prefill of the engine's 192 calibration tokens);
  * every layer's cache after the port's prefill is byte-exact with the
    reference's ``prefill_cache`` of the same K/V (the zero-points under
    the FMA rule): the K/V are the port's, read back from a policy-'none'
    prefill, because a model's K/V past layer 0 carry the bf16 rounding of
    another summation order;
  * prefill and 8 decode steps, both following the reference's greedy
    token: logits within LOGIT_ATOL of the reference's, the argmax equal at
    every step whose top-2 margin is at least LOGIT_ATOL (the margin rule);
  * the same run through paged storage: at pages of 64 within LOGIT_ATOL
    of the reference (the plain K5 tiles at the page there, the plain K2
    at 256 tokens; on the card both kernels sum in an order of token
    indices alone and are bitwise equal at every page size,
    tests/test_torch_gpu.py), at pages of 256 bitwise equal to the dense
    port.

Mirrors the reference's ``tests/test_models_smoke.py`` (every config's
prefill and decode run) at the port's serving width."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.core.tiered import choose_tier_spec, required_channel_widths
from repro.models import get_model as j_get_model
from repro.models import layers as jl
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core import cache as tc
from repro_torch.models import get_model
from repro_torch.models import layers as tl
from repro_torch.serving import Engine, EngineConfig
from torch_port_helpers import (
    LOGIT_ATOL,
    assert_cache_equal,
    jit_exact,
    margin,
    spec_tuple,
)

torch.set_num_threads(2)

NEW = ("smollm-135m", "minicpm-2b", "minitron-4b", "qwen3-32b")
CAP, CALIB = 256, 192


def test_configs_registered_like_the_reference():
    """Every port config equals the reference's field by field; the
    analytic parameter count too."""
    assert set(ARCHS) == set(SMOKES) == set(NEW) | {
        "llama2-7b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "internvl2-2b",
        "hubert-xlarge", "rwkv6-1.6b", "recurrentgemma-9b"}
    for name in ARCHS:
        for smoke in (False, True):
            a, b = get_arch(name, smoke), j_get_arch(name, smoke)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert a.param_count() == b.param_count() and a.hd == b.hd, name
            assert a.active_param_count() == b.active_param_count(), name
            assert a.has_decode == b.has_decode, name
    assert get_arch("smollm-135m").hd == get_arch("minicpm-2b").hd == 64
    assert get_arch("qwen3-32b").n_heads // get_arch("qwen3-32b").n_kv_heads == 8


def test_qkv_proj_qk_norm_matches_reference():
    """qk-norm: q and k rms-normalized over the head dim after the
    projection, before RoPE, in bf16 within the layer test's 1e-2."""
    rng = np.random.default_rng(4)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    D, H, Hkv, hd = 96, 3, 1, 32
    p = {"wq": bf(rng.normal(size=(D, H * hd)) / 10),
         "wk": bf(rng.normal(size=(D, Hkv * hd)) / 10),
         "wv": bf(rng.normal(size=(D, Hkv * hd)) / 10),
         "q_norm": bf(1 + 0.1 * rng.normal(size=(hd,))),
         "k_norm": bf(1 + 0.1 * rng.normal(size=(hd,)))}
    x = bf(rng.normal(size=(2, 7, D)))
    pos = np.arange(7)
    want = jl.qkv_proj({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                       H, Hkv, hd, jnp.asarray(pos), 1e6, qk_norm=True)
    got = tl.qkv_proj({k: tensor_from_numpy(v, "cpu") for k, v in p.items()},
                      tensor_from_numpy(x, "cpu"), H, Hkv, hd,
                      torch.from_numpy(pos), 1e6, qk_norm=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w, np.float32), rtol=1e-2, atol=1e-2)
    plain = tl.qkv_proj({k: tensor_from_numpy(v, "cpu") for k, v in p.items()},
                        tensor_from_numpy(x, "cpu"), H, Hkv, hd,
                        torch.from_numpy(pos), 1e6)
    assert not torch.equal(plain[0], got[0])  # the norm is applied


@partial(jax.jit, static_argnums=2)
def _calib_widths(k, v, cfg):
    """The array half of the reference's ``calibrate_specs`` (compiled):
    per-channel widths after token repacking. k, v: [L, B, H, n, D]."""
    k, v = (x.reshape(-1, *x.shape[-3:]) for x in (k, v))
    qk, _, _ = jc._quant_tokenwise(k, cfg.k_quant())
    qv, _, _ = jc._quant_tokenwise(v, cfg.v_quant())
    qk, qv, _ = jc._repack_tokens(qk, qv, cfg)
    return tuple(required_channel_widths(jnp.swapaxes(x, -1, -2), cfg.pack_size)
                 for x in (qk, qv))


def _ref_calibrate_specs(k, v):
    """The reference's ``calibrate_specs`` (its host half, ``choose_tier_spec``,
    on the compiled widths)."""
    cfg = jc.PackKVConfig()
    wk, wv = _calib_widths(k, v, cfg)
    return dataclasses.replace(
        cfg, k_spec_static=choose_tier_spec(wk, pack_size=cfg.pack_size),
        v_spec_static=choose_tier_spec(wv, pack_size=cfg.pack_size))


@pytest.mark.parametrize("name", NEW)
def test_smoke_config_matches_reference(name):
    cfg = j_get_arch(name, smoke=True)
    tcfg = get_arch(name, smoke=True)
    # compiled: the reference's init op by op takes seconds
    jparams = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    # the port's init makes the same tree (qk-norm leaves included)
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                        for k, v in t.items()}
    assert shapes(get_model(tcfg).init(torch.Generator().manual_seed(0), tcfg)) \
        == shapes(tparams)
    assert ("q_norm" in tparams["layers"]["attn"]) == cfg.qk_norm

    # the prompt is the engines' calibration prompt: the reference's
    # policy-'none' prefill gives its calibration K/V and its logits (the
    # forward pass does not depend on the policy), and its decode cache is
    # its ``prefill_cache`` of those K/V (as its packkv prefill builds it)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, CALIB))
    jl_, jraw = jit_exact(partial(j_get_model(cfg).prefill, cfg=cfg,
                                  pack_cfg=jc.PackKVConfig(policy="none"),
                                  capacity=CALIB))(jparams, batch={
                                      "tokens": jnp.asarray(toks, jnp.int32)})
    jpack = _ref_calibrate_specs(jraw.raw_k, jraw.raw_v)
    eng = Engine(tcfg, tparams, tc.PackKVConfig(),
                 EngineConfig(capacity=CAP, max_batch=1, calib_tokens=CALIB,
                              device="cpu"))
    for a, b in ((eng.pack_cfg.k_spec_static, jpack.k_spec_static),
                 (eng.pack_cfg.v_spec_static, jpack.v_spec_static)):
        assert spec_tuple(a) == spec_tuple(b)

    # every layer's cache after the port's prefill == the reference's
    # prefill_cache of the port's K/V (read back from a policy-'none' prefill)
    tl_, tcache = eng.prefill({"tokens": toks})
    _, traw = get_model(tcfg).prefill(tparams, tcfg, tc.PackKVConfig(policy="none"),
                                      CALIB, {"tokens": torch.from_numpy(toks)})
    assert all((int(r.n_comp[0]), int(r.n_resid[0])) == (CALIB, 0) for r in traw)
    compress = jit_exact(jax.vmap(lambda k, v: jc.prefill_cache(
        jc.alloc_layer_cache(jpack, 1, cfg.n_kv_heads, cfg.hd, CAP), k, v)))
    port_kv = [jnp.asarray(np.stack([getattr(r, a).to(torch.float32).numpy() for r in traw]),
                           jnp.bfloat16) for a in ("raw_k", "raw_v")]
    want = jax.tree_util.tree_map(np.asarray, compress(*port_kv))
    fma = ((jpack.k_quant().max_q + 1) // 2, (jpack.v_quant().max_q + 1) // 2)
    for i, layer in enumerate(tcache):
        assert_cache_equal(layer, jax.tree_util.tree_map(lambda a: a[i], want), fma)
    jcache = compress(jraw.raw_k, jraw.raw_v)

    # prefill + 8 decode steps against the reference, dense and paged
    jdecode = jit_exact(partial(j_get_model(cfg).decode_step, cfg=cfg, backend="xla"))
    runs = {"dense": [eng, tl_, tcache]}
    for page in (64, 256):
        paged = Engine(tcfg, tparams, eng.pack_cfg,
                       EngineConfig(capacity=CAP, max_batch=1, calibrate=False,
                                    paged=True, page_size=page, device="cpu"))
        runs[page] = [paged, *paged.prefill({"tokens": toks})]
    compared = 0
    for step in range(9):
        want = np.asarray(jl_)[0]
        for run, (_, logits, _) in runs.items():
            np.testing.assert_allclose(logits.numpy()[0], want, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"{name} {run} step {step}")
        # pages of 256: the plain K5 tiles as the plain K2 (256 tokens)
        assert torch.equal(runs[256][1], runs["dense"][1]), f"{name} step {step}"
        # teacher-forced, so a near-tie (the rounding may break it either
        # way) leaves the later steps comparable
        if margin(want) >= LOGIT_ATOL:
            for run, (_, logits, _) in runs.items():
                assert logits.numpy()[0].argmax() == want.argmax(), (name, run, step)
            compared += 1
        tok = np.asarray([[want.argmax()]], np.int32)
        if step < 8:
            jl_, jcache = jdecode(jparams, cache=jcache, token=jnp.asarray(tok))
            for run in runs.values():
                run[1], run[2] = run[0].decode(run[2], tok)
    assert compared >= 4, (name, compared)
    assert all(int(runs[p][2][0].n_comp[0]) == CALIB and runs[p][2][0].pages is not None
               for p in (64, 256))
