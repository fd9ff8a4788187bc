"""The torch port's recurrent families (rwkv6-1.6b and recurrentgemma-9b
smoke configs) against the JAX reference, with the reference's weights
carried across by ``convert.params_from_numpy`` and the reference compiled
without excess precision (``torch_port_helpers.EXACT``).

  * ``_wkv_chunked`` on the same f32 inputs as the reference's, within
    WKV_TOL (the reference's own bound of chunked against sequential), and
    the strong-decay clamp case of ``tests/test_rwkv_chunked.py`` finite
    and within WKV_TOL too; the port's chunked form against its own
    sequential scan within WKV_TOL.
  * ``append_token(ring=True)``: a window cache prefilled to the window and
    appended past it (the ring overwrites its oldest blocks twice): the
    payload words, mins, shifts, scale, zero and counters byte-exact with
    the reference's (zero-points under the FMA rule), policies packkv and
    'none'; paged storage refuses the ring.
  * rwkv6 and rglru through ``Engine``: prefill logits within LOGIT_ATOL,
    then 70 decode steps teacher-forced by the reference's greedy tokens
    (rglru: residual 64 and window 128, so every attention layer's ring
    wraps), logits within LOGIT_ATOL and tokens equal wherever the
    reference's top-2 margin is at least LOGIT_ATOL; rglru's calibrated
    specs and, after the wrap, its window caches' integer leaves against
    the reference's; ``Engine.generate``'s greedy tokens equal the
    reference's up to the first near-tie.
  * ``params_from_numpy``: the same keys, shapes and dtypes as the
    reference's tree and as the port's own init."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.models import get_model as j_get_model
from repro.models import rwkv6 as jrw
from repro.serving import engine as je
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import cache as tc
from repro_torch.models import get_model
from repro_torch.models import rwkv6 as trw
from repro_torch.serving import engine as te
from torch_port_helpers import (
    EXACT,
    LOGIT_ATOL,
    assert_cache_equal,
    jit_exact,
    margin,
    ref_cache_to_torch,
    spec_tuple,
)

torch.set_num_threads(2)

# the reference's bound of its chunked WKV against the sequential scan
# (tests/test_rwkv_chunked.py); the port is held no looser
WKV_TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ("rwkv6-1.6b", "recurrentgemma-9b")


def _params(name):
    cfg = j_get_arch(name, smoke=True)
    jparams = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch(name, smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _params(request.param)


def _lane_jit(self, fn, *, static=(), donate=()):
    return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                   compiler_options=EXACT)


# ---------------------------------------------------------------------------
# the chunked WKV
# ---------------------------------------------------------------------------


def _wkv_inputs(rng, B, T, H, N, w):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(B, T, H, N), f(B, T, H, N), f(B, T, H, N), w,
            f(H, N) * np.float32(0.1), f(B, H, N, N) * np.float32(0.1))


@pytest.mark.parametrize("strong", [False, True])
def test_wkv_chunked_matches_reference(rng, strong):
    B, T, H, N = 2, 4 * trw.CHUNK_C, 3, 16
    w = (np.full((B, T, H, N), 1e-6, np.float32) if strong  # below the clamp
         else rng.uniform(0.2, 0.999, size=(B, T, H, N)).astype(np.float32))
    args = _wkv_inputs(rng, B, T, H, N, w)
    y_j, S_j = jax.jit(jrw._wkv_chunked, compiler_options=EXACT)(*map(jnp.asarray, args))
    y_t, S_t = trw._wkv_chunked(*map(torch.from_numpy, args))
    assert torch.isfinite(y_t).all() and torch.isfinite(S_t).all()
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **WKV_TOL)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), **WKV_TOL)
    if not strong:  # the chunked form against the port's own sequential scan
        y_s, S_s = trw._wkv_seq(*map(torch.from_numpy, args))
        np.testing.assert_allclose(y_t.numpy(), y_s.numpy(), **WKV_TOL)
        np.testing.assert_allclose(S_t.numpy(), S_s.numpy(), **WKV_TOL)


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------


def _bf16(x):
    import ml_dtypes

    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)


@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_ring_append_byte_exact_after_wrap(rng, policy):
    """Rows prefilled with 128, 100 and 0 tokens into a 128-token window,
    then 200 ring appends: every row's ring overwrites its oldest blocks;
    after every 50 appends the whole cache equals the reference's."""
    B, H, D, W, R = 3, 1, 32, 128, 64
    jcfg = jc.PackKVConfig(policy=policy, residual=R)
    fma = (0, 0)
    if policy == "packkv":
        kv = _bf16(rng.normal(size=(1, H, W, D)))
        jcfg = jc.calibrate_specs(jnp.asarray(kv), jnp.asarray(-kv), jcfg)
        fma = ((jcfg.k_quant().max_q + 1) // 2, (jcfg.v_quant().max_q + 1) // 2)
    jcache = jc.alloc_layer_cache(jcfg, B, H, D, W)
    tcache = ref_cache_to_torch(jcache, tc.PackKVConfig(policy=policy, residual=R))
    insert = jit_exact(jc.insert_prefill)
    for row, n in enumerate((128, 100, 0)):
        if n:
            k, v = _bf16(rng.normal(size=(H, n, D))), _bf16(rng.normal(size=(H, n, D)))
            jcache = insert(jcache, row, jnp.asarray(k), jnp.asarray(v))
            tc.insert_prefill(tcache, row, _torch_bf16(k), _torch_bf16(v))
    append = jit_exact(jc.append_token, static_argnames=("ring",))
    for step in range(200):
        s = _bf16(rng.normal(size=(B, H, 1, D)))
        jcache = append(jcache, jnp.asarray(s), jnp.asarray(-s), ring=True)
        tc.append_token(tcache, _torch_bf16(s), -_torch_bf16(s), ring=True)
        if step % 50 == 49:
            assert_cache_equal(tcache, jcache, fma if policy == "packkv" else None)
    # rows 0 and 1 overwrote 3 and 2 of their oldest blocks, row 2 one
    assert tcache.n_comp.tolist() == [W + 192, W + 128, W + 64]
    paged = tc.alloc_layer_cache(tc.PackKVConfig(policy="none", residual=R, paged=True,
                                                 page_size=64), B, H, D, W, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tc.append_token(paged, _torch_bf16(s), _torch_bf16(s), ring=True)


# ---------------------------------------------------------------------------
# the models through Engine
# ---------------------------------------------------------------------------


def _engines(family, residual=64):
    cfg, jparams, tcfg, tparams = family
    cap = cfg.window or 256
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.Engine, "_lane_jit", _lane_jit)
        jeng = je.Engine(cfg, jparams, jc.PackKVConfig(residual=residual),
                         je.EngineConfig(capacity=cap, max_batch=2, backend="xla",
                                         prefill_chunk_pages=0))
    eng = te.Engine(tcfg, tparams, tc.PackKVConfig(residual=residual),
                    te.EngineConfig(capacity=cap, max_batch=2, device="cpu"))
    return jeng, eng


def test_prefill_decode_and_generate_match_reference(family):
    cfg = family[0]
    jeng, eng = _engines(family)
    if cfg.family == "rwkv6":  # no KV cache: nothing calibrated
        assert eng.pack_cfg.k_spec_static is None is jeng.pack_cfg.k_spec_static
    else:
        for a, b in ((eng.pack_cfg.k_spec_static, jeng.pack_cfg.k_spec_static),
                     (eng.pack_cfg.v_spec_static, jeng.pack_cfg.v_spec_static)):
            assert spec_tuple(a) == spec_tuple(b)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 150))
    jl, jcache = jeng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tcache = eng.prefill({"tokens": toks})
    compared, margins = 0, []
    n_steps = 70
    for step in range(n_steps + 1):
        want = np.asarray(jl)[0]
        np.testing.assert_allclose(tl.numpy()[0], want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        margins.append(margin(want))
        if margins[-1] >= LOGIT_ATOL:
            assert tl.numpy()[0].argmax() == want.argmax(), step
            compared += 1
        if step < n_steps:
            tok = np.asarray([[want.argmax()]], np.int32)
            jl, jcache = jeng.decode(jcache, jnp.asarray(tok))
            tl, tcache = eng.decode(tcache, tok)
    assert compared >= 50, compared
    assert int(tcache.pos[0]) == int(np.asarray(jcache.pos)[0]) == 150 + n_steps
    if cfg.family == "hybrid_rglru":
        # every ring wrapped: 128 prefilled, 64 + 1 steps to the first flush
        layer = tcache.cache[0]
        assert int(layer.n_comp[0]) == 192 and int(layer.n_resid[0]) == 70 - 65 + 1
        jlayer = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), jcache.cache)
        for name in ("n_comp", "n_resid"):
            np.testing.assert_array_equal(getattr(layer, name).numpy(), getattr(jlayer, name))
        for got, want in ((layer.k, jlayer.k), (layer.v, jlayer.v)):
            np.testing.assert_array_equal(got.chan_perm.numpy(), want.chan_perm)
            # the wrapped block came from the two packages' own K/V, which
            # differ by bf16 rounding: its words are compared as a share
            same = [np.mean(t.payload.numpy().view(np.uint32) == w.payload)
                    for t, w in zip(got.tiers, want.tiers)]
            assert min(same) > 0.5, same
    # generate: tokens equal until the reference's first near-tie
    gen, _ = eng.generate({"tokens": toks}, 12)
    jgen, _ = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 12)
    n = next((i for i, m in enumerate(margins[:12]) if m < LOGIT_ATOL), 12)
    assert n >= 1, margins[:12]
    np.testing.assert_array_equal(gen[0, :n], np.asarray(jgen)[0, :n])


def test_params_from_numpy_recurrent_families(family):
    cfg, jparams, tcfg, tparams = family
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    own = get_model(tcfg).init(torch.Generator().manual_seed(0), tcfg)
    dtypes = {np.dtype("float32"): torch.float32, np.dtype(jnp.bfloat16): torch.bfloat16}

    def walk(j, t, o, path=""):
        assert j.keys() == t.keys() == o.keys(), path
        for k in j:
            if j[k] is None:
                assert t[k] is None and o[k] is None, path + k
            elif isinstance(j[k], dict):
                walk(j[k], t[k], o[k], f"{path}{k}.")
            else:
                assert tuple(t[k].shape) == j[k].shape == tuple(o[k].shape), path + k
                assert t[k].dtype == dtypes[j[k].dtype] == o[k].dtype, path + k
                np.testing.assert_array_equal(
                    t[k].to(torch.float32).numpy(), np.asarray(j[k], np.float32))

    walk(jtree, tparams, own)
    if cfg.family == "rwkv6":
        assert tparams["layers"]["wA"].dtype == tparams["layers"]["u"].dtype == torch.float32
    else:
        rec = tparams["groups"]["rec"]
        assert rec["lru_wa"].dtype == torch.float32
        assert tuple(rec["w_in"].shape) == (cfg.n_layers // 3, 2, cfg.d_model, cfg.lru_dim)
        assert tparams["tail"]["ln"].shape[0] == cfg.n_layers % 3
    with pytest.raises(ValueError):  # the other family's config
        other = "hybrid_rglru" if cfg.family == "rwkv6" else "rwkv6"
        params_from_numpy(jtree, dataclasses.replace(tcfg, family=other), "cpu")
