"""The torch port's MoE MLP (qwen2-moe-a2.7b and moonshot-v1-16b-a3b smoke
configs) against the JAX reference, at the model level.

  * ``moe_apply`` against the reference's at T = 128 tokens, where the
    expert capacity binds (the test asserts dropped choices): a router
    whose first E rows are the identity and the rest zero gives both
    sides bit-identical f32 logits, so the integer routing (top-k
    indices, cumsum positions, keep mask, buffer slots) must be equal
    exactly; the output within MOE_ATOL and the aux loss within 1e-6.
  * Pad rows take no capacity: the port's MoE over real rows with zero
    rows interleaved (a decode step's padding) routes exactly as over the
    real rows alone (the same C, indices, slots and keep mask) and gives
    the same real rows bitwise; routing the pads too would change C.
  * Prefill and 8 teacher-forced decode steps at the engine's height
    (rows = spec_k + 1 = 5) against the reference's, B = 2: logits within
    LOGIT_ATOL, the greedy token under the margin rule; the decode calls
    route T = B tokens; paged storage (pages of 256) bitwise equal to
    dense.
  * A chunked admission whose final chunk is short (300 tokens in chunks
    of 128) against the reference's chunked admission: every chunk's
    logits within LOGIT_ATOL; the chunks route 128, 128 and 44 tokens.

Every comparison asserts that no routed token sat within GAP of its k-th /
(k+1)-th router-probability tie, so a failure is never a tie broken the
other way by rounding. The serving comparisons are in
``tests/test_torch_moe_{serving,spec,sched}.py``. The reference runs compiled without
excess precision (``torch_port_helpers.EXACT``)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.serving import engine as je
from repro.utils import round_up as j_round_up
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core import cache as tc
from repro_torch.models import moe as tmoe
from repro_torch.serving import engine as te
from torch_port_helpers import EXACT, LOGIT_ATOL, jit_exact, margin, spec_tuple

torch.set_num_threads(2)

MOE = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
GAP = 1e-6  # no routed token this close to a top-k tie
# the routed + shared output (bf16, magnitudes ~1): a few bf16 ulps, the
# expert GEMMs summed in another order
MOE_ATOL = 3e-2


@pytest.fixture(scope="module", params=MOE)
def smoke(request):
    cfg = j_get_arch(request.param, smoke=True)
    jparams = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch(request.param, smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _t(a):
    return tensor_from_numpy(a, "cpu")


def _layer0_mlp(jparams):
    return jax.tree_util.tree_map(lambda a: np.asarray(a[0]), jparams["layers"]["mlp"])


@partial(jax.jit, static_argnums=(1, 2))
def _ref_routing(logits, E, k):
    """The reference's routing decisions (``_dispatch_compute``'s lines,
    which the reference does not return)."""
    T = logits.shape[0]
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    C = j_round_up(max(int(T * k / E * 1.25), 8), 8)
    fid = idx.reshape(-1)
    onehot = jax.nn.one_hot(fid, E, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return idx, pos, pos < C, fid * C + jnp.minimum(pos, C - 1)


def _identity_router(D, E):
    r = np.zeros((D, E), np.float32)
    r[np.arange(E), np.arange(E)] = 1.0
    return r


def _skewed(rng, shape, E):
    """bf16 hidden states whose first E channels (the identity router's
    logits) favour the low experts, so their capacity binds: each token's
    E logits are 0.25 x the ranks of skewed normal scores, distinct, so no
    top-k choice is near a tie."""
    x = rng.normal(size=shape)
    score = rng.normal(size=(*shape[:-1], E)) + np.linspace(1.5, 0.0, E)
    x[..., :E] = 0.25 * np.argsort(np.argsort(score, axis=-1), axis=-1)
    return _bf16(x)


def test_moe_apply_matches_reference(smoke):
    cfg, _, tcfg, _ = smoke
    E, k, D = cfg.n_experts, cfg.moe_topk, cfg.d_model
    mlp = _layer0_mlp(jax.jit(j_get_model(cfg).init, static_argnums=1)(
        jax.random.PRNGKey(1), cfg))
    mlp["router"] = _identity_router(D, E)
    x = _skewed(np.random.default_rng(0), (2, 64, D), E)  # T = 128

    jout, jaux = jit_exact(lambda p, x: jmoe.moe_apply(p, x, cfg))(mlp, jnp.asarray(x))
    tp = _mlp_to_torch(mlp)
    with tmoe.routing_log(keep_tensors=True) as log:
        tout, taux = tmoe.moe_apply(tp, _t(x), tcfg)
    (call,) = log
    jlogits = np.asarray(jnp.dot(jnp.asarray(x).reshape(-1, D).astype(jnp.float32),
                                 jnp.asarray(mlp["router"])))
    np.testing.assert_array_equal(call.logits.numpy().view(np.uint32),
                                  jlogits.view(np.uint32))  # bit-identical logits
    idx, pos, keep, slot = map(np.asarray, _ref_routing(jnp.asarray(jlogits), E, k))
    r = call.routing
    assert call.T == 128 and r.C == j_round_up(max(int(128 * k / E * 1.25), 8), 8)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    assert int((~r.keep).sum()) > 0, "capacity never bound"
    assert int(call.dropped.sum()) == int((~r.keep).sum())
    assert float(call.min_gap) > GAP
    np.testing.assert_allclose(tout.to(torch.float32).numpy(),
                               np.asarray(jout, np.float32), rtol=0, atol=MOE_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def _mlp_to_torch(mlp):
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else _t(v) for k, v in t.items()}
    return walk(mlp)


def test_pad_rows_take_no_capacity(smoke):
    """16 decode rows padded to 5 positions each (zeros after the first):
    capacity binds at T = 16 (C = 8) and the pads change nothing."""
    cfg, jparams, tcfg, _ = smoke
    E, k, D = cfg.n_experts, cfg.moe_topk, cfg.d_model
    mlp = _layer0_mlp(jparams)
    mlp["router"] = _identity_router(D, E)
    tp = _mlp_to_torch(mlp)
    x = _skewed(np.random.default_rng(2), (16, 1, D), E)
    padded = torch.nn.functional.pad(_t(x), (0, 0, 0, 4))
    with tmoe.routing_log(keep_tensors=True) as log:
        real, _ = tmoe.moe_apply(tp, _t(x), tcfg)
        pad, _ = tmoe.moe_apply(tp, padded, tcfg, n_real=1)
    a, b = log
    assert a.T == b.T == 16 and a.C == b.C == 8
    for f in ("idx", "pos", "keep", "slot"):
        np.testing.assert_array_equal(getattr(a.routing, f).numpy(),
                                      getattr(b.routing, f).numpy(), err_msg=f)
    assert int((~a.routing.keep).sum()) > 0, "capacity never bound"
    assert torch.equal(pad[:, :1], real)
    jout, _ = jit_exact(lambda p, x: jmoe.moe_apply(p, x, cfg))(mlp, jnp.asarray(x))
    np.testing.assert_allclose(pad[:, :1].to(torch.float32).numpy(),
                               np.asarray(jout, np.float32), rtol=0, atol=MOE_ATOL)
    # routing the pads too would take capacity: another C, and the zero
    # rows' tied logits would claim the low experts' slots
    naive = tmoe.route(padded.reshape(-1, D).to(torch.float32) @ tp["router"], E, k)
    assert naive.C != b.C


def _ref_engine(cfg, jparams, port_engine, **kw):
    """The reference engine at the port engine's calibrated specs, every
    dispatch compiled by EXACT."""
    ts = port_engine.pack_cfg
    jspec = lambda s: jc.TierSpec(s.widths, s.counts, s.pack_size)
    jpack = jc.PackKVConfig(k_spec_static=jspec(ts.k_spec_static),
                            v_spec_static=jspec(ts.v_spec_static))

    def lane_jit(self, fn, *, static=(), donate=()):
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.Engine, "_lane_jit", lane_jit)
        return je.Engine(cfg, jparams, jpack, je.EngineConfig(
            backend="xla", calibrate=False, **kw))


def test_prefill_decode_at_window_height_matches_reference(smoke):
    """B = 2 prompts of 150: the reference's prefill and decode_step
    against the port engine's (decode GEMMs at rows = 5), dense and paged,
    teacher-forced by the reference's greedy tokens."""
    cfg, jparams, tcfg, tparams = smoke
    eng = te.Engine(tcfg, tparams, tc.PackKVConfig(),
                    te.EngineConfig(capacity=512, max_batch=2, device="cpu"))
    assert eng.rows == 5
    paged = te.Engine(tcfg, tparams, eng.pack_cfg,
                      te.EngineConfig(capacity=512, max_batch=2, device="cpu",
                                      calibrate=False, paged=True, page_size=256))
    jeng = _ref_engine(cfg, jparams, eng, capacity=512, max_batch=2,
                       prefill_chunk_pages=0)
    assert spec_tuple(jeng.pack_cfg.k_spec_static) == spec_tuple(eng.pack_cfg.k_spec_static)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 150))
    jl, jcache = jeng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    with tmoe.routing_log() as log:
        runs = [[e, *e.prefill({"tokens": toks})] for e in (eng, paged)]
        compared = 0
        for step in range(9):
            want = np.asarray(jl)
            for _, logits, _ in runs:
                np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=LOGIT_ATOL,
                                           err_msg=f"step {step}")
            assert torch.equal(runs[0][1], runs[1][1]), f"paged != dense at step {step}"
            for b in range(2):
                if margin(want[b]) >= LOGIT_ATOL:
                    assert runs[0][1].numpy()[b].argmax() == want[b].argmax(), (b, step)
                    compared += 1
            tok = want.argmax(-1).astype(np.int32)[:, None]
            if step < 8:
                jl, jcache = jeng.decode(jcache, jnp.asarray(tok))
                for run in runs:
                    run[1], run[2] = run[0].decode(run[2], tok)
    assert compared >= 10, compared
    sites = {(c.site, c.T, c.C) for c in log}
    assert sites == {("prefill", 300, tmoe.capacity(300, cfg.n_experts, cfg.moe_topk)),
                     ("decode", 2, 8)}, sites
    assert min(float(c.min_gap) for c in log) > GAP
    assert sum(int(c.dropped.sum()) for c in log if c.site == "decode") == 0


def test_short_final_chunk_matches_reference(smoke):
    """A 300-token prompt admitted in chunks of 128 (the last one 44 tokens,
    run padded to 128 rows in the port): every chunk's logits against the
    reference's chunked admission; each chunk routes its own tokens."""
    cfg, jparams, tcfg, tparams = smoke
    kw = dict(capacity=512, max_batch=1, page_size=128, prefill_chunk_pages=1)
    eng = te.Engine(tcfg, tparams, tc.PackKVConfig(), te.EngineConfig(device="cpu", **kw))
    jeng = _ref_engine(cfg, jparams, eng, **kw)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, 300)
    scratch, jscratch = eng.chunk_init(300), jeng.chunk_init(300)
    cache, jcache = eng.alloc_slot_cache(), jeng.alloc_slot_cache()
    with tmoe.routing_log() as log:
        for s0 in (0, 128, 256):
            part = prompt[s0:s0 + 128]
            if s0 < 256:
                tl, scratch = eng.chunk_step(scratch, part, s0)
                jl, jscratch = jeng.chunk_step(jscratch, part, s0)
            else:
                tl, cache = eng.chunk_final(cache, 0, scratch, part, s0)
                jl, jcache = jeng.chunk_final(jcache, 0, jscratch, part, s0)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=LOGIT_ATOL, err_msg=f"chunk at {s0}")
    assert [c.T for c in log] == [128] * cfg.n_layers * 2 + [44] * cfg.n_layers
    assert [c.C for c in log][-1] == tmoe.capacity(44, cfg.n_experts, cfg.moe_topk)
    assert min(float(c.min_gap) for c in log) > GAP
    if margin(np.asarray(jl)) >= LOGIT_ATOL:
        assert tl.numpy().argmax() == np.asarray(jl).argmax()
