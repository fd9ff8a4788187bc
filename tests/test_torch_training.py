"""Training in the torch port against the reference (repro), on the CPU:
the dense training forward, the loss and its gradients, AdamW on the same
gradients, the three schedules, whole train steps at grad_accum 1 and 2,
and the port's loss decreasing.

Tolerances (stated per check):
  * logits within LOGIT_ATOL (bf16 products summed in another order); the
    loss within 1e-3;
  * gradients of the bf16 parameters: each leaf within 2e-2 of its max
    abs, the norm gains within 4e-2 (their gradient sums bf16 products over
    every position, and the reference's own two compilations, excess
    precision allowed or not, differ there by up to 5e-2 of the max);
  * gradients with the parameters in f32, where bf16 rounding is out of
    the way: each leaf within 1e-4 of its max abs (the graph itself);
  * AdamW: bf16 parameters bitwise; the moments within the dropped
    rounding of one fused multiply-add (the compiled reference contracts
    ``b * m + (1 - b) * g``), under the clip. Over the clip the global
    norm's sum order (XLA's reduction against PyTorch's) moves the norm by
    a few f32 ulps, and with it the clip factor: there the norm is held
    within 1e-6 and the parameters within one bf16 ulp;
  * the schedules within one f32 ulp of the peak lr at every step (XLA
    divides by a constant step count as a multiply by its reciprocal, and
    its cos differs from PyTorch's by an ulp, which ``1 + cos`` near the
    cosine's end magnifies at the tail's own scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES
from repro.data import ShardedTokenStream as RefStream
from repro.models import get_model as ref_model
from repro.training import optimizer as ro
from repro.training.train import make_train_step as ref_train_step
from repro_torch.configs import SMOKES as PORT_SMOKES
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data import ShardedTokenStream
from repro_torch.models import get_model
from repro_torch.training import optimizer as po
from repro_torch.training import make_train_step
from torch_port_helpers import jit_exact
from torch_train_helpers import (
    check_train_forward,
    port_arrays,
    ref_arrays,
    ref_loss_grads,
    train_batch,
)
from torch_threads import one_torch_thread  # noqa: F401

DENSE = ["llama2-7b", "minicpm-2b"]


@pytest.mark.parametrize("name", DENSE)
def test_forward_train_loss_and_grads(name, rng):
    check_train_forward(name, rng)


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------


def fma_close(got, want, prods) -> None:
    """|got - want| within half an ulp of the larger product (the rounding
    a fused multiply-add drops) plus half an ulp of each result."""
    big = np.maximum(np.abs(prods[0]), np.abs(prods[1]))
    bound = 0.5 * (np.spacing(big) + np.spacing(np.abs(got)) + np.spacing(np.abs(want)))
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want) - bound)


@pytest.mark.parametrize("scale,clipped", [(0.05, False), (1.0, True)])
def test_adamw_same_grads(scale, clipped, rng):
    """Three AdamW steps, each from the reference's own state and fed the
    reference's gradients of llama2-7b's smoke model (scaled by 0.05: norm
    0.58, under the clip; as they are: norm 11.5, over it)."""
    name = "llama2-7b"
    cfg, pcfg = SMOKES[name], PORT_SMOKES[name]
    batch = train_batch(cfg, rng, S=64)
    _, _, _, grads, params = ref_loss_grads(name, batch)
    grads = jax.tree_util.tree_map(
        lambda g: (g.astype(jnp.float32) * scale).astype(g.dtype), grads)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    upd = jit_exact(lambda g, s, p: ro.adamw_update(g, s, p, ro.OptConfig(**oc)))
    state = ro.init_opt_state(params)
    port_grads = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads), pcfg, "cpu")
    b1, b2 = ro.OptConfig().betas
    g32 = {k: np.asarray(v, np.float32) for k, v in ref_arrays(grads).items()}
    nn = lambda t: jax.tree_util.tree_map(np.asarray, t)
    for _ in range(3):
        p_params = params_from_numpy(nn(params), pcfg, "cpu")
        p_state = opt_state_from_numpy(nn(state.mu), nn(state.nu), np.asarray(state.step),
                                       pcfg, "cpu")
        m0, v0 = ref_arrays(state.mu), ref_arrays(state.nu)
        params, state, gnorm = upd(grads, state, params)
        p_params, p_state, p_gnorm = po.adamw_update(port_grads, p_state, p_params,
                                                     po.OptConfig(**oc))
        assert (float(gnorm) > 1.0) == clipped
        assert abs(float(p_gnorm) - float(gnorm)) <= 1e-6 * float(gnorm)
        assert int(p_state.step) == int(state.step)
        got, want = port_arrays(p_params), ref_arrays(params)
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            if clipped:  # within one bf16 ulp
                ulp = np.spacing(np.abs(w.astype(np.float32))) * 2 ** 16
                assert np.all(np.abs(got[k].astype(np.float32) - w.astype(np.float32))
                              <= ulp), k
            else:
                np.testing.assert_array_equal(got[k].view(np.uint16), w.view(np.uint16),
                                              err_msg=k)
        if clipped:
            continue
        got, want = port_arrays(p_state.mu), ref_arrays(state.mu)
        for k, w in want.items():  # b1 m + (1 - b1) g
            fma_close(got[k], w, (np.float32(b1) * m0[k], np.float32(1 - b1) * g32[k]))
        got, want = port_arrays(p_state.nu), ref_arrays(state.nu)
        for k, w in want.items():  # b2 v + ((1 - b2) g) g
            fma_close(got[k], w, (np.float32(b2) * v0[k],
                                  np.float32(1 - b2) * g32[k] * g32[k]))


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (3, 37), (1, 6)])
def test_schedules_every_step(schedule, warmup, total):
    kw = dict(lr=1e-3, schedule=schedule, warmup_steps=warmup, total_steps=total)
    ref = jit_exact(ro.make_schedule(ro.OptConfig(**kw)))
    port = po.make_schedule(po.OptConfig(**kw))
    ulp = np.spacing(np.float32(1e-3))
    for s in range(total + 1):
        want = np.float32(ref(jnp.int32(s)))
        got = port(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= ulp, (s, float(got), float(want))


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum, rng):
    """One make_train_step from the same llama2-7b smoke parameters: the
    loss within 1e-3, the grad norm within 2e-2, the step equal, and every
    parameter within 5e-3 (the reference's own grad-accum bound: Adam's
    first step moves a parameter by ~lr whatever its gradient's size, so a
    near-zero gradient of another sign moves it 2 lr the other way)."""
    name = "llama2-7b"
    cfg, pcfg = SMOKES[name], PORT_SMOKES[name]
    rapi = ref_model(cfg)
    params = rapi.init(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)}
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    p_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg, "cpu")
    step = jit_exact(ref_train_step(rapi, cfg, ro.OptConfig(**oc), grad_accum=accum))
    params, _, m = step(params, ro.init_opt_state(params),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    p_step = make_train_step(get_model(pcfg), pcfg, po.OptConfig(**oc), grad_accum=accum)
    p_params, _, pm = p_step(p_params, po.init_opt_state(p_params),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(pm["loss"]) - float(m["loss"])) < 1e-3
    assert abs(float(pm["grad_norm"]) / float(m["grad_norm"]) - 1) < 2e-2
    assert int(pm["step"]) == int(m["step"]) == 1
    got, want = port_arrays(p_params), ref_arrays(params)
    for k, w in want.items():
        assert got[k].dtype == w.dtype
        assert np.abs(got[k].astype(np.float32) - w.astype(np.float32)).max() < 5e-3, k


def _accum_gaps(a, b) -> tuple[float, float]:
    """(|grad norm gap| / a's norm, the largest first-moment gap of a leaf
    over that leaf's max abs) between two one-step train results."""
    from repro_torch.utils import tree_flatten

    (_, oa, ma), (_, ob, mb) = a, b
    g = float(ma["grad_norm"])
    mu = max(float((x - y).abs().max() / x.abs().max())
             for x, y in zip(tree_flatten(oa.mu)[0], tree_flatten(ob.mu)[0]))
    return abs(g - float(mb["grad_norm"])) / g, mu


def test_grad_accum_holds_gradients():
    """The port's one step at grad_accum 1 against one at 2 from the same
    smollm-135m smoke parameters, by the gradients (the check the card's
    full-width step takes): the grad norm within 1e-2 relative and each
    first moment within 0.1 of its leaf's max abs. Here they differ by
    about 1e-3 and 2e-2 (bf16 gradients of 4 rows against two blocks of
    2, the tied embedding's most), while a dropped microbatch (the first
    block's step alone) is out of both bars."""
    from repro_torch.utils import tree_map

    cfg = PORT_SMOKES["smollm-135m"]
    api = get_model(cfg)
    p0 = api.init(torch.Generator().manual_seed(0), cfg)
    o0 = po.init_opt_state(p0)
    batch = {k: torch.from_numpy(v) for k, v in ShardedTokenStream(
        vocab=cfg.vocab, batch_per_host=4, seq=64).next_batch().items()}
    oc = po.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def run(accum, b):
        p, o = tree_map(torch.clone, p0), tree_map(torch.clone, o0)
        return make_train_step(api, cfg, oc, grad_accum=accum)(p, o, b)

    one = run(1, batch)
    norm_gap, mu_gap = _accum_gaps(one, run(2, batch))
    assert norm_gap <= 1e-2 and mu_gap <= 0.1, (norm_gap, mu_gap)
    norm_gap, mu_gap = _accum_gaps(one, run(1, {k: v[:2] for k, v in batch.items()}))
    assert norm_gap > 1e-2 and mu_gap > 0.1, (norm_gap, mu_gap)


def test_split_micro_is_row_blocks():
    from repro_torch.training.train import _split_micro

    x = torch.arange(24).reshape(6, 4)
    got = _split_micro({"x": x}, 3)["x"]
    assert torch.equal(got[1], x[2:4])
    with pytest.raises(ValueError):
        _split_micro({"x": x}, 4)


def test_loss_decreases():
    """tests/test_training.py::test_loss_decreases on the port."""
    cfg = PORT_SMOKES["smollm-135m"]
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, cfg)
    opt = po.init_opt_state(params)
    step = make_train_step(api, cfg, po.OptConfig(lr=1e-3, warmup_steps=2, total_steps=30))
    stream = ShardedTokenStream(vocab=cfg.vocab, batch_per_host=8, seq=64)
    ref_stream = RefStream(vocab=cfg.vocab, batch_per_host=8, seq=64)
    losses = []
    for _ in range(15):
        b = stream.next_batch()
        rb = ref_stream.next_batch()
        assert all(np.array_equal(b[k], rb[k]) for k in rb)
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert int(opt.step) == 15
    assert losses[-1] < losses[0] - 0.3, losses
    assert all(np.isfinite(losses))
