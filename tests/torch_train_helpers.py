"""Shared helpers of the training tests (tests/test_torch_train*.py): the
reference's and the port's loss and gradients on the same numpy inputs,
and the per-leaf gradient check. The tolerances are stated in
tests/test_torch_training.py."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import SMOKES
from repro.models import get_model as ref_model
from repro_torch.configs import SMOKES as PORT_SMOKES
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import get_model
from repro_torch.training.train import _value_and_grad
from repro_torch.utils import tree_flatten
from torch_port_helpers import LOGIT_ATOL, _flat, jit_exact

NORM_GAINS = ("ln1", "ln2", "final_ln", "ln", "mlp_ln", "ln_x")


def ref_arrays(tree) -> dict:
    return dict(_flat(jax.tree_util.tree_map(np.asarray, tree)))


def port_arrays(tree) -> dict:
    return dict(_flat(params_to_numpy(tree)))


def train_batch(cfg, rng, B=2, S=128) -> dict:
    """numpy inputs as tests/test_models_smoke.py makes them."""
    batch = {}
    if cfg.input_mode == "tokens":
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        n_lab = S
    elif cfg.input_mode == "frames":
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        n_lab = S
    else:
        Tt = S - cfg.n_patches
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, Tt)).astype(np.int32)
        batch["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        n_lab = Tt
    batch["labels"] = rng.integers(0, cfg.vocab, (B, n_lab)).astype(np.int32)
    return batch


def ref_loss_grads(name, batch, f32=False):
    """The reference's (loss, logits, aux, grads, params) at its init."""
    cfg = SMOKES[name]
    api = ref_model(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg)
    if f32:
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)

    def loss(p, b):
        logits, aux = api.forward_train(p, cfg, b)
        return api.loss_fn(p, cfg, b), (logits, aux)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (l, (logits, aux)), g = jit_exact(jax.value_and_grad(loss, has_aux=True))(params, jb)
    return float(l), np.asarray(logits), float(aux), g, params


def port_loss_grads(name, params_np, batch):
    cfg = PORT_SMOKES[name]
    api = get_model(cfg)
    params = params_from_numpy(params_np, cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = api.forward_train(params, cfg, tb)
    leaves, treedef = tree_flatten(params)
    loss, grads = _value_and_grad(api, cfg, leaves, treedef, tb)
    return float(loss), logits.numpy(), float(aux), treedef.unflatten(grads)


def check_grads(got: dict, want: dict, rel: float, gains_rel: float) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, k
        tol = gains_rel if k.split(".")[-1] in NORM_GAINS else rel
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (k, err)


def check_train_forward(name: str, rng) -> None:
    """bf16: logits, loss, aux, per-leaf gradients; f32: per-leaf
    gradients (shared by the family tests)."""
    batch = train_batch(SMOKES[name], rng)
    loss, logits, aux, grads, params = ref_loss_grads(name, batch)
    p_loss, p_logits, p_aux, p_grads = port_loss_grads(
        name, jax.tree_util.tree_map(np.asarray, params), batch)
    assert p_logits.shape == logits.shape and p_logits.dtype == np.float32
    np.testing.assert_allclose(p_logits, logits, rtol=0, atol=LOGIT_ATOL)
    assert abs(p_loss - loss) < 1e-3, (p_loss, loss)
    assert abs(p_aux - aux) < 1e-4, (p_aux, aux)
    check_grads(port_arrays(p_grads), ref_arrays(grads), 2e-2, 4e-2)
    if SMOKES[name].input_mode == "frames":
        return  # the reference casts frames to bf16: it has no f32 forward
    loss, _, _, grads, params = ref_loss_grads(name, batch, f32=True)
    p_loss, _, _, p_grads = port_loss_grads(
        name, jax.tree_util.tree_map(np.asarray, params), batch)
    assert abs(p_loss - loss) < 1e-5, (p_loss, loss)
    check_grads(port_arrays(p_grads), ref_arrays(grads), 1e-4, 1e-4)
