"""The training forward, the loss and the gradients of every non-dense
family against the reference (repro), on the CPU, as
tests/test_models_smoke.py runs them (B = 2, S = 128; the VLM's patch
prefix with the loss on the text positions only, the encoder's frames),
with the tolerances of tests/test_torch_training.py; and the MoE's
dropped choices taking an exact zero gradient."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.models import moe
from torch_train_helpers import check_train_forward
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ["qwen2-moe-a2.7b", "rwkv6-1.6b", "recurrentgemma-9b", "internvl2-2b",
            "hubert-xlarge"]


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_train_loss_and_grads(name, rng):
    check_train_forward(name, rng)


def _moe_inputs(seed: int, T: int):
    cfg = SMOKES["qwen2-moe-a2.7b"]
    gen = torch.Generator().manual_seed(seed)
    p = {k: v[0] for k, v in moe.moe_init(gen, cfg, 1).items() if k != "shared"}
    x = (torch.randn((T, cfg.d_model), generator=gen) * 2).to(torch.bfloat16)
    # a skewed router: most tokens pick the same experts, so capacity binds
    logits = torch.randn((T, cfg.n_experts), generator=gen)
    logits[:, :2] += 4.0
    return cfg, p, x, logits


def test_moe_dropped_choices_take_zero_gradient():
    """With the capacity binding, the routed output's gradient reaches no
    dropped choice: a token whose every choice was dropped gets exactly
    zero gradient in its input and its router logits; its kept choices'
    gradients are those of the same token routed alone with its dropped
    choices' gates held fixed."""
    cfg, p, x, logits = _moe_inputs(0, 256)
    E, k = cfg.n_experts, cfg.moe_topk
    x = x.clone().requires_grad_()
    logits = logits.clone().requires_grad_()
    out, _, r = moe._dispatch_compute(x, logits, p["w_gate"], p["w_up"], p["w_down"],
                                      E, k, moe.CAPACITY_FACTOR)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(out.dtype)
    gx, gl = torch.autograd.grad((out * w).sum(), (x, logits))
    keep = r.keep.view(-1, k)
    all_dropped = ~keep.any(1)
    assert all_dropped.sum() > 0 and keep.any(1).sum() > 0
    assert torch.all(gx[all_dropped] == 0)
    assert torch.all(gl[all_dropped] == 0)
    assert torch.all(out[all_dropped] == 0)
    assert gx[~all_dropped].abs().sum() > 0


def test_moe_padded_rows_gradient():
    """moe_apply(n_real=n) writes the routed rows into a zero buffer in
    place (``out[:, :n] = ...``): its gradient equals that of the same
    tokens routed without padding, and the padding's routed rows take
    none."""
    cfg, p, x, _ = _moe_inputs(2, 24)
    cfg = dataclasses.replace(cfg, n_shared_experts=0)  # no dense rows
    B, n, S = 2, 8, 12
    x = x.view(B, S, cfg.d_model).to(torch.float32)
    p = {k: v.to(torch.float32) for k, v in p.items()}
    xa = x.clone().requires_grad_()
    out, aux = moe.moe_apply(p, xa, cfg, n_real=n)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    (ga,) = torch.autograd.grad((out * w).sum() + aux, xa)
    xb = x[:, :n].clone().requires_grad_()
    out_b, aux_b = moe.moe_apply(p, xb, cfg)
    (gb,) = torch.autograd.grad((out_b * w[:, :n]).sum() + aux_b, xb)
    torch.testing.assert_close(out[:, :n], out_b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ga[:, :n], gb, rtol=1e-5, atol=1e-6)
    assert torch.all(out[:, n:] == 0) and torch.all(ga[:, n:] == 0)
    assert np.isfinite(float(aux.detach()))
