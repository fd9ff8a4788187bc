"""Quickstart: compress a KV cache with PackKV and decode against it (the
torch port of examples/quickstart.py).

Shows the paper's full pipeline on one layer of data:
  quantize -> repack -> tier-pack -> seamless append -> fused decode
and reports the compression ratio and the attention error against full
precision. On a CUDA device the fused decode is the hand-written kernel
(``fused_packed_attention``, K2); on the CPU its plain PyTorch version.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.cache import (
    PackKVConfig,
    alloc_layer_cache,
    append_token,
    calibrate_specs,
    prefill_cache,
)
from repro_torch.data import synthetic_kv
from repro_torch.kernels import ops
from repro_torch.kernels.packed_attention import fused_packed_attention
from repro_torch.kernels.ref import dense_decode_attention_ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    B, H_kv, H_q, D, capacity = 1, 4, 8, 128, 1024
    prompt_len = 512
    kv = lambda n: torch.from_numpy(synthetic_kv(rng, B, H_kv, n, D)).to(dev)

    # "prefill" K/V (stand-ins for a model's attention projections)
    k, v = kv(prompt_len), kv(prompt_len)

    # 1. calibrate static tier widths from the data (engine-build step)
    cfg = calibrate_specs(k, v, PackKVConfig(k_rel_scale=0.1, v_rel_scale=0.2))
    print("calibrated K tiers:", cfg.k_spec_static.widths, cfg.k_spec_static.counts)
    print("calibrated V tiers:", cfg.v_spec_static.widths, cfg.v_spec_static.counts)

    # 2. prefill: quantize + V-median repack + bit-pack, block by block
    cache = alloc_layer_cache(cfg, B, H_kv, D, capacity, device=dev)
    prefill_cache(cache, k, v)
    print(f"compressed {int(cache.n_comp[0])} tokens; {int(cache.n_resid[0])} in the "
          f"bf16 residual buffer")

    # 3. seamless appending during decode
    for _ in range(10):
        kt = kv(1)
        append_token(cache, kt, kt)

    # 4. computation-aware decompression: fused decode attention
    q = torch.from_numpy(rng.normal(size=(B, H_q, D)).astype(np.float32)).to(dev)
    args_ = (q, cache.k, cache.v, cache.resid_k, cache.resid_v, cache.n_comp,
             cache.n_resid)
    before = fused_packed_attention.launches
    out = ops.packed_decode_attention(*args_, sm_scale=D ** -0.5)
    launched = fused_packed_attention.launches - before
    # the same op on the plain oracle path
    out_ref = ops.packed_decode_attention(*args_, sm_scale=D ** -0.5, backend="ref")
    print(f"fused path ({'K2 kernel' if launched else 'plain version'}, "
          f"{launched} launch) max |delta| vs the ref path: "
          f"{float((out - out_ref).abs().max()):.3g}")

    # 5. accuracy + memory vs the uncompressed baseline
    pad = torch.zeros((B, H_kv, capacity - prompt_len, D), device=dev)
    exact = dense_decode_attention_ref(
        q, torch.cat([k, pad], 2), torch.cat([v, pad], 2), cache.resid_k,
        cache.resid_v, torch.tensor(prompt_len, device=dev), cache.n_resid, D ** -0.5)
    rel = float((out - exact).abs().max() / exact.abs().max())
    comp = sum(t.payload.numel() * 4 + t.mins.numel() + t.shifts.numel()
               for c in (cache.k, cache.v) for t in c.tiers) \
        + cache.k.scale.numel() * 4 + cache.v.scale.numel() * 4
    raw = 2 * B * H_kv * capacity * D * 2
    print(f"attention output rel err vs fp32: {rel:.4f}")
    print(f"cache: {comp:,} B compressed vs {raw:,} B raw bf16 -> {raw / comp:.1f}x")


if __name__ == "__main__":
    main()
