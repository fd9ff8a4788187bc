"""Serve a small model with batched requests through the PackKV engine
(the torch port of examples/serve_packkv.py).

Builds two engines over the same weights, uncompressed and PackKV, serves
the same requests through both via the continuous slot scheduler, and
reports the agreement rate and scheduler stats: calibration -> slot-
scheduled serving with compressed decode. On a CUDA device the PackKV
engine decodes through the hand-written kernel (``fused_packed_attention``,
K2); its launch count is printed.

Run:  PYTHONPATH=src python examples/torch/serve_packkv.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.cache import PackKVConfig
from repro_torch.core.tiered import tiered_bits_per_value
from repro_torch.kernels.packed_attention import fused_packed_attention
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig, Request, SlotServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = get_arch("llama2-7b", smoke=True)  # reduced config
    api = get_model(cfg)
    params = api.init(torch.Generator(device=args.device).manual_seed(0), cfg)
    ecfg = EngineConfig(capacity=512, max_batch=4, calib_tokens=192,
                        device=args.device)

    print("building engines (calibration)...")
    e_none = Engine(cfg, params, PackKVConfig(policy="none"), ecfg)
    e_pack = Engine(cfg, params, PackKVConfig(k_rel_scale=0.02, v_rel_scale=0.02), ecfg)
    ks = e_pack.pack_cfg.k_spec_static
    print(f"calibrated K tiers {ks.widths} x {ks.counts} -> "
          f"{tiered_bits_per_value(ks):.2f} bits/value "
          f"({16 / tiered_bits_per_value(ks):.1f}x vs bf16)")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, max_new=args.max_new,
                    tokens=rng.integers(0, cfg.vocab, int(rng.integers(40, 120))))
            for i in range(args.requests)]

    outs = {}
    for name, eng in (("uncompressed", e_none), ("packkv", e_pack)):
        before = fused_packed_attention.launches
        srv = SlotServer(eng)
        for r in reqs:
            srv.submit(dataclasses.replace(r))
        srv.run()
        outs[name] = {r.rid: r.output for r in srv.done.values()}
        print(f"{name}: served {len(srv.done)} requests "
              f"(occupancy {srv.stats.occupancy:.2f}, "
              f"{srv.stats.slot_reuses} slot reuses, "
              f"{fused_packed_attention.launches - before} K2 launches)")

    agree = np.mean([(outs["uncompressed"][rid] == outs["packkv"][rid]).mean()
                     for rid in outs["uncompressed"]])
    print(f"greedy-token agreement (rel_scale=0.02): {agree:.1%}")
    print("(tighten/loosen rel scales to trade cache memory vs fidelity: "
          "paper Tables III/IV)")


if __name__ == "__main__":
    main()
