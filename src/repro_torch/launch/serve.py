"""Serving launcher: calibrated PackKV engine + slot-scheduled requests.

Example (on a CUDA GPU; add ``--device cpu --smoke`` to run the plain
PyTorch path on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --requests 6 --max-new 32 --prompt-len 512 --batch 4 --capacity 2048

``--paged`` serves from the page pool with page-reservation admission
(``--pool-pages`` below ``batch * capacity / page-size`` oversubscribes
it, so admission blocks on pages); admission is chunked by default
(``--prefill-chunk-pages 1``; 0 admits each prompt in one prefill).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..core.policy import get_policy
from ..kernels.packed_attention import (
    fused_packed_attention,
    fused_packed_attention_paged,
)
from ..models import get_model
from ..serving import Engine, EngineConfig, Request, SlotServer
from ..utils import tree_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--policy", default="packkv", choices=["packkv", "none", "kivi"])
    ap.add_argument("--backend", default="fused", choices=["fused", "ref"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--prefill-chunk-pages", type=int, default=1)
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "PyTorch path on the CPU")
    cfg = get_arch(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = get_model(cfg).init(gen, cfg)
    ecfg = EngineConfig(capacity=args.capacity, max_batch=args.batch,
                        backend=args.backend, device=args.device,
                        paged=args.paged, page_size=args.page_size,
                        pool_pages=args.pool_pages,
                        prefill_chunk_pages=args.prefill_chunk_pages)
    t0 = time.time()
    engine = Engine(cfg, params, get_policy(args.policy), ecfg)
    print(f"engine built in {time.time() - t0:.1f}s; policy={args.policy}, "
          f"backend={args.backend}, device={args.device}")
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    if ks is not None:
        print(f"calibrated K tiers {ks.widths}x{ks.counts}; "
              f"V tiers {vs.widths}x{vs.counts}")

    server = SlotServer(engine)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        server.submit(Request(rid=rid, max_new=args.max_new,
                              tokens=rng.integers(0, cfg.vocab, plen)))
    kernels = (fused_packed_attention, fused_packed_attention_paged)
    for k in kernels:
        k.launches = 0
    t0 = time.time()
    done = server.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.time() - t0
    n_tok = sum(len(r.output) for r in done)
    print(f"{args.requests} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s on {args.device}, prefill included)")
    s = server.stats
    print(f"slot scheduler: {s.decode_steps} decode steps, "
          f"occupancy {s.occupancy:.2f}, {s.slot_reuses} slot reuses, "
          f"{s.admitted} admitted / {s.completed} completed, "
          f"{s.prefill_chunks} prefill chunks")
    if args.paged:
        print(f"page pool: {engine.pack_cfg.pool_pages} pages of "
              f"{args.page_size}, peak reserved {s.pages_reserved_peak}, "
              f"{s.admission_blocks} admission blocks")
    where = "CUDA kernel" if engine.device.type == "cuda" else "plain version on CPU"
    print(f"fused kernel launches: {sum(k.launches for k in kernels)} ("
          + ", ".join(f"{k.__name__} {k.launches}" for k in kernels)
          + f"; {where})")
    comp = tree_bytes(server.cache)
    tokens = (engine.pack_cfg.pool_pages * args.page_size if args.paged
              else args.batch * args.capacity)
    raw = cfg.n_layers * 2 * tokens * cfg.n_kv_heads * cfg.hd * 2
    print(f"cache bytes ({tokens} tokens of storage): {comp:,} vs raw bf16 "
          f"{raw:,} -> {raw / comp:.2f}x smaller")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
