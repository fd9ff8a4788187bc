"""Serving launcher: calibrated PackKV engine + slot-scheduled requests.

Example (on a CUDA GPU; add ``--device cpu --smoke`` to run the plain
PyTorch path on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --requests 6 --max-new 32 --prompt-len 512 --batch 4 --capacity 2048

``--arch`` takes every config: llama2-7b, smollm-135m, minicpm-2b,
minitron-4b, qwen3-32b, qwen2-moe-a2.7b, moonshot-v1-16b-a3b, and the
recurrent rwkv6-1.6b and recurrentgemma-9b (internvl2-2b and hubert-xlarge
are refused as the reference refuses them: the VLM's patch prefix goes
through ``Engine.generate``, the encoder has no decode). The recurrent
families refuse ``--paged``, ``--prefix-cache``, ``--spec-decode``,
``--preempt`` and ``--session-cache`` with the reference's messages;
recurrentgemma-9b's window caches take the window as their capacity. ``--paged`` serves from the page pool with
page-reservation admission (``--pool-pages`` below ``batch * capacity /
page-size`` oversubscribes it, so admission blocks on pages); admission is
chunked by default (``--prefill-chunk-pages 1``; 0 admits each prompt in
one prefill). ``--prefix-cache`` (with ``--paged``) shares prompt pages
across requests, at most ``--prefix-cache-pages`` of them pinned by the
index; its demo traffic opens every prompt with the same two-page system
prompt, so later admissions hit. ``--spec-decode`` verifies up to
``--spec-k`` n-gram drafts a row in one pass; the outputs are those of
plain decode (random prompts give few drafts and little acceptance).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from ..configs import ARCHS, get_arch
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
    ap.add_argument("--arch", default="llama2-7b", choices=sorted(ARCHS))
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share indexed prompt pages across requests (needs --paged)")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    help="most pages the prefix index may pin")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decode: n-gram drafts verified in one "
                    "pass; outputs equal plain decode's")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="most drafts a verify pass (window spec-k + 1)")
    ap.add_argument("--preempt", action="store_true",
                    help="a blocked higher-class admission swaps a lower-class "
                    "row out to host memory; it resumes bitwise later")
    ap.add_argument("--aging-steps", type=int, default=32,
                    help="scheduler steps per class promotion of queued work "
                    "(0 = strict priority)")
    ap.add_argument("--priority-every", type=int, default=0, metavar="N",
                    help="every Nth request is class 0, the rest class 1 "
                    "(0 = all class 0)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expired requests retire with "
                    "their partial output")
    ap.add_argument("--session-cache", action="store_true",
                    help="park retiring rows host-side; returning sessions "
                    "restore them and prefill only their new suffix")
    ap.add_argument("--session-cache-mb", type=int, default=256,
                    help="host budget of parked rows (LRU by bytes past it)")
    ap.add_argument("--session-ttl-s", type=float, default=None,
                    help="idle parked sessions expire after this (default never)")
    ap.add_argument("--session-disk-dir", default=None, metavar="DIR",
                    help="spill host-tier LRU victims here (default: drop them)")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write the final SlotStats as JSON to PATH")
    ap.add_argument("--mesh", default="1,1", metavar="DP,KV",
                    help="serving mesh 'dp,kv': pool payloads split by KV head "
                    "over kv lanes, attention rows over dp (1,1 = one device; "
                    "tokens are bitwise the same either way). --device cpu "
                    "puts every lane on the CPU; cuda takes one card a lane "
                    "unless --mesh-devices names them")
    ap.add_argument("--mesh-devices", default=None, metavar="DEV,...",
                    help="the lanes' devices, dp-major, one a lane; a device "
                    "may repeat (e.g. cuda:0,cuda:0 runs --mesh 1,2 on one card)")
    args = ap.parse_args(argv)

    try:
        mesh_shape = tuple(int(x) for x in args.mesh.split(","))
        assert len(mesh_shape) == 2
    except (ValueError, AssertionError):
        raise SystemExit(f"--mesh takes 'dp,kv' (e.g. 1,2), got {args.mesh!r}")
    mesh_devices = None
    if args.mesh_devices is not None:
        mesh_devices = tuple(d.strip() for d in args.mesh_devices.split(","))
        n_lanes = mesh_shape[0] * mesh_shape[1]
        if len(mesh_devices) != n_lanes:
            raise SystemExit(f"--mesh-devices names {len(mesh_devices)} devices; "
                             f"--mesh {args.mesh} has {n_lanes} lanes")

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "PyTorch path on the CPU")
    cfg = get_arch(args.arch, smoke=args.smoke)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only; nothing to serve")
    api = get_model(cfg)
    if args.session_cache and api.evacuate_slot is None:
        raise SystemExit(
            f"{args.arch} (family {cfg.family!r}) cannot serve "
            "--session-cache: its recurrent slot state has no "
            "evacuate/restore ops to park through — drop --session-cache")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = api.init(gen, cfg)
    ecfg = EngineConfig(capacity=args.capacity, max_batch=args.batch,
                        backend=args.backend, device=args.device,
                        paged=args.paged, page_size=args.page_size,
                        pool_pages=args.pool_pages,
                        prefill_chunk_pages=args.prefill_chunk_pages,
                        prefix_cache=args.prefix_cache,
                        prefix_cache_pages=args.prefix_cache_pages,
                        spec_decode=args.spec_decode, spec_k=args.spec_k,
                        preempt=args.preempt, aging_steps=args.aging_steps,
                        session_cache=args.session_cache,
                        session_cache_mb=args.session_cache_mb,
                        session_ttl_s=args.session_ttl_s,
                        session_disk_dir=args.session_disk_dir,
                        mesh_shape=mesh_shape, mesh_devices=mesh_devices)
    t0 = time.time()
    engine = Engine(cfg, params, get_policy(args.policy), ecfg)
    print(f"engine built in {time.time() - t0:.1f}s; policy={args.policy}, "
          f"backend={args.backend}, device={args.device}")
    if engine.mesh is not None:
        print(f"serving mesh dp={mesh_shape[0]} x kv={mesh_shape[1]} over "
              f"{mesh_shape[0] * mesh_shape[1]} lanes: pool payloads "
              f"sharded by KV head ({cfg.n_kv_heads} -> "
              f"{cfg.n_kv_heads // mesh_shape[1]}/lane), page ledger replicated; "
              f"lanes on {[str(d) for d in engine.mesh.devices]}")
    ks, vs = engine.pack_cfg.k_spec_static, engine.pack_cfg.v_spec_static
    if ks is not None:
        print(f"calibrated K tiers {ks.widths}x{ks.counts}; "
              f"V tiers {vs.widths}x{vs.counts}")

    if cfg.input_mode != "tokens":
        raise SystemExit(
            f"{args.arch} takes input_mode {cfg.input_mode!r}; the request "
            "queue carries token prompts only — batch such inputs through "
            "Engine.generate instead")
    server = SlotServer(engine)
    rng = np.random.default_rng(args.seed)
    # --prefix-cache demo traffic: every request opens with the same
    # two-page system prompt, so later admissions hit the index
    sys_prompt = (rng.integers(0, cfg.vocab, 2 * args.page_size)
                  if args.prefix_cache else np.zeros(0, np.int64))
    for rid in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        toks = np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, plen)])
        n = args.priority_every
        server.submit(Request(rid=rid, max_new=args.max_new, tokens=toks,
                              priority=0 if n <= 0 or rid % n == 0 else 1,
                              deadline_ms=args.deadline_ms))
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
    digest = hashlib.sha256(b"".join(
        np.asarray(server.done[rid].output, np.int64).tobytes()
        for rid in sorted(server.done))).hexdigest()[:16]
    print(f"outputs sha256 {digest} (every request's tokens in request order: "
          "equal digests, equal tokens)")
    if args.session_cache:
        # every request returns with a short follow-up on its whole trace
        t0 = time.time()
        for rid in range(args.requests):
            r = server.done[rid]
            trace = np.concatenate([np.asarray(r.tokens), np.asarray(r.output)])
            server.submit(Request(rid=args.requests + rid, max_new=args.max_new,
                                  tokens=np.concatenate(
                                      [trace, rng.integers(0, cfg.vocab, 8)])))
        n2 = sum(len(r.output) for r in server.run())
        print(f"{args.requests} returning sessions, {n2} tokens in "
              f"{time.time() - t0:.1f}s")
    s = server.stats
    print(f"slot scheduler: {s.decode_steps} decode steps, "
          f"occupancy {s.occupancy:.2f}, {s.slot_reuses} slot reuses, "
          f"{s.admitted} admitted / {s.completed} completed, "
          f"{s.prefill_chunks} prefill chunks")
    if args.paged:
        print(f"page pool: {engine.pack_cfg.pool_pages} pages of "
              f"{args.page_size}, peak reserved {s.pages_reserved_peak}, "
              f"{s.admission_blocks} admission blocks")
    if args.prefix_cache:
        print(f"prefix cache: {s.prefix_hits}/{s.prefix_lookups} hits "
              f"(rate {s.prefix_hit_rate:.2f}), {s.prefix_pages_shared} pages "
              f"shared by reference, {s.prefix_evictions} evictions")
    if args.spec_decode:
        print(f"speculative decode: {s.spec_launches} verify passes, "
              f"{s.spec_accepted}/{s.spec_drafted} drafts accepted (rate "
              f"{s.acceptance_rate:.2f}), {s.degraded_steps} degraded steps "
              "(speculation off after the straggler watchdog)")
    if args.preempt:
        print(f"preemption: {s.preemptions} swap-outs ({s.swapped_pages} pages "
              f"out / {s.restored_pages} back), swap store peak "
              f"{server._swap.peak_bytes / 1e6:.1f} MB")
    if args.session_cache:
        st = server._sessions
        print(f"session cache: {s.session_parks} parks, {s.session_hits}/"
              f"{s.session_lookups} hits (rate {s.session_hit_rate:.2f}), "
              f"{s.session_restored_pages} pages restored, {s.session_evictions} "
              f"evicted or expired; host {st.nbytes / 1e6:.1f} MB resident (peak "
              f"{st.peak_bytes / 1e6:.1f}), {st.spills} disk spills / {st.loads} loads")
    if s.cancelled or s.expired:
        print(f"retired early: {s.cancelled} cancelled, {s.expired} past deadline")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(s.to_json(), f, indent=2)
        print(f"wrote {args.stats_json}")
    where = "CUDA kernel" if engine.device.type == "cuda" else "plain version on CPU"
    print(f"fused kernel launches: {sum(k.launches for k in kernels)} ("
          + ", ".join(f"{k.__name__} {k.launches}" for k in kernels)
          + f"; {where})")
    if engine.mesh is None:
        comp = tree_bytes(server.cache)
    else:  # one dp row of lanes holds every head once
        lanes = server.cache.lanes
        print(f"mesh cache bytes a lane: {[tree_bytes(x) for x in lanes]}")
        comp = tree_bytes(lanes[:engine.mesh.n_kv])
    if cfg.family == "rwkv6":
        print(f"recurrent state bytes ({args.batch} rows): {comp:,}")
        return 0
    kv_layers, cap = cfg.n_layers, args.capacity
    if cfg.family == "hybrid_rglru":  # the window caches alone
        kv_layers, cap = cfg.n_layers // 3, cfg.window
        comp = tree_bytes(server.cache.cache)
    tokens = (engine.pack_cfg.pool_pages * args.page_size if args.paged
              else args.batch * cap)
    raw = kv_layers * 2 * tokens * cfg.n_kv_heads * cfg.hd * 2
    print(f"cache bytes ({tokens} tokens of storage): {comp:,} vs raw bf16 "
          f"{raw:,} -> {raw / comp:.2f}x smaller")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
