"""Where K4's (or K7's) time goes on the card: the V tier matvec with parts
of it cut out.

  PYTHONPATH=src python -m repro_torch.launch.matvec_breakdown \\
      [--source FILE ...] [--flush write read] [--page 0 256]

Builds each ``--source`` (default: the committed ``csrc/tier_matvec.cu``;
each is built beside the headers of its own directory, so an edited copy
of ``csrc/`` is timed beside the committed one in the same process) and
variants of it, each with parts removed by a text edit of the source (the
variants compute wrong values; only their times mean anything):

  full        the kernel as it is
  no_tma      payload and mins by cp.async instead of tensor copies
  no_merge    without the last span block's sum of the row's spans
  no_compute  without the consumers' decode and FMAs
  no_copies   without the copies of the tier bytes (w still comes)
  skeleton    without both: launch, w, barriers, partials, merge
  empty       every block exits at once

and times each at the decode shape of ``chip_smoke.py``'s matvec phase
(B=4, H_kv=32, G=1, a 2048-token bucket, live counts {0, 64, 1344, 2048},
one 4-bit tier of 128 channels, pack 8) the way it times kernels (L2
flushed, a spin kernel ahead, median of 20; ``launch/k2_breakdown.py``),
the sources and variants in turns, beside two yardsticks: ``torch.sum``
over a contiguous f32 tensor of as many bytes as K4 must move, and an
empty launch. ``--flush read`` flushes the L2 by reading 64 MB instead of
writing them; ``--page N`` times K7 over a pool of N-token pages under a
shuffled table instead of K4 (0: K4). Both take several values, and each
pair of them is timed in its own rounds. Prints one JSON line per round
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..core import cache as tc
from ..core.tiered import TierSpec
from ..kernels import build
from ..kernels import kpack_matvec as km
from ..kernels.packed_attention import _rows_to_bh
from ..kernels.vpack_matvec import vpack_tier_out, vpack_tier_out_paged
from .k2_breakdown import build_variants, time_ms

_TMA = ("  s.tma = s.run == SPAN && (a & 15) == 0;", "  s.tma = 0;")
_MERGE = ("  merge_spans(p, r, nsp);\n", "")
_COMPUTE = ("        if (live) {  // decode and FMA", "        if (false) {  // decode and FMA")
_COPIES = ("      stage_group<PAGED, LW>(p, lay, &tm_pay, &tm_min, bufs + slot * lay.group, r, s0, n,\n"
           "                             gi * CG, min(CG, C - gi * CG), &full[slot], lane);\n", "")
_EXIT = ("  if (s0 >= n) {  // a dead span", "  if (true) {  // a dead span")
VARIANTS = {"full": [], "no_tma": [_TMA], "no_merge": [_MERGE], "no_compute": [_COMPUTE],
            "no_copies": [_COPIES], "skeleton": [_COPIES, _COMPUTE], "empty": [_EXIT]}


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in km._ENTRIES:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", type=Path,
                    help="a tier_matvec.cu to time (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--flush", nargs="+", choices=("write", "read"), default=["write"])
    ap.add_argument("--page", nargs="+", type=int, default=[0],
                    help="time K7 at these page sizes (0: K4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matvec_breakdown times CUDA kernels: no CUDA device")
    sources = args.source or [build.CSRC / "tier_matvec.cu"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    spec = TierSpec((4,), (128,), 8)
    B, h_kv, D, L, lengths = 4, 32, 128, 2048, (0, 64, 1344, 2048)
    cfg = tc.PackKVConfig(k_spec_static=spec, v_spec_static=spec)
    cache = tc.alloc_layer_cache(cfg, B, h_kv, D, L, device=dev)
    for r, n in enumerate(lengths):
        if n:
            kv = [(torch.randn((h_kv, n, D), generator=gen, device=dev) * 2 + 1)
                  .to(torch.bfloat16) for _ in range(2)]
            tc.insert_prefill(cache, r, *kv)
    BH = B * h_kv
    nv = _rows_to_bh(cache.n_comp, B, h_kv, dev)
    w = torch.softmax(torch.randn((BH, 1, L), generator=gen, device=dev), -1)
    w = w * cache.v.scale.reshape(BH, 1, L)
    t = cache.v.tiers[0]
    kw = dict(width=t.width, pack_size=t.pack_size)
    leaves = tuple(x.reshape(BH, *x.shape[2:]) for x in (t.payload, t.mins, t.shifts))
    calls = {0: lambda: vpack_tier_out(*leaves, w, n_valid=nv, **kw)}
    for page in args.page:
        if page:
            pt, table = _pool_tier(cache, page, gen)
            calls[page] = (lambda pt=pt, table=table, page=page: vpack_tier_out_paged(
                *pt, w, table, nv, page_size=page, **kw))
    # K4's bytes (chip_smoke.py's k4_bytes at this shape), as one f32 tensor
    P = [n // 8 for n in lengths]
    tier = sum(h_kv * 128 * (n * 4 // 8 + p + (p + 3) // 4) for n, p in zip(lengths, P))
    nbytes = tier + sum(lengths) * h_kv * 4 + BH * D * 4 + BH * 4
    x = torch.randn(nbytes // 4, generator=gen, device=dev)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor() as pool:
            built = list(pool.map(
                lambda i: build_variants(sources[i], VARIANTS, Path(tmp) / str(i)),
                range(len(sources))))
        libs = {(i, name): _bind(p) for i, paths in enumerate(built) for name, p in paths.items()}
        saved = km._lib
        try:
            for page in args.page:
                for how in args.flush:
                    flush = flush_buf.zero_ if how == "write" else flush_buf.max
                    for rnd in range(args.rounds):
                        row = {"round": rnd, "flush": how, "page": page, "bytes": nbytes,
                               "torch_sum_ms": time_ms(lambda: x.sum(), flush),
                               "empty_launch_ms": time_ms(lambda: torch.cuda._sleep(0),
                                                          flush)}
                        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
                        for key in order:
                            km._lib = libs[key]
                            i, name = key
                            row[f"{i}:{name}_ms"] = time_ms(calls[page], flush)
                        print(json.dumps(row), flush=True)
        finally:
            km._lib = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


def _pool_tier(cache, page: int, gen):
    """The V tier's pool leaves and the page table of the dense cache's
    pages scattered into a pool of B * L / page pages under a shuffled
    table."""
    import dataclasses

    B, h_kv, L = cache.k.scale.shape
    cfg = dataclasses.replace(cache.cfg, paged=True, page_size=page)
    paged = tc.alloc_layer_cache(cfg, B, h_kv, cache.k.spec.head_dim, L,
                                 device=cache.n_comp.device)
    phys = torch.randperm(B * (L // page), generator=gen, device=gen.device)
    phys = phys.to(torch.int32).reshape(B, L // page)
    for pool, dense in ((paged.k, cache.k), (paged.v, cache.v)):
        tc._scatter_pages_tiered(pool, dense, phys)
        pool.chan_perm.copy_(dense.chan_perm)
    pt = paged.v.tiers[0]
    return (pt.payload, pt.mins, pt.shifts), phys


if __name__ == "__main__":
    raise SystemExit(main())
