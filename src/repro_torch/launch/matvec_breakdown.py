"""Where the tier matvecs' time goes on the card: K3 (or K6) and K4 (or K7)
with parts of them cut out.

  PYTHONPATH=src python -m repro_torch.launch.matvec_breakdown \\
      [--kernel k3 k4] [--source FILE ...] [--flush write read] [--page 0 256]

Builds each ``--source`` (default: the committed ``csrc/tier_matvec.cu``;
each is built beside the headers of its own directory, so an edited copy
of ``csrc/`` is timed beside the committed one in the same process) and
variants of it, each with parts removed by a text edit of the source (the
variants compute wrong values; only their times mean anything). K3/K6:

  full        the kernel as it is
  no_compute  the loads without the decode and FMAs
  no_loads    the decode and FMAs on words already in registers (no tier
              bytes read; q still comes)
  no_reduce   without the sum of the warps' partials (one warp stores)
  dead_only   the live span blocks exit at once; the dead spans still
              write their zeros
  empty       every block exits at once

K4/K7:

  full        the kernel as it is
  no_tma      payload and mins by cp.async instead of tensor copies
  no_merge    without the last span block's sum of the row's spans
  no_compute  without the consumers' decode and FMAs
  no_copies   without the copies of the tier bytes (w still comes)
  skeleton    without both: launch, w, barriers, partials, merge
  empty       every block exits at once

The K3 edits hold the text of both designs the repo has had (PR 13's
block per span with a warp per channel stride, and the producer-warp
design that replaced it), so either source can be broken down. Each
``--kernel`` is timed at the decode shape of ``chip_smoke.py``'s matvec
phase (B=4, H_kv=32, G=1, a 2048-token bucket, live counts {0, 64, 1344,
2048}, one 4-bit tier of 128 channels, pack 8) the way it times kernels (L2
flushed, a spin kernel ahead, median of 20; ``launch/k2_breakdown.py``),
the sources and variants in turns, beside two yardsticks: ``torch.sum``
over a contiguous f32 tensor of as many bytes as the kernel must move
(``chip_smoke.py``'s ``k3_bytes`` / ``k4_bytes``), and an empty launch.
``--flush read`` flushes the L2 by reading 64 MB instead of writing them;
``--page N`` times K6 / K7 over a pool of N-token pages under a shuffled
table instead of K3 / K4 (0: the dense kernel). Each pair of values is
timed in its own rounds. Prints each source's registers per thread and
spill bytes of the main width's instantiations (``-Xptxas -v``), each source's full
kernels' largest difference from the first source's on the same inputs
(0.0: bitwise equal), one JSON line per round, and the card's name and
power limit.
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
from ..kernels.kpack_matvec import kpack_tier_scores, kpack_tier_scores_paged
from ..kernels.packed_attention import _rows_to_bh
from ..kernels.vpack_matvec import vpack_tier_out, vpack_tier_out_paged
from .k2_breakdown import build_variants, time_ms

# K4/K7 (PR 15's span design, its producer loop since shared with K3/K6)
_TMA = ("  s.tma = s.run == SPAN && (a & 15) == 0;", "  s.tma = 0;")
_MERGE = ("  merge_spans(p, r, nsp);\n", "")
_COMPUTE = ("        if (live) {  // decode and FMA", "        if (false) {  // decode and FMA")
_STAGE = ("stage_group<PAGED, LW>(p, lay, tm_pay, tm_min,",
          "if (false) stage_group<PAGED, LW>(p, lay, tm_pay, tm_min,")  # in produce_groups
_COPIES = [("      stage_group<PAGED, LW>(p, lay, &tm_pay, &tm_min, bufs + slot * lay.group, r, s0, n,\n"
            "                             gi * CG, min(CG, C - gi * CG), &full[slot], lane);\n", ""),
           _STAGE]  # PR 15's K4 held its own producer loop; produce_groups since
_EXIT = ("  if (s0 >= n) {  // a dead span", "  if (true) {  // a dead span")
K4_VARIANTS = {"no_tma": [_TMA], "no_merge": [_MERGE], "no_compute": [_COMPUTE],
               "no_copies": [_COPIES], "skeleton": [_COPIES, _COMPUTE], "empty": [_EXIT]}

# K3/K6: each edit first in PR 13's design (kpack_scores_kernel), then in
# the producer-warp design (kpack_span_kernel)
_K3_OLD_FMA = """        float x[CHUNK];
        ch[u].decode(l0, x);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) {
            const float qc = s_q[g][c];
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) part[g][k] = fmaf(qc, x[k], part[g][k]);
          }
"""
_K3_OLD_LOAD = "        if (c0 + u * NWARPS < C) ch[u].load(p, s, h, ll0, c0 + u * NWARPS);\n"
_K3_OLD_REDUCE = """    float4* dst = reinterpret_cast<float4*>(&s_part[warp][lane * CHUNK]);
    dst[0] = make_float4(part[g][0], part[g][1], part[g][2], part[g][3]);
    dst[1] = make_float4(part[g][4], part[g][5], part[g][6], part[g][7]);
    __syncthreads();
    if (t < L) {
      float si = s_part[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) si += s_part[w][threadIdx.x];
      out[static_cast<int64_t>(g) * L + t] = t < n ? si : 0.f;
    }
    __syncthreads();
"""
_K3_OLD_LIVE = "  const float* q = p.x + r * p.x_sr;\n"
_K3_OLD_DEAD = "  if (span0 >= n) {  // dead span: exact zeros, nothing decoded"
_K3_NEW_FMA = "if (live) {  // K3: decode and FMA"
_K3_NEW_LOAD = "decode_chunk<LW>(buf, mins, sfts, lp, cq + j, t0, x);  // K3: decode"
_K3_NEW_REDUCE = "  // K3: the warps' partials, added in warp order\n"
_K3_NEW_LIVE = "  // K3: a live span\n"
_K3_NEW_DEAD = "  if (s0 >= n) {  // K3: a dead span"
K3_VARIANTS = {
    # keep every loaded word live through an integer XOR chain
    "no_compute": [[(_K3_OLD_FMA, "        part[0][0] = __uint_as_float(__float_as_uint(part[0][0])"
                     " ^ ch[u].wd[0] ^ ch[u].wd[Chunk<LW>::NW - 1] ^ ch[u].sh ^ ch[u].mv);\n"),
                    (_K3_NEW_FMA, "if (live) {  // K3: decode and FMA\n"
                     "  for (int j = 0; j < 4; ++j) part[0][j] = __uint_as_float("
                     "__float_as_uint(part[0][j]) ^ reinterpret_cast<const uint32_t*>("
                     "buf + (cq + j) * ((SPAN << LW) >> 3))[(t0 << LW) >> 5] ^ mins[(cq + j) * "
                     "(SPAN >> lp) + (t0 >> lp)] ^ sfts[(cq + j) * (SPAN >> (lp + 2))]);\n"
                     "}\nif (false) {")]],
    # words, shift and min made up from the channel and lane, not loaded
    # (the new design also drops its copies: the groups only arrive; PR
    # 13's design has none to drop)
    "no_loads": [[_STAGE, (_K3_OLD_LOAD, _K3_OLD_LOAD)],
                 [(_K3_OLD_LOAD,
                   "        if (c0 + u * NWARPS < C) {\n"
                   "          for (int w = 0; w < Chunk<LW>::NW; ++w)\n"
                   "            ch[u].wd[w] = (c0 + u) * 0x9E3779B9u ^ (lane << w);\n"
                   "          ch[u].sh = (c0 + u) & 3;\n"
                   "          ch[u].mv = ((c0 + u) & 63) - 32;\n"
                   "        }\n"),
                  (_K3_NEW_LOAD,
                   "{\n"
                   "  uint32_t wd[(CHUNK << LW) >= 32 ? (CHUNK << LW) / 32 : 1];\n"
                   "  for (int w = 0; w < sizeof(wd) / 4; ++w)\n"
                   "    wd[w] = (cq + j + c0) * 0x9E3779B9u ^ (lane << w);\n"
                   "  decode_tier_run<LW, CHUNK>(wd, t0, (cq + j) & 3, ((cq + j + c0) & 63) - 32, x);\n"
                   "}")]],
    # one warp stores its own partials; the others keep theirs live
    "no_reduce": [[(_K3_OLD_REDUCE,
                    "    if ((warp == 0 || part[g][0] == 1.2345f) && l0 < L) {\n"
                    "      float4* dst = reinterpret_cast<float4*>(out + static_cast<int64_t>(g) * L"
                    " + l0);\n"
                    "      dst[0] = make_float4(part[g][0], part[g][1], part[g][2], part[g][3]);\n"
                    "      dst[1] = make_float4(part[g][4], part[g][5], part[g][6], part[g][7]);\n"
                    "    }\n"),
                   (_K3_NEW_REDUCE,
                    "  if ((warp == 0 || part[0][0] == 1.2345f) && s0 + lane * CHUNK < L) {\n"
                    "#pragma unroll\n"
                    "    for (int g = 0; g < GM; ++g)\n"
                    "      if (g < G) {\n"
                    "        float4* dst = reinterpret_cast<float4*>(out + g * L + lane * CHUNK);\n"
                    "        dst[0] = make_float4(part[g][0], part[g][1], part[g][2], part[g][3]);\n"
                    "        dst[1] = make_float4(part[g][4], part[g][5], part[g][6], part[g][7]);\n"
                    "      }\n"
                    "  }\n"
                    "  return;\n")]],
    "dead_only": [[(_K3_OLD_LIVE, "  return;\n" + _K3_OLD_LIVE),
                   (_K3_NEW_LIVE, "  return;\n")]],
    "empty": [[(_K3_OLD_DEAD, "  return;\n" + _K3_OLD_DEAD),
               (_K3_NEW_DEAD, "  return;\n" + _K3_NEW_DEAD)]],
}
VARIANTS = {"k3": K3_VARIANTS, "k4": K4_VARIANTS}


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in km._ENTRIES:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _variants(kernels) -> dict:
    """The variants to build: ``full`` and each kernel's own as
    ``<kernel>.<variant>``."""
    out = {"full": []}
    for k in kernels:
        out.update({f"{k}.{name}": edits for name, edits in VARIANTS[k].items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", type=Path,
                    help="a tier_matvec.cu to time (repeatable)")
    ap.add_argument("--kernel", nargs="+", choices=("k3", "k4"), default=["k4"],
                    help="k3: K3 (K6 with --page); k4: K4 (K7)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--flush", nargs="+", choices=("write", "read"), default=["write"])
    ap.add_argument("--page", nargs="+", type=int, default=[0],
                    help="time K6/K7 at these page sizes (0: K3/K4)")
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
    q = torch.randn((BH, 1, D), generator=gen, device=dev)
    w = torch.softmax(torch.randn((BH, 1, L), generator=gen, device=dev), -1)
    w = w * cache.v.scale.reshape(BH, 1, L)
    flat = lambda t: tuple(x.reshape(BH, *x.shape[2:]) for x in (t.payload, t.mins, t.shifts))
    kl, vl = flat(cache.k.tiers[0]), flat(cache.v.tiers[0])
    kw = dict(width=4, pack_size=8)
    calls = {("k3", 0): lambda: kpack_tier_scores(*kl, q, n_valid=nv, **kw),
             ("k4", 0): lambda: vpack_tier_out(*vl, w, n_valid=nv, **kw)}
    for page in args.page:
        if page:
            (pk, pv), table = _pool_tiers(cache, page, gen)
            calls[("k3", page)] = (lambda pk=pk, table=table, page=page: kpack_tier_scores_paged(
                *pk, q, table, nv, L, page_size=page, **kw))
            calls[("k4", page)] = (lambda pv=pv, table=table, page=page: vpack_tier_out_paged(
                *pv, w, table, nv, page_size=page, **kw))
    # each kernel's bytes (chip_smoke.py's k3_bytes / k4_bytes at this
    # shape), as one f32 tensor: the live tier, then K3's q and its whole
    # score bucket or K4's live weights and its output, and n_valid
    P = [n // 8 for n in lengths]
    tier = sum(h_kv * 128 * (n * 4 // 8 + p + (p + 3) // 4) for n, p in zip(lengths, P))
    nbytes = {"k3": tier + BH * D * 4 + BH * L * 4 + BH * 4,
              "k4": tier + sum(lengths) * h_kv * 4 + BH * D * 4 + BH * 4}
    sums = {k: torch.randn(nbytes[k] // 4, generator=gen, device=dev) for k in args.kernel}
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    variants = _variants(args.kernel)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor() as pool:
            built = list(pool.map(
                lambda i: build_variants(sources[i], variants, Path(tmp) / str(i)),
                range(len(sources))))
        for i, paths in enumerate(built):
            usage = build.ptxas_usage(paths["full"].with_suffix(".log").read_text())
            # the tier kernels' template arguments are (PAGED, LW, ...): LW 2 is 4 bits
            main_width = {k: v for k, v in usage.items()
                          if k.rstrip(">").split(",")[1:2] == ["2"]}
            print(json.dumps({"source": i, "file": str(sources[i]),
                              "ptxas_main_width": main_width}), flush=True)
        libs = {(i, name): _bind(p) for i, paths in enumerate(built) for name, p in paths.items()}
        saved = km._lib
        try:
            # each source's full kernel against the first's, on the same inputs
            # (0.0: bitwise equal)
            for kernel in args.kernel:
                for page in args.page:
                    outs = []
                    for i in range(len(sources)):
                        km._lib = libs[(i, "full")]
                        outs.append(calls[(kernel, page)]())
                    torch.cuda.synchronize()
                    print(json.dumps({"kernel": kernel, "page": page, "max_abs_diff_vs_source_0": [
                        float((o - outs[0]).abs().max()) for o in outs]}), flush=True)
            for kernel in args.kernel:
                keys = [k for k in libs if k[1] == "full" or k[1].startswith(kernel + ".")]
                for page in args.page:
                    for how in args.flush:
                        flush = flush_buf.zero_ if how == "write" else flush_buf.max
                        for rnd in range(args.rounds):
                            x = sums[kernel]
                            row = {"kernel": kernel, "round": rnd, "flush": how, "page": page,
                                   "bytes": nbytes[kernel],
                                   "torch_sum_ms": time_ms(lambda: x.sum(), flush),
                                   "empty_launch_ms": time_ms(lambda: torch.cuda._sleep(0),
                                                              flush)}
                            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                                km._lib = libs[key]
                                i, name = key
                                row[f"{i}:{name}_ms"] = time_ms(calls[(kernel, page)], flush)
                            print(json.dumps(row), flush=True)
        finally:
            km._lib = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


def _pool_tiers(cache, page: int, gen):
    """The K and V tiers' pool leaves and the page table of the dense
    cache's pages scattered into a pool of B * L / page pages under a
    shuffled table."""
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
    leaves = lambda t: (t.payload, t.mins, t.shifts)
    return (leaves(paged.k.tiers[0]), leaves(paged.v.tiers[0])), phys


if __name__ == "__main__":
    raise SystemExit(main())
