"""Where K2's time goes on the card: the kernel with parts of it cut out.

  PYTHONPATH=src python -m repro_torch.launch.k2_breakdown [--source FILE ...]

Builds ``csrc/packed_attention.cu`` as committed (or each ``--source``,
beside the headers of its own directory: an older copy of ``csrc/`` times
an earlier version in the same process) and four variants of it,
each with one more part removed by a text edit of the source (the
variants compute wrong values; only their times mean anything):

  full        the kernel as committed
  no_merge    without the last block's merge of the row's spans
  no_v        ... and without the V decode
  copies_only ... and without the scores: copies, softmax, partials
  empty       every block exits at once

and times each at the decode shape of ``chip_smoke.py``'s kernel phase
(B=4, H_kv=32, G=1, D=128, a 2048-token bucket, live counts {0, 64, 1344,
2048}, K and V one 4-bit tier of 128 channels, pack 8) the way it times
kernels (L2 flushed, a spin kernel ahead, median of 20), in turns, beside
two yardsticks: ``torch.sum`` over a contiguous f32 tensor of as many
bytes as K2 must move, and an empty launch. The L2 is flushed as
``chip_smoke.py`` flushes it, by writing 64 MB; ``--flush read`` reads
them instead, so the timed run finds no dirty lines to write back.
Prints one JSON line per round and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..core import cache as tc
from ..core.tiered import TierSpec
from ..kernels import build
from ..kernels import packed_attention as pa

_V_LOOP = ("  for (int t = 0; t < p.nv; ++t) {\n    const char* pay = smem + lay.v_pay[t];",
           "  for (int t = 0; t < 0; ++t) {\n    const char* pay = smem + lay.v_pay[t];")
_K_LOOP = ("  if (live) {\n    int off = 0;\n    for (int t = 0; t < p.nk; ++t) {",
           "  if (false) {\n    int off = 0;\n    for (int t = 0; t < p.nk; ++t) {")
_MERGE = ("  merge_row(p, row, b, h, nsp, static_cast<int>(gridDim.y), s_part, s_z);\n", "")
_EXIT = ("  if (s0 >= n) {  // a dead span", "  if (true) {  // a dead span")
VARIANTS = {"full": [], "no_merge": [_MERGE], "no_v": [_MERGE, _V_LOOP],
            "copies_only": [_MERGE, _V_LOOP, _K_LOOP], "empty": [_EXIT]}


def build_variants(src: Path, variants: dict, out: Path) -> dict[str, Path]:
    """Compile each variant of the CUDA source file ``src`` (its edits, as
    (old, new) pairs, applied in order) into ``out/<variant>/lib.so`` beside
    a copy of the headers of ``src``'s directory, one nvcc each, all
    started together; the ptxas log goes to ``lib.log`` beside it."""
    text = src.read_text()
    procs = {}
    for name, edits in variants.items():
        cu = text
        for old, new in edits:
            if old not in cu:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            cu = cu.replace(old, new, 1)
        d = out / name
        d.mkdir(parents=True)
        for header in src.parent.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "kernel.cu").write_text(cu)
        cmd = [build.nvcc(), *build.FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
               str(d / "kernel.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        (out / name / "lib.log").write_text(log)  # ptxas: registers, spills
        libs[name] = out / name / "lib.so"
    return libs


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.packed_attention_params_size.restype = ctypes.c_int
    lib.packed_attention_span.restype = ctypes.c_int
    for fn in (lib.packed_attention_launch, lib.packed_attention_paged_launch):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def time_ms(fn, flush, reps: int = 20) -> float:
    """chip_smoke.time_ms: median over reps, L2 flushed, ~2 ms spin first."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", type=Path,
                    help="a packed_attention.cu to time, built beside the headers of "
                         "its directory (repeatable; default: csrc/)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_breakdown times CUDA kernels: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    spec = TierSpec((4,), (128,), 8)
    B, h_kv, D, L, lengths = 4, 32, 128, 2048, (0, 64, 1344, 2048)
    cache = tc.alloc_layer_cache(tc.PackKVConfig(k_spec_static=spec, v_spec_static=spec),
                                 B, h_kv, D, L, device=dev)
    for r, n in enumerate(lengths):
        if n:
            kv = [(torch.randn((h_kv, n, D), generator=gen, device=dev) * 2 + 1)
                  .to(torch.bfloat16) for _ in range(2)]
            tc.insert_prefill(cache, r, *kv)
    q = torch.randn((B, h_kv, D), generator=gen, device=dev)
    # K2's bytes (chip_smoke.kernel_bytes at this shape), as one f32 tensor
    live = sum(lengths) * h_kv
    per_tok = 2 * 128 * (4 / 8 + 1 / 8 + 1 / 32) + 16
    nbytes = int(live * per_tok) + B * h_kv * (2 * D * 4 + D * 4 + D * 4 + 8)
    x = torch.randn(nbytes // 4, generator=gen, device=dev)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_ if args.flush == "write" else flush_buf.max
    call = lambda: pa.fused_packed_attention(q, cache.k, cache.v, cache.n_comp, D ** -0.5)
    sources = args.source or [build.CSRC / "packed_attention.cu"]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor() as pool:
        built = pool.map(lambda i: build_variants(sources[i], VARIANTS, Path(tmp) / str(i)),
                         range(len(sources)))
        libs = {f"{i}:{name}" if len(sources) > 1 else name: _bind(path)
                for i, paths in enumerate(built) for name, path in paths.items()}
        saved = pa._lib
        try:
            for rnd in range(args.rounds):
                row = {"round": rnd, "flush": args.flush, "bytes": nbytes,
                       "torch_sum_ms": time_ms(lambda: x.sum(), flush),
                       "empty_launch_ms": time_ms(lambda: torch.cuda._sleep(0), flush)}
                for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
                    pa._lib = libs[name]
                    row[f"{name}_ms"] = time_ms(call, flush)
                print(json.dumps(row), flush=True)
        finally:
            pa._lib = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
