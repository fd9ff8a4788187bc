"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

This replaces only the TPU compiler plumbing of the JAX package
(``repro/kernels/pallas_utils.py::tpu_params``); it has no other
counterpart. Each library is one ``.cu`` file under ``csrc/`` with a plain
C interface, compiled for ``sm_90a`` into ``build/`` beside this package
(listed in ``.gitignore``). The output name carries a hash of every source
and header plus the flags, so an edited source builds anew at its first
use and an unchanged one loads the library already built. Nothing is
compiled when a module is imported: only ``load`` and ``build_all`` run
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name -> its translation unit under csrc/
LIBRARIES = {"packed_attention": "packed_attention.cu",
             "tier_matvec": "tier_matvec.cu"}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Where library ``name`` is built for the current sources and flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every library not yet built, one ``nvcc`` per source, all
    started together. Returns {name: compiler log} for those compiled;
    raises with the compiler's output if any fails."""
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / LIBRARIES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0]
        logs[name] = log
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name as ``name<args>`` (``_Z17vpack_span_kernel
    ILb0ELi2ELi1EE...`` -> ``vpack_span_kernel<false,2,1>``): its bool and
    int template arguments only, which is all the kernels here take."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    t = re.match(r"I((?:L[bi]-?\d+E)+)E", rest)
    if not t:
        return name
    args = [("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([bi])(-?\d+)E", t.group(1))]
    return f"{name}<{','.join(args)}>"


def ptxas_usage(log: str) -> dict[str, dict]:
    """Registers per thread and bytes of spill stores of each kernel of
    an ``-Xptxas -v`` log, keyed by ``kernel_name``: {name: {"regs": r,
    "spill_bytes": s}}."""
    usage, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = kernel_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = {"regs": int(m.group(1)), "spill_bytes": spill}
            fn = None
    return usage


def built_usage(name: str) -> dict[str, dict]:
    """``ptxas_usage`` of library ``name`` as built for the current
    sources ({} before it is built)."""
    log = lib_path(name).with_suffix(".log")
    return ptxas_usage(log.read_text()) if log.exists() else {}
