"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers are compiled, so a build takes seconds.  Libraries go to
``gscream_tpu_torch/build/`` (git-ignored), named by a hash of the
source, the ``csrc/`` headers it includes and the flags, each beside the
build's log under the same name, and are built at first use;
:func:`build` compiles several sources in parallel, one ``nvcc`` process
each.

Nothing here runs at import: the CPU tests import every module, and the
CPU has neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# per-source extra flags.  emission.cu must round after every operation,
# exactly as PyTorch's one-op-per-kernel elementwise math does, so that it
# is bit-equal to its plain version: no FMA contraction, IEEE sqrt and
# division (nvcc's defaults for the latter two; no --use_fast_math).
SOURCES = {
    "emission": ("emission.cu", ["-fmad=false", "-prec-div=true",
                                 "-prec-sqrt=true"]),
    "rasterize_fwd": ("rasterize_fwd.cu", []),
    "rasterize_bwd": ("rasterize_bwd.cu", []),
    "shuffle": ("shuffle.cu", []),
    "segreduce": ("segreduce.cu", []),
    "attention": ("attention.cu", []),
}

_ARG_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, object] = {}


def nvcc() -> str:
    path = os.environ.get("CUDACXX") or shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: set CUDACXX or put the CUDA "
                           "toolkit's bin directory on PATH")
    return path


def _flags(name: str):
    return ARCH + BASE_FLAGS + SOURCES[name][1]


def included(src: Path) -> list:
    """The ``csrc/`` headers ``src`` includes by ``#include "..."``,
    directly or through another of them, in a fixed order."""
    seen, todo = [], [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC / inc
            if path.exists() and path not in seen:
                seen.append(path)
                todo.append(path)
    return sorted(seen)


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers it
    includes and the flags: an edit to any of them builds it anew."""
    src = CSRC / SOURCES[name][0]
    h = hashlib.sha256(src.read_bytes())
    for header in included(src):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile the libraries that are missing, all in parallel.  Returns
    {name: seconds} for each source compiled now; raises with the
    compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc()] + _flags(name) + ["-o", str(tmp),
                                         str(CSRC / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {SOURCES[name][0]} failed "
                          f"(rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def build_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` output of the build of the library
    :func:`library_path` names: its log is named by the same hash."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, signature: str):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared: ``signature`` has one letter per argument, "p" for a
    pointer or the stream, "i" for an int, "f" for a float.  Every entry
    returns the launch's ``cudaError_t`` as an int."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = [_ARG_TYPES[c] for c in signature]
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (``None`` entries match any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{rc}")
