"""Build and load the port's CUDA kernels.

Each source `palu_tpu_torch/csrc/<name>.cu` exposes a plain C interface and
compiles with nvcc into its own shared library under
`palu_tpu_torch/_build/`, named by a hash of the source and of the shared
headers (`csrc/*.cuh`), so an edited source rebuilds and an unchanged one
loads at once. The libraries load with
ctypes. Sources build at first use; `build_all` builds several at once, one
nvcc process per source, all started together. A missing nvcc or a failed
build raises. Flags: `-gencode arch=compute_90a,code=sm_90a -O3`, never
`--use_fast_math` (the append kernel must round as quantize_affine does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["SOURCES", "build_all", "load", "launcher", "check", "require_cuda", "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("cache_append", "palu_decode_exact", "palu_decode_i8", "palu_decode_fp_wg",
           "prefill_flash", "gemv_int4", "gemv_int8", "hadamard", "stream_probe", "unpack_probe",
           "gemv_bf16", "mlp_a8")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every named source that has no library yet, in parallel.
    Returns {name: seconds from the start until its nvcc ended} for the
    sources built; each build's compiler output (with ptxas' register and
    shared-memory report) is kept beside its library as `<lib>.log`."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        with open(out.with_suffix(".log"), "w") as log:
            procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out)
    times, errors = {}, []
    while len(times) < len(procs):
        for n, (proc, tmp, out) in procs.items():
            if n in times or proc.poll() is None:
                continue
            times[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                log = out.with_suffix(".log").read_text()
                errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def launcher(source: str, name: str, sig: str):
    """The C launcher `name` of csrc/<source>.cu, returning a cudaError_t;
    `sig` spells its arguments: p a pointer (or the stream), i an int, f a
    float."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[t] for t in sig]
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_cuda(device) -> torch.device:
    """The torch.device for `device`; raises when CUDA is asked for and
    absent (the port never quietly falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of `device` as a raw cudaStream_t, in one C
    call (torch.cuda.current_stream builds a Stream object first)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)
