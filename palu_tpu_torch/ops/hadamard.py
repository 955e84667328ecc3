"""Orthonormal Hadamard transform over the last dim (port of
palu_tpu/ops/pallas/fwht.py::hadamard_transform; the kernel is
csrc/hadamard.cu).

`hadamard_transform(x)` computes x @ (kron(H_K, H_m) / sqrt(n))^T over the
last dim, n = K * 2^m <= 4096 with K from core/hadamard.get_hadK, in f32,
and returns x's dtype (f32 or bf16). CUDA tensors launch the kernel (a
butterfly on each chunk of 2^m, then the K x K mix); CPU tensors run
`hadamard_transform_ref`, the product with the dense constant that the
Pallas kernel multiplies by. `transpose` applies H_K^T in the mix
(core/hadamard.apply_hadamard's option). Each launch adds one to
`hadamard_transform.launches`.

The compression path reaches this wrapper through apply_hadamard, and only
with CUDA tensors: on the CPU apply_hadamard runs the JAX package's own
formulation. The CPU branch here serves direct callers (the tests).
"""

from __future__ import annotations

import functools
import math

import torch

from ..core.hadamard import full_hadamard_matrix, get_hadK
from . import build

__all__ = ["hadamard_transform", "hadamard_transform_ref", "MAX_N"]

MAX_N = 4096  # kMaxN: the largest rank a G-LRD group needs is 512


@functools.lru_cache(maxsize=64)
def _dense(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(full_hadamard_matrix(n)).to(device)


@functools.lru_cache(maxsize=64)
def _table(n: int, transpose: bool, device: str) -> torch.Tensor:
    """H_K (or H_K^T) as a row-major int8 +-1 table on the device."""
    hadK, _ = get_hadK(n)
    h = hadK.T if transpose else hadK
    return torch.from_numpy(h.astype("int8").copy()).to(device)


def hadamard_transform_ref(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Plain version: x.float() @ H^T with H = full_hadamard_matrix(n) (H^T
    for transpose, since kron(H_K^T, H_m) = kron(H_K, H_m)^T), cast back."""
    h = _dense(x.shape[-1], str(x.device))
    return (x.float() @ (h if transpose else h.T)).to(x.dtype)


def hadamard_transform(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Multiply the last dim of x (..., n) by H_n / sqrt(n). CUDA tensors
    launch the kernel (f32 or bf16, n <= MAX_N); CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return hadamard_transform_ref(x, transpose)
    n = x.shape[-1]
    if n > MAX_N:
        raise ValueError(f"the Hadamard kernel takes n <= {MAX_N}, got {n}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the Hadamard kernel takes f32 or bf16, got {x.dtype}")
    _, k = get_hadK(n)  # raises ValueError for an n with no known H_K
    rows = x.numel() // n
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if rows == 0:
        return out
    table = _table(n, transpose, str(x.device)) if k > 1 else None
    err = build.launcher("hadamard", "hadamard_transform", "ppp" + "i" * 5 + "fp")(
        xc.data_ptr(), None if table is None else table.data_ptr(), out.data_ptr(), rows, n,
        k, (n // k).bit_length() - 1, int(x.dtype == torch.bfloat16), 1.0 / math.sqrt(n),
        build.stream_ptr(x.device))
    build.check(err, "hadamard_transform")
    hadamard_transform.launches += 1
    return out


hadamard_transform.launches = 0
