"""Orthonormal Hadamard transform over the last dim (port of
palu_tpu/ops/pallas/fwht.py::hadamard_transform; the kernel is
csrc/hadamard.cu).

`hadamard_transform(x)` computes x @ (kron(H_K, H_m) / sqrt(n))^T over the
last dim, n = K * 2^m <= 4096 with K from core/hadamard.get_hadK, in f32,
and returns x's dtype (f32 or bf16). CUDA tensors launch one of the
kernels (a butterfly on each chunk of 2^m, then the K x K mix), as
`hadamard_plan` picks: `fwht` for K == 1 (registers, shuffles, shared
memory past a warp), `mix` for the K whose sign masks the kernel holds
(MIX_KS) at 2 <= m <= 32 (a lane per column of every chunk; in bf16 each
warp's rows copied in and out of its own shared-memory tile by bulk
copies; the mix unrolled from compile-time masks four values at a time),
`general` for the rest (one block per row, the row in shared memory).
CPU tensors run `hadamard_transform_ref`, the product with the dense
constant that the Pallas kernel multiplies by. `transpose` applies H_K^T
in the mix (core/hadamard.apply_hadamard's option). Each launch adds one
to `hadamard_transform.launches`.

The compression path reaches this wrapper through apply_hadamard, and only
with CUDA tensors: on the CPU apply_hadamard runs the JAX package's own
formulation. The CPU branch here serves direct callers (the tests).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..core.hadamard import full_hadamard_matrix, get_hadK
from . import build

__all__ = ["hadamard_transform", "hadamard_transform_ref", "hadamard_plan", "MAX_N", "MIX_KS"]

MAX_N = 4096  # kMaxN: the largest rank a G-LRD group needs is 512
# the K whose sign masks csrc/hadamard.cu holds (HadK<K>), for the mix kernel
MIX_KS = (12, 28, 36, 40, 44, 52, 60)
THREADS = 256  # kMaxThreads


@functools.lru_cache(maxsize=64)
def _dense(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(full_hadamard_matrix(n)).to(device)


@functools.lru_cache(maxsize=64)
def _table(n: int, transpose: bool, device: str) -> torch.Tensor:
    """H_K (or H_K^T) as a row-major int8 +-1 table on the device."""
    hadK, _ = get_hadK(n)
    h = hadK.T if transpose else hadK
    return torch.from_numpy(h.astype("int8").copy()).to(device)


def hadamard_plan(n: int, k: Optional[int] = None, esize: int = 4) -> dict:
    """The launch of the kernel for rows of n = K * 2^m values of esize
    bytes (4 f32, 2 bf16); the C entry `hadamard_plan` makes the same and
    the launch refuses any other: kind ("fwht", "mix", "general"), threads
    per block, rows per block (a grid of ceil(rows / rows_per_block)
    blocks) and dynamic shared bytes. Raises ValueError for n past MAX_N or
    with no known H_K."""
    if not 0 < n <= MAX_N:
        raise ValueError(f"the Hadamard kernel takes 0 < n <= {MAX_N}, got {n}")
    if esize not in (2, 4):
        raise ValueError(f"the Hadamard kernel takes f32 or bf16 values, not {esize} bytes")
    if k is None:
        _, k = get_hadK(n)
    m = n // k
    if n % k or m & (m - 1):
        raise ValueError(f"n {n} is not K {k} times a power of two")
    if k == 1 and m >= 8:
        t = m // 8
        if t > 32:
            return {"kind": "fwht", "threads": t, "rows_per_block": 1, "smem": 4 * m}
        return {"kind": "fwht", "threads": THREADS, "rows_per_block": THREADS // t, "smem": 0}
    if k in MIX_KS and 2 <= m <= 32:
        rows = (THREADS // 32) * (32 // m)
        return {"kind": "mix", "threads": THREADS, "rows_per_block": rows,
                "smem": rows * n * esize if esize == 2 else 0}  # bf16: the warps' tiles
    return {"kind": "general", "threads": min(max((n // 2 + 31) // 32 * 32, 32), THREADS),
            "rows_per_block": 1, "smem": 4 * n + k * k}


_KINDS = {"fwht": 0, "mix": 1, "general": 2}


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
    plan = hadamard_plan(n, k, x.element_size())
    rows = x.numel() // n
    xc = x.contiguous()
    if xc.data_ptr() % 16:  # the kernels read rows by 16-byte copies
        xc = xc.clone()
    out = torch.empty_like(xc)
    if rows == 0:
        return out
    table = _table(n, transpose, str(x.device)) if k > 1 and plan["kind"] == "general" else None
    err = build.launcher("hadamard", "hadamard_transform", "ppp" + "i" * 6 + "f" + "i" * 4 + "p")(
        xc.data_ptr(), None if table is None else table.data_ptr(), out.data_ptr(), rows, n,
        k, (n // k).bit_length() - 1, int(x.dtype == torch.bfloat16), int(transpose),
        1.0 / math.sqrt(n), _KINDS[plan["kind"]], plan["threads"], plan["rows_per_block"],
        plan["smem"], build.stream_ptr(x.device))
    build.check(err, "hadamard_transform")
    hadamard_transform.launches += 1
    return out


hadamard_transform.launches = 0
