"""Weight access helpers (port of the 16-bit branch of
palu_tpu/core/wquant.py).

Weights are plain tensors stored (in_features, out_features), so a
projection reads `x @ w`. The JAX package also stores int8/int4 weights as
{"wq8"|"wq4", "ws"} dicts with GEMV kernels of their own; those come with
a later slice of the port and raise here.
"""

from __future__ import annotations

import torch

__all__ = ["wdot", "embed_rows", "tied_head"]

_LATER = ("quantized weights (int8/int4 with their GEMV kernels) are not "
          "ported yet; they come with the port's weight-quantization slice")


def _check_plain(w) -> None:
    if isinstance(w, dict):
        raise NotImplementedError(_LATER)


def wdot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w over the last axis of x."""
    _check_plain(w)
    return x @ w


def embed_rows(emb, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token-id lookup in the embedding table."""
    _check_plain(emb)
    return emb[ids].to(dtype)


def tied_head(params):
    """The lm_head operand for wdot: the explicit head if present, else the
    embedding table transposed (weight tying)."""
    if params.get("lm_head") is not None:
        return params["lm_head"]
    _check_plain(params["embed"])
    return params["embed"].T
