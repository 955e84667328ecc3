"""Carry parameters and configs from the JAX package to the port.

The JAX package's params are a pytree of dicts and lists with array leaves;
`jax.tree.map(np.asarray, params)` turns it into numpy leaves, which
`params_from_numpy` turns into the port's tree of tensors (same keys, same
layouts; ragged U tuples stay tuples). `config_from_dict` takes
`dataclasses.asdict` of a JAX ModelConfig, and `lowrank_from_numpy` the
fields of a JAX LowRankWeights. None of them imports JAX: the caller hands
over numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.lowrank import LowRankWeights
from .models.config import ModelConfig
from .ops.build import require_cuda

__all__ = ["params_from_numpy", "config_from_dict", "lowrank_from_numpy"]


# f32 scales of quantized weights (core/wquant), kept f32 whatever `dtype`
_SCALE_KEYS = ("ws", "es")


def params_from_numpy(tree: Any, device="cuda", dtype=None) -> Any:
    """Map numpy leaves to tensors on `device`; floating leaves are cast to
    `dtype` when given, except the f32 scales of quantized weights ("ws",
    "es"); integer leaves (quantized codes) keep their type. None stays
    None."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, None if k in _SCALE_KEYS else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    if tree is None:
        return None
    arr = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    """The port's ModelConfig from the fields of a JAX ModelConfig."""
    return ModelConfig(**d)


def lowrank_from_numpy(VT, U_list, ranks, bias=None, device="cuda") -> LowRankWeights:
    """The port's LowRankWeights from a JAX LowRankWeights' fields (numpy
    VT (sum(ranks), in), per-group U (group_dim, r_g), ranks, bias), on the
    card unless `device` asks for another; raises when CUDA is asked for and
    absent."""
    device = require_cuda(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return LowRankWeights(VT=t(VT), U=[t(u) for u in U_list], ranks=list(ranks),
                          bias=None if bias is None else [t(b) for b in bias])
