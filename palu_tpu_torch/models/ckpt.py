"""Torch-native checkpoints of (compressed) params plus the model config
(port of palu_tpu/models/ckpt.py, whose production format is orbax's).

The HF format (`hf_io.py`) is the interoperability surface with the
reference's Palu checkpoints; this is the port's own format, written and
read without renames or transposes, quantized weights included:

  <dir>/params.pt          the params tree: torch.save of CPU tensors in
                           dicts and lists, read back with
                           torch.load(weights_only=True)
  <dir>/model_config.json  ModelConfig as JSON (head_wise_ranks included),
                           written as the JAX package writes it, so a
                           config the JAX package saved loads here too
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from ..ops.build import require_cuda
from .config import ModelConfig

__all__ = ["save_native", "load_native"]

PARAMS_FILE = "params.pt"
CONFIG_FILE = "model_config.json"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def save_native(save_dir: str, params: Any, cfg: ModelConfig) -> None:
    """Write `params` (every tensor copied to the CPU as it is: dtype,
    quantized codes and scales unchanged) and the model config."""
    os.makedirs(save_dir, exist_ok=True)
    torch.save(_tree_map(lambda t: t.detach().cpu().contiguous(), params),
               os.path.join(save_dir, PARAMS_FILE))
    with open(os.path.join(save_dir, CONFIG_FILE), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def load_native(save_dir: str, device=None, dtype: Optional[torch.dtype] = None) -> tuple:
    """(params, cfg) from `save_dir`, every tensor on `device` (the card
    unless the caller asks for another; raises without CUDA). `dtype`, when
    given, casts the floating-point tensors after loading; integer codes
    keep their type."""
    dev = require_cuda("cuda" if device is None else device)
    with open(os.path.join(save_dir, CONFIG_FILE)) as f:
        cfg = ModelConfig(**json.load(f))
    params = torch.load(os.path.join(save_dir, PARAMS_FILE), map_location="cpu",
                        weights_only=True)

    def place(t: torch.Tensor) -> torch.Tensor:
        t = t.to(dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return _tree_map(place, params), cfg
