"""Whitening calibration in PyTorch (port of
palu_tpu/compression/whiten.py): per-layer input Gram matrices -> Cholesky
factors.

Reference semantics (palu/decomposition.py:20-191, adapted from SVD-LLM):
run the calibration batches through the model one layer at a time; for
each layer accumulate X^T X over the inputs k_proj / v_proj see, which is
exactly the post-input-norm hidden state; Cholesky-factor the Gram in f64
with an eigenvalue-shift repair when it is not positive definite. The Gram
accumulates in f32 on the params' device and the Cholesky runs there in
f64 (core/lowrank.cholesky_with_psd_repair).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..core.lowrank import cholesky_with_psd_repair
from ..models import llama
from ..models.config import ModelConfig

__all__ = ["whiten_scale_matrices"]


def _cache_file(model_id: Optional[str], use_cache: bool) -> Optional[str]:
    if not (model_id and use_cache):
        return None
    cache_dir = os.path.join(os.environ.get("PALU_CACHE_DIR", "cache"), "whiten")
    return os.path.join(cache_dir, f"{model_id.replace('/', '_')}_scaling_matrices.npz")


@torch.no_grad()
def whiten_scale_matrices(params, cfg: ModelConfig, batches: List[np.ndarray],
                          model_id: str = None, use_cache: bool = True) -> List[torch.Tensor]:
    """One f32 Cholesky scale matrix S (hidden, hidden) per layer, on the
    params' device (shared by the layer's k_proj and v_proj, which see the
    same inputs). Cached per model id as an .npz with keys l_{i}, the JAX
    package's file (the reference's cache/whiten/*.pt, decomposition.py:31),
    so either package reads the other's."""
    dev = params["embed"].device
    cache_file = _cache_file(model_id, use_cache)
    if cache_file and os.path.exists(cache_file):
        data = np.load(cache_file)
        return [torch.from_numpy(data[f"l_{i}"]).to(dev)
                for i in range(cfg.num_hidden_layers)]

    # stream: keep every batch's activations, advance one layer at a time
    # (decomposition.py:122-186 does the same with inps/outs buffers)
    acts = [params["embed"][torch.as_tensor(b, device=dev).long()] for b in batches]
    scales = []
    for layer in params["layers"]:
        gram = None
        for j, x in enumerate(acts):
            h = llama.rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
            hf = h.float().reshape(-1, h.shape[-1])
            g = hf.T @ hf
            gram = g if gram is None else gram + g
            b, s, _ = x.shape
            positions = torch.arange(s, device=dev)[None, :].expand(b, s)
            mask = llama._causal_mask(s, s, torch.float32, dev, cfg.sliding_window)
            acts[j] = llama.decoder_layer(x, layer, cfg, positions, mask)
        scales.append(cholesky_with_psd_repair(gram))
    if cache_file:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        np.savez(cache_file, **{f"l_{i}": s.cpu().numpy() for i, s in enumerate(scales)})
    return scales
