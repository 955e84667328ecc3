"""Fisher-information calibration for rank allocation in PyTorch (port of
palu_tpu/compression/fisher.py).

Reference semantics (palu/rank_search.py:36-84): for each calibration
batch, run forward + backward of the mean token cross-entropy; accumulate
grad(W)^2 per k/v projection weight; finally divide by the number of
batches and take the square root. Rank search then uses per-group means of
that matrix.

torch.autograd differentiates the port's plain `llama.forward` with
respect to the dense k/v weights alone (aliases of the caller's tensors
with requires_grad; nothing else is differentiated), and grad^2
accumulates in f32 on the params' device. At dense bf16 or f32 weights the
forward is torch.matmul and plain attention, so no kernel needs a
backward. A weight quantized by core/wquant would reach a GEMV kernel that
has no gradient, so quantized weights are refused.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.wquant import is_quantized_weight
from ..models import llama
from ..models.config import ModelConfig

__all__ = ["calib_fisher_info", "fisher_group_means"]


def _has_quantized(tree) -> bool:
    if isinstance(tree, dict):
        return is_quantized_weight(tree) or "eq8" in tree or \
            any(_has_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_quantized(v) for v in tree)
    return False


def calib_fisher_info(params, cfg: ModelConfig, batches: List[np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
    """{module_name: fisher matrix (out, in), f32 on the params' device}
    for every dense k/v projection; names follow the HF convention
    `model.layers.{i}.self_attn.{k,v}_proj`."""
    if _has_quantized(params):
        raise ValueError("Fisher calibration needs dense weights: a quantized weight "
                         "runs a GEMV kernel that has no gradient")
    dev = params["embed"].device
    names, leaves, layers = [], [], []
    for i, layer in enumerate(params["layers"]):
        attn = dict(layer["attn"])
        for which in ("k_proj", "v_proj"):
            if "w" in attn[which]:
                w = attn[which]["w"].detach().requires_grad_(True)
                attn[which] = {**attn[which], "w": w}
                names.append(f"model.layers.{i}.self_attn.{which}")
                leaves.append(w)
        layers.append({**layer, "attn": attn})
    p = {**params, "layers": layers}

    fisher = [torch.zeros(w.shape, dtype=torch.float32, device=dev) for w in leaves]
    for batch in batches:
        ids = torch.as_tensor(batch, device=dev).long()
        if ids.dim() == 1:
            ids = ids[None, :]
        logits = llama.forward(p, ids, cfg)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, ids[:, 1:, None])
        grads = torch.autograd.grad(nll.mean(), leaves)
        for f, g in zip(fisher, grads):
            f += g.float() ** 2
    n = max(1, len(batches))
    # the weights are (in, out); the reference's fisher is on (out, in)
    return {name: torch.sqrt(f / n).T for name, f in zip(names, fisher)}


def fisher_group_means(fisher: Dict[str, object], num_groups: int) -> Dict[str, List[float]]:
    """Per-head-group mean of each fisher matrix (rank_search.py:125-131):
    reshape (out, in) -> (G, out/G, in), mean over all but the group axis.
    Takes tensors or numpy arrays (a cached .npz)."""
    out = {}
    for name, mat in fisher.items():
        g = torch.as_tensor(mat).reshape(num_groups, -1, mat.shape[-1])
        out[name] = [float(g[i].mean()) for i in range(num_groups)]
    return out
