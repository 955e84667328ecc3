"""Compression orchestration in PyTorch (port of
palu_tpu/compression/compress.py): rank search + decomposition as a pure
params -> params transform (the reference mutates an HF module tree in
place; compress.py:12-27 / decomposition.py:193-259).

Pipeline (mirrors the reference's compress.py main):
  1. rank search (uniform / fisher / fisher_uniform) under param_ratio_target
  2. per-layer decomposition of k_proj / v_proj (whiten or svd)
  3. optionally, Hadamard fusion into (VT, U) for quantization friendliness
     (core/lowrank.fuse_hadamard: the FWHT kernel on CUDA tensors)
  4. the fused o_proj for the latent-V serving path
It returns new params and a ModelConfig carrying head_wise_ranks, ready for
models/hf_io.save_checkpoint. Every tensor stays on the params' device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import lowrank
from ..models import llama
from ..models.config import ModelConfig
from . import rank_search as rs
from .fisher import calib_fisher_info, fisher_group_means
from .whiten import whiten_scale_matrices

__all__ = ["compress_params", "kv_module_names", "search_ranks"]


def kv_module_names(cfg: ModelConfig) -> List[str]:
    names = []
    for i in range(cfg.num_hidden_layers):
        names.append(f"model.layers.{i}.self_attn.k_proj")
        names.append(f"model.layers.{i}.self_attn.v_proj")
    return names


def search_ranks(params, cfg: ModelConfig, param_ratio_target: float,
                 search_method: str = "fisher_uniform", head_group_size: int = 4,
                 calib_batches: Optional[list] = None, model_id: Optional[str] = None,
                 use_cache: bool = True) -> Dict[str, List[int]]:
    """Run the configured rank search; returns {module_name: per-group ranks}.

    Fisher matrices are cached per model id under $PALU_CACHE_DIR (default
    `cache`) as the JAX package's .npz (the reference caches
    cache/{model}_calib_fisher_info.pt, rank_search.py:40-51)."""
    names = kv_module_names(cfg)
    fisher_means = None
    if search_method in ("fisher", "fisher_uniform"):
        cache_file = None
        if model_id and use_cache:
            cache_dir = os.environ.get("PALU_CACHE_DIR", "cache")
            cache_file = os.path.join(
                cache_dir, f"{model_id.replace('/', '_')}_calib_fisher_info.npz")
        if cache_file and os.path.exists(cache_file):
            data = np.load(cache_file)
            fisher = {k: data[k] for k in data.files}
        else:
            if calib_batches is None:
                raise ValueError(f"{search_method} needs calibration data")
            fisher = calib_fisher_info(params, cfg, calib_batches)
            if cache_file:
                os.makedirs(os.path.dirname(cache_file), exist_ok=True)
                np.savez(cache_file, **{k: v.cpu().numpy() for k, v in fisher.items()})
        groups = cfg.num_key_value_heads // head_group_size if search_method == "fisher" else 1
        fisher_means = fisher_group_means(fisher, groups)
    select, rank_sum, total_rank = rs.rank_search(
        cfg, names, param_ratio_target, search_method=search_method,
        head_group_size=head_group_size, fisher_means=fisher_means)
    ratio = 100 - rank_sum / total_rank * 100
    print(f"[rank search] KV-cache compression ratio: {ratio:.2f}%")
    return select


def compress_params(params, cfg: ModelConfig, selection: Dict[str, List[int]],
                    decompose_method: str = "whiten", head_group_size: int = 4,
                    calib_batches: Optional[list] = None,
                    whiten_scales: Optional[List[torch.Tensor]] = None,
                    hadamard: bool = False, dtype=torch.float32):
    """Decompose the selected projections. Returns (new_params, new_cfg);
    the decomposition runs in f32 and the factors are stored in `dtype`."""
    if decompose_method not in ("whiten", "svd"):
        raise ValueError(decompose_method)
    if decompose_method == "whiten" and whiten_scales is None:
        if calib_batches is None:
            raise ValueError("whiten needs calibration data")
        whiten_scales = whiten_scale_matrices(params, cfg, calib_batches)

    new_layers = []
    for i, layer in enumerate(params["layers"]):
        attn = dict(layer["attn"])
        for which in ("k_proj", "v_proj"):
            name = f"model.layers.{i}.self_attn.{which}"
            if name not in selection:
                continue
            ranks = selection[name]
            p = attn[which]
            if "w" not in p:
                raise ValueError(f"{name} already compressed")
            w = p["w"].float().T  # (out, in)
            bias = p.get("b")
            if decompose_method == "whiten":
                lr = lowrank.decompose_whiten(w, whiten_scales[i], ranks, bias)
            else:
                lr = lowrank.decompose_svd(w, ranks, bias)
            if hadamard:
                lr = lowrank.fuse_hadamard(lr)
            attn[which] = _to_params(lr, dtype)
        if "VT" in attn["v_proj"] and not llama.is_ragged(attn["v_proj"]):
            attn["o_proj"] = dict(attn["o_proj"])
            attn["o_proj"]["w_fused"] = llama.fuse_o_proj(
                attn["o_proj"]["w"].float(), attn["v_proj"]["U"].float(),
                dataclasses.replace(cfg, head_group_size=head_group_size)).to(dtype)
        new_layers.append({**layer, "attn": attn})

    new_cfg = dataclasses.replace(cfg, head_wise_ranks=dict(selection),
                                  head_group_size=head_group_size)
    return {**params, "layers": new_layers}, new_cfg


def _to_params(lr: lowrank.LowRankWeights, dtype):
    p = {"VT": lr.VT.T.to(dtype).contiguous()}  # (in, sum_ranks)
    if len(set(lr.ranks)) == 1:
        # uniform ranks: stacked (G, r, group_dim), the runtime layout
        p["U"] = torch.stack([u.T for u in lr.U]).to(dtype)
    else:
        # ragged ranks (fisher search): per-group (r_i, group_dim) matrices
        # (reference svd_linear.py:72-78); the accuracy forward takes them,
        # the Engine pads them to the largest rank at build
        p["U"] = tuple(u.T.to(dtype).contiguous() for u in lr.U)
    if lr.bias is not None:
        p["b"] = torch.stack(lr.bias).to(dtype)
    return p
