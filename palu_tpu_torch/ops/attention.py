"""Attention over the latent cache in plain PyTorch (port of
flash_decode_latent, palu_tpu/ops/attention.py). This is the plain version
that the decode kernel (ops/palu_decode.py) is held against."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["flash_decode_latent"]


def _inv_freq(head_dim: int, rope_theta: float, inv_freq, device) -> torch.Tensor:
    if inv_freq is None:
        return 1.0 / (rope_theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
            / head_dim))
    return torch.as_tensor(np.asarray(inv_freq, np.float32), device=device)


def flash_decode_latent(
    q: torch.Tensor,  # (B, nh, hd) -- roped at the current position
    read_k_chunk,  # fn(chunk_idx) -> (B, G, C, rk) latents (dequantized)
    read_v_chunk,  # fn(chunk_idx) -> (B, G, C, rv) latents
    b_k: torch.Tensor,  # (G, hpg, rk, hd) grouped per-head reconstruction matrices
    num_chunks: int,
    chunk: int,
    kv_len: torch.Tensor,  # (B,) per-lane valid cache positions
    head_dim: int,
    rope_theta: float,
    rv: int,
    sliding_window: Optional[int] = None,
    inv_freq=None,  # (hd/2,) rope_scaling override (models/rope.py)
    rope_scale: float = 1.0,
) -> torch.Tensor:
    """Latent decode attention -> (B, nh, rv) latent-space output, f32.

    One pass over the cache with an online softmax: per chunk, rebuild the
    K block (latent @ B), apply RoPE at absolute positions, and accumulate
    (m, l, acc). Matmul operands are rounded to q's dtype and accumulated
    in f32; softmax statistics are f32."""
    b, nh, hd = q.shape
    g, hpg = b_k.shape[0], b_k.shape[1]
    dev = q.device
    cdt = q.dtype
    q_g = q.reshape(b, g, hpg, hd).float()
    b_kc = b_k.to(cdt).float()
    inv = _inv_freq(head_dim, rope_theta, inv_freq, dev)
    half = hd // 2
    kv_len = kv_len.to(dev)

    m = torch.full((b, g, hpg), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, g, hpg), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, g, hpg, rv), dtype=torch.float32, device=dev)
    for idx in range(num_chunks):
        xk = read_k_chunk(idx).to(cdt).float()  # (B, G, C, rk)
        xv = read_v_chunk(idx).to(cdt).float()  # (B, G, C, rv)
        kblk = torch.einsum("bgcr,ghrd->bghcd", xk, b_kc)
        pos = idx * chunk + torch.arange(chunk, device=dev)
        freqs = pos.float()[:, None] * inv  # (C, hd/2)
        emb = torch.cat([freqs, freqs], dim=-1)
        cos, sin = torch.cos(emb) * rope_scale, torch.sin(emb) * rope_scale
        krot = torch.cat([-kblk[..., half:], kblk[..., :half]], dim=-1)
        kblk = kblk * cos + krot * sin
        logits = torch.einsum("bghd,bghcd->bghc", q_g.to(cdt).float(),
                              kblk.to(cdt).float()) / math.sqrt(head_dim)
        valid = pos[None, :] < kv_len[:, None]  # (B, C)
        if sliding_window is not None:
            valid &= pos[None, :] > (kv_len[:, None] - 1) - sliding_window
        vmask = valid[:, None, None, :]
        # finite mask value + explicit p zeroing: -inf would give
        # exp(-inf - -inf) = nan on fully masked chunks
        logits = torch.where(vmask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(vmask, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bghc,bgcr->bghr", p.to(cdt).float(), xv)
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l[..., None]).reshape(b, nh, rv)
