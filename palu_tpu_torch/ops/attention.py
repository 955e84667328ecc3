"""Attention in plain PyTorch: the one-shot prefill's causal MHA (port of
mha_prefill, palu_tpu/ops/attention.py; the CPU route of the engine's
one-shot prefill, whose CUDA route is the ops/prefill_flash kernel), and
decode attention over the latent cache (port of
flash_decode_latent; the plain version the
decode kernels are held against) and over dense roped K/V (port of the JAX
engine's _dense_flash_decode, the reference's dense-KV baseline; on CUDA
the engine runs it as one scaled_dot_product_attention call instead, which
chip_smoke.py holds against this plain version).

The sequence-parallel decodes (flash_decode_latent_seq_sharded over the
seq-major bf16 cache, flash_decode_latent_seq_sharded_rank_major over the
rank-major caches) run on one process of a mesh with a `seq` axis
(parallel/mesh.py): its cache holds S_local columns at absolute positions
[index * S_local, ...), it decodes them with pos_offset and return_stats,
and seq_combine merges the shards' statistics over the axis's process
group, as JAX's shard_map does with pmax / psum: all_reduce(MAX) of m,
then one all_reduce(SUM) of l * e^(m - m_g) and acc * e^(m - m_g)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["mha_prefill", "flash_decode_latent", "dense_flash_decode", "dense_decode_sdpa", "seq_combine",
           "flash_decode_latent_seq_sharded", "flash_decode_latent_seq_sharded_rank_major"]


def _inv_freq(head_dim: int, rope_theta: float, inv_freq, device) -> torch.Tensor:
    if inv_freq is None:
        return 1.0 / (rope_theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
            / head_dim))
    return torch.as_tensor(np.asarray(inv_freq, np.float32), device=device)


def mha_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                sliding_window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """Causal multi-head attention of roped q (B, Sq, nh, hd) over roped k
    and v (B, Sk, nkv, hd) -> (B, Sq, nh * hd) in q's dtype. Query row i
    sits at position q_offset + i and sees keys p <= q_offset + i (and p >
    q_offset + i - sliding_window with a window); GQA repeats each kv head
    over its nh / nkv q-heads. As in JAX: f32 logits, softmax, then the
    probabilities rounded to q's dtype before the product with V."""
    b, sq, nh, hd = q.shape
    nkv, sk = k.shape[2], k.shape[1]
    if nh != nkv:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    keep = k_pos <= q_pos
    if sliding_window is not None:
        keep &= k_pos > q_pos - sliding_window
    logits = torch.where(keep, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))
    return out.reshape(b, sq, nh * hd)


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
    k_bias: Optional[torch.Tensor] = None,  # (G, hpg, hd) pre-RoPE K bias (Qwen2)
    pos_offset: int = 0,  # absolute position of chunk 0 (a sequence shard's start)
    return_stats: bool = False,
):
    """Latent decode attention -> (B, nh, rv) latent-space output, f32.

    One pass over the cache with an online softmax: per chunk, rebuild the
    K block (latent @ B, plus k_bias in f32 before RoPE: Qwen2's K = lat @
    U + b), apply RoPE at absolute positions pos_offset + column, and
    accumulate (m, l, acc); kv_len stays absolute. Matmul operands are
    rounded to q's dtype and accumulated in f32; softmax statistics are
    f32. return_stats returns the raw statistics instead, m (B, G, hpg), l
    (B, G, hpg) and the unnormalised acc (B, G, hpg, rv), as a sequence
    shard hands them to the cross-shard combine: a shard with no valid
    column keeps m = -1e30, l = 0 and acc = 0."""
    b, nh, hd = q.shape
    g, hpg = b_k.shape[0], b_k.shape[1]
    dev = q.device
    cdt = q.dtype
    q_g = q.reshape(b, g, hpg, hd).float()
    b_kc = b_k.to(cdt).float()
    inv = _inv_freq(head_dim, rope_theta, inv_freq, dev)
    half = hd // 2
    kv_len = kv_len.to(dev)
    kb = None if k_bias is None else k_bias.float().to(dev)[None, :, :, None, :]

    m = torch.full((b, g, hpg), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, g, hpg), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, g, hpg, rv), dtype=torch.float32, device=dev)
    for idx in range(num_chunks):
        xk = read_k_chunk(idx).to(cdt).float()  # (B, G, C, rk)
        xv = read_v_chunk(idx).to(cdt).float()  # (B, G, C, rv)
        kblk = torch.einsum("bgcr,ghrd->bghcd", xk, b_kc)
        if kb is not None:
            kblk = kblk + kb
        pos = pos_offset + idx * chunk + torch.arange(chunk, device=dev)
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
    if return_stats:
        return m, l, acc
    return (acc / l[..., None]).reshape(b, nh, rv)


def _valid(kv_len: torch.Tensor, pos: torch.Tensor, sliding_window: Optional[int]):
    """(B, C) bool: positions pos inside each lane's live (windowed) context."""
    kvl = kv_len.to(pos.device).long()[:, None]
    valid = pos[None, :] < kvl
    if sliding_window is not None:
        valid &= pos[None, :] > (kvl - 1) - sliding_window
    return valid


def dense_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor, chunk: int,
                       sliding_window: Optional[int] = None) -> torch.Tensor:
    """Decode attention of q (B, nh, hd), roped at the current position,
    over roped K and V (B, n_kv, S, hd) in f32 chunks of `chunk` positions
    with an online softmax (GQA: each kv head serves nh / n_kv q-heads).
    -> (B, nh, hd) f32."""
    b, nh, hd = q.shape
    nkv, s_max = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, nkv, nh // nkv, hd)
    m = torch.full(qg.shape[:3], -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for c0 in range(0, s_max, chunk):
        kb, vb = k[:, :, c0:c0 + chunk].float(), v[:, :, c0:c0 + chunk].float()
        logits = torch.einsum("bgrd,bgcd->bgrc", qg, kb) / math.sqrt(hd)
        valid = _valid(kv_len, torch.arange(c0, c0 + kb.shape[2], device=q.device),
                       sliding_window)[:, None, None, :]
        logits = torch.where(valid, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(logits - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrc,bgcd->bgrd", p, vb)
        m = m_new
    return (acc / l[..., None]).reshape(b, nh, hd)


def dense_decode_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, sliding_window: Optional[int] = None
                      ) -> torch.Tensor:
    """dense_flash_decode as one scaled_dot_product_attention call: each kv
    head's nh / n_kv q-heads enter as its query rows, a (B, 1, 1, S) mask
    keeps the live positions. -> (B, nh, hd) in K's dtype."""
    b, nh, hd = q.shape
    nkv, s_max = k.shape[1], k.shape[2]
    mask = _valid(kv_len, torch.arange(s_max, device=q.device), sliding_window)
    out = torch.nn.functional.scaled_dot_product_attention(
        q.to(k.dtype).reshape(b, nkv, nh // nkv, hd), k, v, attn_mask=mask[:, None, None, :])
    return out.reshape(b, nh, hd)


def seq_combine(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, group) -> torch.Tensor:
    """Merge the sequence shards' statistics, acc (B, nh, rv) unnormalised,
    m and l (B, nh), over `group`: every process gets
    sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s. A
    shard with no valid column (m = -1e30, l = 0) weighs 0."""
    import torch.distributed as dist

    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - m_g)
    la = torch.cat([(l * w)[..., None], acc * w[..., None]], dim=-1)
    dist.all_reduce(la, op=dist.ReduceOp.SUM, group=group)
    return la[..., 1:] / la[..., :1]


def flash_decode_latent_seq_sharded(
    q: torch.Tensor,  # (B, nh, hd) roped, the same on every shard
    x_k: torch.Tensor,  # (B, G, S_local, rk): this shard's columns
    x_v: torch.Tensor,  # (B, G, S_local, rv)
    b_k: torch.Tensor,  # (G, hpg or hpg / rep, rk, hd)
    kv_len: torch.Tensor,  # (B,) absolute lengths
    mesh,
    axis: str,
    chunk: int,
    head_dim: int,
    rope_theta: float,
    sliding_window: Optional[int] = None,
    inv_freq=None,
    rope_scale: float = 1.0,
    k_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel decode over the seq-major latent cache: this
    shard's flash statistics over its S_local columns at absolute
    positions, merged over the mesh axis `axis` (seq_combine). As in JAX,
    plain PyTorch (XLA there): no kernel serves this layout's shards.
    k_bias (Qwen2) is added before RoPE as in flash_decode_latent (JAX's
    engine sends that case to its unsharded XLA fallback, which computes
    the same). -> (B, nh, rv) f32."""
    from ..parallel.mesh import axis_group
    from .palu_decode import _expand

    group, idx, _ = axis_group(mesh, axis)
    b, nh, _ = q.shape
    s_local, rv = x_k.shape[2], x_v.shape[3]
    b_k, k_bias = _expand(q, b_k, k_bias)  # the compact form, one B per kv-head
    if s_local % chunk:
        raise ValueError(f"chunk {chunk} must divide the shard's {s_local} columns")
    m, l, acc = flash_decode_latent(
        q, lambda i: x_k[:, :, i * chunk:(i + 1) * chunk],
        lambda i: x_v[:, :, i * chunk:(i + 1) * chunk], b_k, s_local // chunk, chunk, kv_len,
        head_dim, rope_theta, rv, sliding_window, inv_freq=inv_freq, rope_scale=rope_scale,
        k_bias=k_bias, pos_offset=idx * s_local, return_stats=True)
    return seq_combine(acc.reshape(b, nh, rv), m.reshape(b, nh), l.reshape(b, nh), group)


def flash_decode_latent_seq_sharded_rank_major(
    q: torch.Tensor,  # (B, nh, hd) roped, the same on every shard
    k_bufs,  # this shard's rank-major buffers: codes_t / scale_t [/ zero_t] or lat_t,
    v_bufs,  # sequence on the last axis (S_local columns)
    b_k: torch.Tensor,  # (G, hpg or hpg / rep, rk, hd)
    kv_len: torch.Tensor,  # (B,) absolute lengths
    mesh,
    axis: str,
    *,
    qcfg,  # QuantConfig (packed cache) or None (bf16 lat_t)
    rk: int,
    rv: int,
    block_s: int,
    theta: float,
    sliding_window: Optional[int] = None,
    inv_freq=None,
    rope_scale: float = 1.0,
    k_bias: Optional[torch.Tensor] = None,
    kernel_knobs: Optional[dict] = None,  # int8_dots / int8_rot for the packed decode
) -> torch.Tensor:
    """Sequence-parallel decode over a rank-major cache, packed or bf16:
    this shard's decode kernel (palu_decode / palu_decode_fp_t; their plain
    versions on CPU tensors) with pos_offset = index * S_local and
    return_stats, then seq_combine over the mesh axis. The rotation block
    shrinks until it divides S_local, as in JAX. -> (B, nh, rv) f32."""
    from ..parallel.mesh import axis_group
    from .palu_decode import palu_decode
    from .palu_decode_fp import palu_decode_fp_t

    group, idx, _ = axis_group(mesh, axis)
    leaf = "lat_t" if qcfg is None else "codes_t"
    s_local = k_bufs[leaf].shape[-1]
    bs = max(1, min(block_s, s_local))
    while s_local % bs:
        bs -= 1
    common = dict(theta=theta, sliding_window=sliding_window, inv_freq=inv_freq,
                  rope_scale=rope_scale, k_bias=k_bias, pos_offset=idx * s_local,
                  return_stats=True)
    if qcfg is None:
        acc, m, l = palu_decode_fp_t(q, b_k, k_bufs["lat_t"], v_bufs["lat_t"], kv_len, **common)
    else:
        acc, m, l = palu_decode(
            q, b_k, k_bufs["codes_t"], k_bufs["scale_t"], v_bufs["codes_t"], v_bufs["scale_t"],
            kv_len, qcfg=qcfg, rk=rk, rv=rv, xk_zero=k_bufs.get("zero_t"),
            xv_zero=v_bufs.get("zero_t"), block_s=bs, **(kernel_knobs or {}), **common)
    return seq_combine(acc, m, l, group)
