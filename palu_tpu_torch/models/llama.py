"""Llama-family decoder with Palu low-rank KV projections, in PyTorch (port
of palu_tpu/models/llama.py).

Params are a plain dict tree of tensors with the JAX package's layout, so
the two packages exchange weights leaf for leaf (convert.params_from_numpy).
Weights are stored (in_features, out_features) and a projection reads
`x @ w`. Low-rank projections hold
  VT: (hidden, G * r)       x @ VT -> latents (B, S, G, r)
  U:  (G, r, group_dim)     reconstruct = einsum('bsgr,grd->bsgd')
with uniform ranks within a layer. Ragged ranks, k/v biases (Qwen2) and
the int8/int4 weight paths come with later slices of the port.

Two value paths give the same attention output:
  - "reconstruct": rebuild full V, apply probs, then dense o_proj;
  - "fused": keep V latent, probs @ v_latent per group, then the U_v-fused
    o_proj (the serving path).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.wquant import wdot
from .config import ModelConfig

Params = Dict[str, Any]

__all__ = [
    "rms_norm", "rope_cos_sin", "rope_cos_sin_for", "apply_rope",
    "project_kv", "reconstruct_kv", "attention_core", "mlp_forward",
    "forward", "init_params", "fuse_o_proj",
]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float,
    dtype=torch.float32, inv_freq=None, attn_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-Llama RoPE tables: cos/sin of shape (*positions.shape, head_dim),
    duplicated over the two halves ([f, f] layout)."""
    dev = positions.device
    if inv_freq is None:
        inv_freq = 1.0 / (theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev)
            / head_dim))
    else:
        inv_freq = torch.as_tensor(np.asarray(inv_freq, np.float32), device=dev)
    freqs = positions.float()[..., None] * inv_freq  # (..., hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return (
        (torch.cos(emb) * attn_scale).to(dtype),
        (torch.sin(emb) * attn_scale).to(dtype),
    )


def rope_cos_sin_for(cfg: ModelConfig, positions: torch.Tensor,
                     dtype=torch.float32):
    """Config-driven RoPE tables honouring cfg.rope_scaling."""
    from . import rope as rope_mod

    inv_freq, scale = rope_mod.inv_freq_and_scale(cfg)
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, dtype=dtype,
                        inv_freq=inv_freq, attn_scale=scale)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, n_heads, head_dim); cos/sin: (B, S, head_dim)."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return x * cos + rotate_half(x) * sin


# ---------------------------------------------------------------------------
# Projections (dense or uniform-rank low-rank)
# ---------------------------------------------------------------------------


def _check_uniform(proj: Params) -> None:
    if isinstance(proj["U"], (list, tuple)):
        raise NotImplementedError(
            "ragged per-group ranks are not ported yet (pad_ragged_params "
            "comes with a later slice of the port)")


def project_kv(x: torch.Tensor, proj: Params) -> torch.Tensor:
    """Dense: returns (B, S, out). Low-rank: returns latents (B, S, G, r)."""
    if "VT" in proj:
        _check_uniform(proj)
        b, s, _ = x.shape
        return wdot(x, proj["VT"]).reshape(b, s, proj["U"].shape[0], -1)
    out = wdot(x, proj["w"])
    if proj.get("b") is not None:
        out = out + proj["b"]
    return out


def reconstruct_kv(latents: torch.Tensor, proj: Params) -> torch.Tensor:
    """latents (B, S, G, r) -> (B, S, G * group_dim) via the stacked U."""
    _check_uniform(proj)
    out = torch.einsum("bsgr,grd->bsgd", latents, proj["U"])
    if proj.get("b") is not None:
        out = out + proj["b"]
    b, s, g, d = out.shape
    return out.reshape(b, s, g * d)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _causal_mask(q_len: int, kv_len: int, dtype, device,
                 sliding_window: Optional[int] = None) -> torch.Tensor:
    """(q_len, kv_len) additive mask; query i attends keys <= i + (kv_len - q_len)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    keep = k_pos <= q_pos
    if sliding_window is not None:
        keep &= k_pos > q_pos - sliding_window
    neg = torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=device)
    return torch.where(keep, torch.zeros((), dtype=dtype, device=device), neg)


def attention_core(
    q: torch.Tensor,  # (B, Sq, nh, hd) -- already roped
    k: torch.Tensor,  # (B, Sk, nkv, hd) -- already roped
    v_or_latent: torch.Tensor,  # (B, Sk, nkv, hd) dense or (B, Sk, G, rv) latent
    cfg: ModelConfig,
    mask: torch.Tensor,  # (Sq, Sk) additive
    v_is_latent: bool,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + mask) @ v, GQA-aware. With v_is_latent the
    output is (B, Sq, nh * rv) for the U_v-fused o_proj."""
    b, sq, nh, hd = q.shape
    sk = k.shape[1]
    rep = nh // cfg.num_key_value_heads

    qh = q.transpose(1, 2)  # (B, nh, Sq, hd)
    kh = k.transpose(1, 2)  # (B, nkv, Sk, hd)
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) / math.sqrt(
        cfg.head_dim)
    logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)  # (B, nh, Sq, Sk)

    if not v_is_latent:
        vh = v_or_latent.transpose(1, 2)
        if rep > 1:
            vh = vh.repeat_interleave(rep, dim=1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
        return out.transpose(1, 2).reshape(b, sq, nh * hd)

    g, rv = v_or_latent.shape[2], v_or_latent.shape[3]
    probs_g = probs.reshape(b, g, (nh // g) * sq, sk)
    lat = v_or_latent.transpose(1, 2)  # (B, G, Sk, rv)
    out = torch.einsum("bgqk,bgkr->bgqr", probs_g, lat).reshape(b, nh, sq, rv)
    return out.transpose(1, 2).reshape(b, sq, nh * rv)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def mlp_forward(x: torch.Tensor, p: Params) -> torch.Tensor:
    gate = wdot(x, p["gate"])
    up = wdot(x, p["up"])
    return wdot(F.silu(gate) * up, p["down"])


def attn_forward(x, p: Params, cfg: ModelConfig, positions, mask,
                 value_mode: str = "reconstruct") -> torch.Tensor:
    """Full-sequence (no-cache) attention of the accuracy path."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    q = x @ p["q_proj"]["w"]
    if p["q_proj"].get("b") is not None:
        q = q + p["q_proj"]["b"]
    q = q.reshape(b, s, nh, hd)

    k_raw = project_kv(x, p["k_proj"])
    v_raw = project_kv(x, p["v_proj"])
    k_lowrank = "VT" in p["k_proj"]
    v_lowrank = "VT" in p["v_proj"]

    k = reconstruct_kv(k_raw, p["k_proj"]) if k_lowrank else k_raw
    k = k.reshape(b, s, nkv, hd)

    cos, sin = rope_cos_sin_for(cfg, positions, dtype=torch.float32)
    qr = apply_rope(q.float(), cos, sin).to(x.dtype)
    kr = apply_rope(k.float(), cos, sin).to(x.dtype)

    if value_mode == "fused" and v_lowrank:
        out = attention_core(qr, kr, v_raw, cfg, mask, v_is_latent=True)
        o_w = p["o_proj"]["w_fused"]
    else:
        v = reconstruct_kv(v_raw, p["v_proj"]) if v_lowrank else v_raw
        v = v.reshape(b, s, nkv, hd)
        out = attention_core(qr, kr, v, cfg, mask, v_is_latent=False)
        o_w = p["o_proj"]["w"]
    return out @ o_w


def decoder_layer(x, p: Params, cfg: ModelConfig, positions, mask,
                  value_mode: str = "reconstruct") -> torch.Tensor:
    h = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
    x = x + attn_forward(h, p["attn"], cfg, positions, mask, value_mode)
    h = rms_norm(x, p["post_norm"], cfg.rms_norm_eps)
    return x + mlp_forward(h, p["mlp"])


def forward(params: Params, input_ids: torch.Tensor, cfg: ModelConfig,
            value_mode: str = "reconstruct") -> torch.Tensor:
    """Full forward pass -> logits (B, S, vocab): no KV cache, causal mask."""
    b, s = input_ids.shape
    dev = input_ids.device
    x = params["embed"][input_ids]
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    mask = _causal_mask(s, s, torch.float32, dev, cfg.sliding_window)
    for p_layer in params["layers"]:
        x = decoder_layer(x, p_layer, cfg, positions, mask, value_mode)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    lm_head = params["lm_head"] if params.get("lm_head") is not None else params["embed"].T
    return x @ lm_head


# ---------------------------------------------------------------------------
# Init (random weights, for tests and latency runs)
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, scale: float = 0.02) -> Params:
    """Random-init params on the generator's device. Low-rank layers are
    created for any projection named in cfg.head_wise_ranks; the U_v-fused
    o_proj (w_fused) is built so prefill and decode agree."""
    dev = generator.device

    def dense(shape):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = cfg.hidden_size

    def kv_proj(layer, which):
        rank = cfg.uniform_rank_for(layer, which)
        if rank is None:
            p = {"w": dense((h, nkv * hd))}
            if cfg.attention_bias:
                p["b"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
            return p
        g = cfg.num_kv_groups
        p = {"VT": dense((h, g * rank)), "U": dense((g, rank, cfg.group_dim))}
        if cfg.attention_bias:
            p["b"] = torch.zeros((g, cfg.group_dim), dtype=dtype, device=dev)
        return p

    layers = []
    for i in range(cfg.num_hidden_layers):
        q_p = {"w": dense((h, nh * hd))}
        if cfg.attention_bias:
            q_p["b"] = torch.zeros((nh * hd,), dtype=dtype, device=dev)
        attn = {
            "q_proj": q_p,
            "k_proj": kv_proj(i, "k_proj"),
            "v_proj": kv_proj(i, "v_proj"),
            "o_proj": {"w": dense((nh * hd, h))},
        }
        if "VT" in attn["v_proj"]:
            attn["o_proj"]["w_fused"] = fuse_o_proj(
                attn["o_proj"]["w"], attn["v_proj"]["U"], cfg).to(dtype)
        layers.append({
            "input_norm": torch.ones((h,), dtype=dtype, device=dev),
            "post_norm": torch.ones((h,), dtype=dtype, device=dev),
            "attn": attn,
            "mlp": {
                "gate": dense((h, cfg.intermediate_size)),
                "up": dense((h, cfg.intermediate_size)),
                "down": dense((cfg.intermediate_size, h)),
            },
        })
    return {
        "embed": dense((cfg.vocab_size, h)),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dtype, device=dev),
        "lm_head": None if cfg.tie_word_embeddings else dense((h, cfg.vocab_size)),
    }


def fuse_o_proj(o_w: torch.Tensor, u_v: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Fold U_v into o_proj: (nh * rv, hidden) fused weight, in fp32.

    Per q-head h served by kv head j = h // rep in group g = j // gs, the
    fused block is U_v[g, :, (j%gs)*hd:(j%gs+1)*hd] @ o_w[h*hd:(h+1)*hd, :]
    -> (rv, hidden)."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    rep = nh // nkv
    gs = cfg.head_group_size
    g, rv = u_v.shape[0], u_v.shape[1]
    hidden = o_w.shape[1]
    # (G, rv, gs*hd) -> per kv head (nkv, rv, hd) -> per q head (nh, rv, hd)
    u_kv = u_v.float().reshape(g, rv, gs, hd).permute(0, 2, 1, 3).reshape(
        g * gs, rv, hd)
    u_q = u_kv.repeat_interleave(rep, dim=0)
    blocks = torch.bmm(u_q, o_w.float().reshape(nh, hd, hidden))
    return blocks.reshape(nh * rv, hidden)
