"""Llama-family decoder with Palu low-rank KV projections, in PyTorch (port
of palu_tpu/models/llama.py).

Params are a plain dict tree of tensors with the JAX package's layout, so
the two packages exchange weights leaf for leaf (convert.params_from_numpy).
Weights are stored (in_features, out_features) and a projection reads
`x @ w`. Low-rank projections hold
  VT: (hidden, G * r)       x @ VT -> latents (B, S, G, r)
  U:  (G, r, group_dim)     reconstruct = einsum('bsgr,grd->bsgd')
with uniform ranks within a layer, or ragged per-group ranks (the fisher
search's output) with U a tuple of (r_g, group_dim) matrices and VT
(hidden, sum r_g): the accuracy forward runs them as they are, and
`pad_ragged_params` zero-pads them to the layer's largest rank for the
engine. Any projection of the serving path may be an int8/int4 weight
(core/wquant); `wdot` dispatches it, and `mlp_forward` runs the fused
int8/int4 MLP GEMV at decode sizes. Qwen2's q/k/v biases ride the
projections (a low-rank bias on U's output, (G, group_dim)).

Two value paths give the same attention output:
  - "reconstruct": rebuild full V, apply probs, then dense o_proj;
  - "fused": keep V latent, probs @ v_latent per group, then the U_v-fused
    o_proj (the serving path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.wquant import W4_GROUP, is_quantized_weight, w4_group, wdot
from ..ops.gemv_int4 import mlp_gemv_int4
from ..ops.gemv_int8 import MAX_ROWS, mlp_gemv_int8
from .config import ModelConfig

Params = Dict[str, Any]

__all__ = [
    "rms_norm", "rope_cos_sin", "rope_cos_sin_for", "apply_rope",
    "is_ragged", "ragged_offsets", "project_kv", "reconstruct_kv", "quantize_latent_grouped",
    "attention_core", "mlp_forward", "forward", "init_params", "fuse_o_proj",
    "pad_ragged_params",
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
# Projections (dense or low-rank)
# ---------------------------------------------------------------------------


def is_ragged(proj: Params) -> bool:
    """True when the low-rank module has non-uniform per-group ranks: U is a
    tuple of (r_i, group_dim) matrices instead of a stacked (G, r, d) tensor
    (reference svd_linear.py:72-78 holds a per-group rank list)."""
    return "VT" in proj and isinstance(proj["U"], (list, tuple))


def ragged_offsets(proj: Params):
    """Per-group (offset, rank) pairs into the flat latent dimension."""
    offs, o = [], 0
    for u in proj["U"]:
        offs.append((o, u.shape[0]))
        o += u.shape[0]
    return offs


def project_kv(x: torch.Tensor, proj: Params, paths: Optional[set] = None) -> torch.Tensor:
    """Dense: returns (B, S, out). Low-rank: returns latents (B, S, G, r)
    for uniform ranks, or flat (B, S, sum_ranks) for ragged ranks. `paths`
    collects the wdot paths taken (core/wquant.wdot_path)."""
    if "VT" in proj:
        b, s, _ = x.shape
        lat = wdot(x, proj["VT"], paths)
        if is_ragged(proj):
            return lat  # (B, S, sum_ranks); sliced per group at reconstruct
        return lat.reshape(b, s, proj["U"].shape[0], -1)
    out = wdot(x, proj["w"], paths)
    if proj.get("b") is not None:
        out = out + proj["b"]
    return out


def reconstruct_kv(latents: torch.Tensor, proj: Params) -> torch.Tensor:
    """Uniform: latents (B, S, G, r) -> (B, S, G * group_dim) via the
    stacked U. Ragged: latents (B, S, sum_ranks) -> (B, S, G * group_dim)
    via per-group slices (reference svd_linear.py:107-121)."""
    if is_ragged(proj):
        outs = []
        for gi, (o, r) in enumerate(ragged_offsets(proj)):
            og = latents[..., o:o + r] @ proj["U"][gi]  # (B, S, d)
            if proj.get("b") is not None:
                og = og + proj["b"][gi]
            outs.append(og)
        return torch.cat(outs, dim=-1)
    out = torch.einsum("bsgr,grd->bsgd", latents, proj["U"])
    if proj.get("b") is not None:
        out = out + proj["b"]
    b, s, g, d = out.shape
    return out.reshape(b, s, g * d)


def quantize_latent_grouped(latents: torch.Tensor, proj: Params, quantize_latent):
    """Apply the fake-quant hook with per-group granularity for ragged
    latents (B, S, sum_ranks); uniform (B, S, G, r) passes through whole."""
    if not is_ragged(proj):
        return quantize_latent(latents)
    parts = [quantize_latent(latents[..., o:o + r]) for (o, r) in ragged_offsets(proj)]
    return torch.cat(parts, dim=-1)


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


def mlp_path(x: torch.Tensor, p: Params) -> Optional[str]:
    """The fused MLP GEMV mlp_forward runs for x, as in the JAX package:
    all three weights quantized alike, at most 8 rows, a multiple of 128
    intermediate columns (and 128-row groups for int4) ->
    "mlp_gemv_int4-kernel" / "-plain" or "mlp_gemv_int8-..." (kernel on
    CUDA); None for three wdots."""
    ws = [p[k] for k in ("gate", "up", "down")]
    rows = x.numel() // x.shape[-1]
    if not all(is_quantized_weight(w) for w in ws) or rows > MAX_ROWS:
        return None
    side = "kernel" if x.is_cuda else "plain"
    if all("wq4" in w for w in ws):
        if ws[0]["wq4"].shape[1] % 128 == 0 and all(w4_group(w) == W4_GROUP for w in ws):
            return f"mlp_gemv_int4-{side}"
    elif all("wq8" in w for w in ws) and ws[0]["wq8"].shape[1] % 128 == 0:
        return f"mlp_gemv_int8-{side}"
    return None


def mlp_forward(x: torch.Tensor, p: Params, paths: Optional[set] = None) -> torch.Tensor:
    """SwiGLU MLP. `paths` collects the path taken: mlp_path's name, or the
    three wdot paths."""
    path = mlp_path(x, p)
    if path is not None:
        if paths is not None:
            paths.add(path)
        fn = mlp_gemv_int4 if path.startswith("mlp_gemv_int4") else mlp_gemv_int8
        out = fn(x.reshape(-1, x.shape[-1]), p["gate"], p["up"], p["down"])
        return out.reshape(*x.shape[:-1], out.shape[-1])
    gate = wdot(x, p["gate"], paths)
    up = wdot(x, p["up"], paths)
    return wdot(F.silu(gate) * up, p["down"], paths)


def attn_forward(x, p: Params, cfg: ModelConfig, positions, mask, quantize_latent=None,
                 value_mode: str = "reconstruct") -> torch.Tensor:
    """Full-sequence (no-cache) attention of the accuracy path.

    quantize_latent: optional fn(latents) -> latents, applied to the K and
    V latents of low-rank sides before reconstruction (the reference's
    fake-quant, svd_linear.py:84-90)."""
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
    if quantize_latent is not None:
        if k_lowrank:
            k_raw = quantize_latent_grouped(k_raw, p["k_proj"], quantize_latent)
        if v_lowrank:
            v_raw = quantize_latent_grouped(v_raw, p["v_proj"], quantize_latent)

    k = reconstruct_kv(k_raw, p["k_proj"]) if k_lowrank else k_raw
    k = k.reshape(b, s, nkv, hd)

    cos, sin = rope_cos_sin_for(cfg, positions, dtype=torch.float32)
    qr = apply_rope(q.float(), cos, sin).to(x.dtype)
    kr = apply_rope(k.float(), cos, sin).to(x.dtype)

    # ragged V has no stacked latent layout for the fused path: reconstruct
    if value_mode == "fused" and v_lowrank and not is_ragged(p["v_proj"]):
        out = attention_core(qr, kr, v_raw, cfg, mask, v_is_latent=True)
        o_w = p["o_proj"]["w_fused"]
    else:
        v = reconstruct_kv(v_raw, p["v_proj"]) if v_lowrank else v_raw
        v = v.reshape(b, s, nkv, hd)
        out = attention_core(qr, kr, v, cfg, mask, v_is_latent=False)
        o_w = p["o_proj"]["w"]
    return out @ o_w


def decoder_layer(x, p: Params, cfg: ModelConfig, positions, mask, quantize_latent=None,
                  value_mode: str = "reconstruct") -> torch.Tensor:
    h = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
    x = x + attn_forward(h, p["attn"], cfg, positions, mask, quantize_latent, value_mode)
    h = rms_norm(x, p["post_norm"], cfg.rms_norm_eps)
    return x + mlp_forward(h, p["mlp"])


def forward(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, quantize_latent=None,
            value_mode: str = "reconstruct") -> torch.Tensor:
    """Full forward pass -> logits (B, S, vocab): no KV cache, causal mask,
    the fake-quant hook on the latents (the accuracy track)."""
    b, s = input_ids.shape
    dev = input_ids.device
    x = params["embed"][input_ids]
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    mask = _causal_mask(s, s, torch.float32, dev, cfg.sliding_window)
    for p_layer in params["layers"]:
        x = decoder_layer(x, p_layer, cfg, positions, mask, quantize_latent, value_mode)
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


def pad_ragged_params(params: Params, cfg: ModelConfig):
    """Zero-pad ragged per-group ranks up to each layer's largest rank,
    giving the uniform stacked layout the engine and its kernels require
    (the reference's kernel track also requires uniform ranks,
    kernel/palu_attention.py:111). Padding is exact for an unquantized
    cache (zero latent dims project and reconstruct to zero); with a
    quantized cache the padded zeros take part in the per-row scales, a
    small extra approximation. Computes in f32 on the params' device and
    keeps VT's dtype. Returns (params, cfg) unchanged when no layer is
    ragged."""
    changed = False
    new_ranks = dict(cfg.head_wise_ranks or {})
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        attn = dict(layer["attn"])
        layer_changed = False
        for which in ("k_proj", "v_proj"):
            p = attn[which]
            if not is_ragged(p):
                continue
            changed = layer_changed = True
            us = [u.float() for u in p["U"]]
            g, gd = len(us), us[0].shape[1]
            rmax = max(u.shape[0] for u in us)
            vt_old = p["VT"].float()
            vt = vt_old.new_zeros((vt_old.shape[0], g * rmax))
            u_new = vt_old.new_zeros((g, rmax, gd))
            for gi, (o, r) in enumerate(ragged_offsets(p)):
                vt[:, gi * rmax:gi * rmax + r] = vt_old[:, o:o + r]
                u_new[gi, :r] = us[gi]
            dt = p["VT"].dtype
            newp = {"VT": vt.to(dt), "U": u_new.to(dt)}
            if p.get("b") is not None:
                newp["b"] = p["b"]
            attn[which] = newp
            new_ranks[f"model.layers.{i}.self_attn.{which}"] = [rmax] * g
        if layer_changed and "VT" in attn["v_proj"]:
            attn["o_proj"] = dict(attn["o_proj"])
            attn["o_proj"]["w_fused"] = fuse_o_proj(
                attn["o_proj"]["w"].float(), attn["v_proj"]["U"].float(), cfg
            ).to(attn["v_proj"]["VT"].dtype)
        new_layers.append({**layer, "attn": attn})
    if not changed:
        return params, cfg
    return ({**params, "layers": new_layers},
            dataclasses.replace(cfg, head_wise_ranks=new_ranks))
