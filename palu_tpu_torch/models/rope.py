"""RoPE frequency computation with HF-parity `rope_scaling` support.

The port's own copy of palu_tpu/models/rope.py (numpy only, identical
results).

The reference inherits rope scaling for free from transformers (its models
subclass HF classes); our importer previously dropped `rope_scaling` from
config.json, silently computing wrong positions for linear/yarn/llama3-scaled
checkpoints (e.g. Llama-3.1). This module reproduces transformers'
ROPE_INIT_FUNCTIONS semantics (modeling_rope_utils.py) for the types the
Llama family uses:

  default      inv_freq = theta^(-2i/d)
  linear       inv_freq / factor
  dynamic      NTK base rescaling, evaluated at max_position_embeddings
  yarn         per-dim interpolation ramp + attention scaling
  llama3       wavelength-banded interpolation (Llama-3.1)

`inv_freq_and_scale(cfg)` returns (inv_freq (head_dim/2,), attention_scale);
the attention scale multiplies the cos/sin tables exactly as transformers
does (applied to both q and k sides).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["inv_freq_and_scale", "default_inv_freq"]


def default_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )


def inv_freq_and_scale(cfg) -> Tuple[np.ndarray, float]:
    """cfg: ModelConfig (uses head_dim, rope_theta, max_position_embeddings,
    rope_scaling). Returns (inv_freq float32 (head_dim/2,), attention_scale).
    """
    hd = cfg.head_dim
    theta = cfg.rope_theta
    rs: Optional[dict] = getattr(cfg, "rope_scaling", None)
    inv_freq = default_inv_freq(hd, theta)
    if not rs:
        return inv_freq.astype(np.float32), 1.0

    rope_type = rs.get("rope_type", rs.get("type", "default"))
    factor = float(rs.get("factor", 1.0))

    if rope_type == "default":
        pass
    elif rope_type == "linear":
        inv_freq = inv_freq / factor
    elif rope_type == "dynamic":
        # NTK-by-parts evaluated at the configured max length (transformers
        # recomputes per-seq-len; the static evaluation matches it at
        # max_position_embeddings, the operating point for long prompts)
        orig_max = int(rs.get("original_max_position_embeddings",
                              cfg.max_position_embeddings))
        seq_len = max(cfg.max_position_embeddings, orig_max)
        base = theta * (
            (factor * seq_len / orig_max) - (factor - 1)
        ) ** (hd / (hd - 2))
        inv_freq = default_inv_freq(hd, base)
    elif rope_type == "yarn":
        orig_max = int(rs.get("original_max_position_embeddings",
                              cfg.max_position_embeddings))
        beta_fast = float(rs.get("beta_fast", 32.0))
        beta_slow = float(rs.get("beta_slow", 1.0))

        def find_dim(num_rotations):
            return (hd * math.log(orig_max / (num_rotations * 2 * math.pi))) / (
                2 * math.log(theta)
            )

        low = max(math.floor(find_dim(beta_fast)), 0)
        high = min(math.ceil(find_dim(beta_slow)), hd // 2 - 1)
        rng = np.arange(hd // 2, dtype=np.float64)
        ramp = np.clip((rng - low) / max(high - low, 0.001), 0.0, 1.0)
        inv_freq_interp = inv_freq / factor
        # ramp==0 -> extrapolation (original freq), ramp==1 -> interpolation
        inv_freq = inv_freq * (1 - ramp) + inv_freq_interp * ramp
        attn = rs.get("attention_factor")
        if attn is None:
            mscale = float(rs.get("mscale", 1.0)) or 1.0
            attn = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
            attn = attn * mscale if mscale != 1.0 else attn
        return inv_freq.astype(np.float32), float(attn)
    elif rope_type == "llama3":
        orig_max = int(rs.get("original_max_position_embeddings", 8192))
        low_ff = float(rs.get("low_freq_factor", 1.0))
        high_ff = float(rs.get("high_freq_factor", 4.0))
        low_wavelen = orig_max / low_ff
        high_wavelen = orig_max / high_ff
        wavelen = 2 * math.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(is_mid, mid, scaled)
    else:
        raise NotImplementedError(f"rope_scaling type {rope_type!r}")
    return inv_freq.astype(np.float32), 1.0
