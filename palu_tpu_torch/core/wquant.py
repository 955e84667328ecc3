"""Int8 / int4 weight-only storage for serving (port of
palu_tpu/core/wquant.py).

Weights are stored (in_features, out_features), so a projection reads
`x @ w`. Quantized weights are dicts:
  int8  {"wq8": int8 (in, out), "ws": (1, out) f32}, symmetric per output
        channel, codes -127..127;
  int4  {"wq4": uint8 (in/2, out), "ws": (in/group, out) f32}: codes -8..7
        stored + 8 as nibbles, rows r and r + group/2 of each group sharing
        a byte, scales per (group, output channel);
  embed {"eq8": int8 (V, H), "es": (V, 1) f32}, per vocabulary row.
Codes and scales are bit-identical to the JAX package's on the CPU and on
the card: its eager `max / 127.0` is an IEEE division here as in XLA (see
`_div`), and `torch.round` rounds half to even as `jnp.round` does.

`wdot` dispatches as the JAX package does: at 1 to 8 rows an int4 weight
with 128-row groups and an int8 weight, each with a multiple of 128 output
columns, go through ops/gemv_int4 and ops/gemv_int8 (the kernel for a CUDA
tensor, its plain version for a CPU one); larger inputs (prefill, lm_head
over a chunk) multiply by the dequantized weight. The JAX package sends the
int8 case to XLA, which fuses the int8 -> bf16 convert into the dot's
operand read; eager PyTorch would write a bf16 copy of the weight each
call instead, so the port runs the int8 GEMV kernel there.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..ops.gemv_int4 import gemv_int4
from ..ops.gemv_int8 import MAX_ROWS, gemv_int8

__all__ = ["quantize_weight", "quantize_weight4", "is_quantized_weight", "w4_group",
           "unpack_weight4", "wdot", "wdot_path", "dense_operand", "quantize_params",
           "quantize_embed", "embed_rows", "embed_dim", "tied_head", "W4_GROUP"]

W4_GROUP = 128  # rows per int4 scale group (along the contraction dim)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE f32 division. PyTorch's CUDA kernel multiplies by
    the reciprocal when the divisor is a Python number, which moves the last
    bit of some scales; a divisor tensor on x's device keeps the division."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def quantize_weight(w: torch.Tensor) -> dict:
    """(in, out) float -> {"wq8": int8 codes, "ws": (1, out) f32 scales},
    symmetric per-output-channel."""
    wf = w.float()
    s = torch.clamp(_div(wf.abs().amax(dim=0, keepdim=True), 127.0), min=1e-30)
    return {"wq8": torch.round(wf / s).to(torch.int8), "ws": s}


def quantize_weight4(w: torch.Tensor, group: int = W4_GROUP) -> dict:
    """(in, out) float -> {"wq4": uint8 (in/2, out) packed codes,
    "ws": (in/group, out) f32 scales}, symmetric per-(group, out-channel).
    Small in-dims shrink the group (halving) until it divides them twice."""
    wf = w.float()
    n_in, n_out = wf.shape
    req = group
    while group > 2 and n_in % (2 * group) != 0:
        group //= 2
    if n_in % (2 * group) != 0:
        raise ValueError(f"in-dim {n_in} must be a multiple of {2 * group}")
    if group != req and n_in >= 1024:
        warnings.warn(
            f"quantize_weight4: in-dim {n_in} is not a multiple of {2 * req}; scale "
            f"group shrinks to {group}, which disqualifies the int4 GEMV kernels "
            f"(w4_group != W4_GROUP) and decode falls back to the dequant matmul",
            stacklevel=2)
    n_g = n_in // group
    wg = wf.reshape(n_g, group, n_out)
    s = torch.clamp(_div(wg.abs().amax(dim=1), 7.0), min=1e-30)  # codes -8..7; +/-7 used
    q = torch.clamp(torch.round(wg / s[:, None, :]), -8, 7)
    u = (q + 8).to(torch.uint8).reshape(n_g, 2, group // 2, n_out)
    packed = (u[:, 0] | (u[:, 1] << 4)).reshape(n_in // 2, n_out)
    return {"wq4": packed, "ws": s}


def w4_group(w) -> int:
    """Rows per scale group of a {"wq4", "ws"} weight."""
    return (2 * w["wq4"].shape[0]) // w["ws"].shape[0]


def is_quantized_weight(w) -> bool:
    return isinstance(w, dict) and ("wq8" in w or "wq4" in w)


def unpack_weight4(w) -> torch.Tensor:
    """{"wq4", "ws"} -> dequantized (in, out) f32 weights."""
    u = w["wq4"]
    n_out = u.shape[1]
    n_g = w["ws"].shape[0]
    g = (2 * u.shape[0]) // n_g
    ub = u.reshape(n_g, g // 2, n_out)
    codes = torch.stack([ub & 0xF, ub >> 4], dim=1).float() - 8.0
    return (codes.reshape(n_g, g, n_out) * w["ws"][:, None, :]).reshape(n_g * g, n_out)


def _rows(x: torch.Tensor) -> int:
    n = 1
    for d in x.shape[:-1]:
        n *= d
    return n


def wdot_path(x: torch.Tensor, w) -> str:
    """Which path wdot takes for x and w: "gemv_int4-kernel" / "-plain",
    "gemv_int8-kernel" / "-plain" (the GEMVs, kernel on CUDA), or
    "int4-dequant-matmul", "int8-matmul", "dense-matmul"."""
    if isinstance(w, tuple):  # dense_operand's int8 form
        return "int8-matmul"
    if not isinstance(w, dict):
        return "dense-matmul"
    side = "kernel" if x.is_cuda else "plain"
    small = _rows(x) <= MAX_ROWS
    if "wq4" in w:
        if small and w["wq4"].shape[1] % 128 == 0 and w4_group(w) == W4_GROUP:
            return f"gemv_int4-{side}"
        return "int4-dequant-matmul"
    if small and w["wq8"].shape[1] % 128 == 0:
        return f"gemv_int8-{side}"
    return "int8-matmul"


def wdot(x: torch.Tensor, w, paths: Optional[set] = None) -> torch.Tensor:
    """x @ w over the last axis of x; w is a plain tensor, a quantized
    {"wq8"|"wq4", "ws"} dict or dense_operand's int8 (codes, scales)
    tuple. `paths`, when given, collects wdot_path."""
    path = wdot_path(x, w)
    if paths is not None:
        paths.add(path)
    if path.startswith("gemv_"):
        lead = x.shape[:-1]
        fn = gemv_int4 if path.startswith("gemv_int4") else gemv_int8
        y = fn(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*lead, y.shape[-1])
    if path == "int4-dequant-matmul":
        return (x @ unpack_weight4(w).to(x.dtype)).to(x.dtype)
    if path == "int8-matmul":
        # x times the codes (exact in bf16 and f32), then the per-channel
        # scale in f32: the JAX package's dot_general with an f32 result. On
        # the CPU the product is f32; on the card cuBLAS accumulates in f32
        # but rounds the product to x.dtype before the scale (one rounding
        # more than JAX: 2^-9 of a bf16 value).
        codes, ws = w if isinstance(w, tuple) else (w["wq8"], w["ws"])
        if x.is_cuda:
            y = x @ codes.to(x.dtype)
        else:
            y = x.float() @ codes.float()
        return (y.float() * ws).to(x.dtype)
    return x @ w


def dense_operand(w, dtype: torch.dtype):
    """w in the form wdot's matmul paths read it, made once: an int4 weight
    dequantized to `dtype`; an int8 weight as the tuple (codes cast to
    `dtype`, scales), the operands of the int8 matmul path, which keeps the
    JAX order (scale after the sum). For inputs of more than 8 rows wdot
    gives the same values from it as from w; prefill reuses it across
    chunks."""
    if isinstance(w, dict) and "wq4" in w:
        return unpack_weight4(w).to(dtype)
    if is_quantized_weight(w):
        return w["wq8"].to(dtype), w["ws"]
    return w


# params keys quantized by quantize_params: the large dense projections.
_ATTN_KEYS = ("q_proj", "o_proj")
_MLP_KEYS = ("gate", "up", "down")


def quantize_params(params, vt: bool = False, embed: bool = False, bits: int = 8) -> dict:
    """A copy of an engine params tree with q_proj, o_proj (w and w_fused),
    the MLP and lm_head quantized to `bits` (8 or 4). vt=True stores the VT
    down-projections as int8 (always int8, also at bits=4); embed=True
    stores the embedding table as int8 per vocabulary row. U, biases and
    norms stay as they are. Leaves already quantized pass through; every
    container of the returned tree is fresh."""
    if bits not in (8, 4):
        raise ValueError(f"weight bits must be 8 or 4, got {bits}")

    def q(w):
        if is_quantized_weight(w):
            return w
        return quantize_weight4(w) if bits == 4 else quantize_weight(w)

    out = dict(params)
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        attn = {k: dict(v) if isinstance(v, dict) else v for k, v in layer["attn"].items()}
        for k in _ATTN_KEYS:
            proj = attn[k]
            for wk in ("w", "w_fused"):
                if proj.get(wk) is not None:
                    proj[wk] = q(proj[wk])
        if vt:
            for k in ("k_proj", "v_proj"):
                proj = attn.get(k)
                if proj is not None and proj.get("VT") is not None:
                    if not is_quantized_weight(proj["VT"]):
                        proj["VT"] = quantize_weight(proj["VT"])  # int8 always
        layer["attn"] = attn
        mlp = dict(layer["mlp"])
        for k in _MLP_KEYS:
            mlp[k] = q(mlp[k])
        layer["mlp"] = mlp
        layers.append(layer)
    out["layers"] = layers
    if params.get("lm_head") is not None:
        out["lm_head"] = q(params["lm_head"])
    if embed and not (isinstance(params["embed"], dict) and "eq8" in params["embed"]):
        out["embed"] = quantize_embed(params["embed"])
    return out


def quantize_embed(e: torch.Tensor) -> dict:
    """(V, H) float -> {"eq8": int8 codes, "es": (V, 1) f32 row scales}."""
    ef = e.float()
    s = torch.clamp(_div(ef.abs().amax(dim=1, keepdim=True), 127.0), min=1e-30)
    return {"eq8": torch.round(ef / s).to(torch.int8), "es": s}


def embed_rows(emb, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token-id lookup for a plain or int8-quantized embedding table."""
    if isinstance(emb, dict) and "eq8" in emb:
        return (emb["eq8"][ids] * emb["es"][ids]).to(dtype)
    return emb[ids].to(dtype)


def embed_dim(emb) -> int:
    return (emb["eq8"] if isinstance(emb, dict) and "eq8" in emb else emb).shape[1]


def tied_head(params):
    """The lm_head operand for wdot: the explicit head if present, else the
    (possibly int8) embedding table transposed (weight tying). The int8 head
    is a transposed view of the codes, which the int8 GEMV reads in place."""
    if params.get("lm_head") is not None:
        return params["lm_head"]
    emb = params["embed"]
    if isinstance(emb, dict) and "eq8" in emb:
        return {"wq8": emb["eq8"].T, "ws": emb["es"].T}
    return emb.T
