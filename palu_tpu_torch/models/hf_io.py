"""HF-checkpoint interop in PyTorch (port of palu_tpu/models/hf_io.py):
import dense or Palu-compressed checkpoints from a local directory, and
export compressed params back to the same format.

Interop targets:
  - dense HF checkpoints: model_type llama / mistral / qwen2
  - Palu checkpoints: model_type palullama / palumistral / paluqwen2 with
    `head_wise_ranks` in config.json (the reference's utils.py:48-76
    dump_to_huggingface_repos). Low-rank modules are stored as
    `...k_proj.VT.weight` (sum_ranks, hidden) and `...k_proj.U.{g}.weight`
    (group_dim, rank) (svd_linear.py:72-78).

Tensors are stored HF-style (out_features, in_features); the params are
input-major, so every projection transposes on the way in and out.

The safetensors format is read and written here with the standard library
(no `safetensors` package): an 8-byte little-endian header length, a JSON
header mapping each name to its dtype, shape and `data_offsets` into the
data section (plus an optional `__metadata__`), then the raw little-endian
bytes. Sharded checkpoints (`model.safetensors.index.json`) and single
files load; F64, F32, F16 and BF16 (and the integer types) are read into
torch tensors, since numpy has no bf16. `.bin` checkpoints load through
torch.load(weights_only=True).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import torch

from .config import ModelConfig
from .llama import fuse_o_proj

__all__ = ["load_config", "config_from_hf", "load_params", "save_checkpoint",
           "read_safetensors", "write_safetensors"]

_FAMILY_BY_MODEL_TYPE = {
    "llama": "llama",
    "palullama": "llama",
    "mistral": "mistral",
    "palumistral": "mistral",
    "qwen2": "qwen2",
    "paluqwen2": "qwen2",
}

_PALU_MODEL_TYPE = {"llama": "palullama", "mistral": "palumistral", "qwen2": "paluqwen2"}
_PALU_ARCHITECTURES = {
    "llama": "PaluLlamaForCausalLM",
    "mistral": "PaluMistralForCausalLM",
    # the reference writes the misspelt "PaluQwenForCausalLM" (utils.py:69);
    # kept for round-trip compatibility
    "qwen2": "PaluQwenForCausalLM",
}

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one .safetensors file, as CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
            if len(buf) != end - begin:
                raise ValueError(f"{path}: {name} is truncated")
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write tensors (any device; written contiguous, in name order) as one
    .safetensors file. The header is padded with spaces to 8 bytes, as the
    safetensors package writes it."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs, off = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)


def load_config(model_dir: str, head_group_size: int = 4) -> ModelConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf(json.load(f), head_group_size)


def config_from_hf(raw: Dict[str, Any], head_group_size: int = 4) -> ModelConfig:
    """ModelConfig from the fields of an HF config.json (llama, mistral,
    qwen2 and the reference's palu model types)."""
    model_type = raw.get("model_type", "llama")
    family = _FAMILY_BY_MODEL_TYPE.get(model_type)
    if family is None:
        raise ValueError(f"unsupported model_type: {model_type}")
    return ModelConfig(
        vocab_size=raw["vocab_size"],
        hidden_size=raw["hidden_size"],
        intermediate_size=raw["intermediate_size"],
        num_hidden_layers=raw["num_hidden_layers"],
        num_attention_heads=raw["num_attention_heads"],
        num_key_value_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
        head_dim=raw.get("head_dim"),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
        rope_theta=raw.get("rope_theta", 10000.0),
        max_position_embeddings=raw.get("max_position_embeddings", 4096),
        attention_bias=raw.get("attention_bias", family == "qwen2"),
        mlp_bias=raw.get("mlp_bias", False),
        tie_word_embeddings=raw.get("tie_word_embeddings", False),
        sliding_window=raw.get("sliding_window") if family == "mistral" else None,
        rope_scaling=raw.get("rope_scaling"),
        model_family=family,
        head_group_size=raw.get("head_group_size", head_group_size),
        head_wise_ranks=raw.get("head_wise_ranks"),
    )


def _read_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """All tensors from safetensors (single or sharded) or torch .bin."""
    tensors: Dict[str, torch.Tensor] = {}
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    single_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        for shard in sorted(set(index["weight_map"].values())):
            tensors.update(read_safetensors(os.path.join(model_dir, shard)))
    elif os.path.exists(single_path):
        tensors = read_safetensors(single_path)
    else:
        for fname in sorted(os.listdir(model_dir)):
            if fname.endswith(".bin") and "pytorch_model" in fname:
                tensors.update(torch.load(os.path.join(model_dir, fname), map_location="cpu",
                                          weights_only=True))
        if not tensors:
            raise FileNotFoundError(f"no model weights found in {model_dir}")
    return tensors


def load_params(model_dir: str, cfg: Optional[ModelConfig] = None, dtype=torch.bfloat16,
                build_fused_o: bool = True, device="cuda") -> tuple:
    """Load a local HF checkpoint dir -> (params, cfg), every tensor on
    `device` in `dtype` (the weights go to the device as stored, then cast
    and transposed there)."""
    if cfg is None:
        cfg = load_config(model_dir)
    sd = _read_state_dict(model_dir)
    dev = torch.device(device)

    def v(name):  # vector / embedding as-is
        return sd[name].to(dev).to(dtype)

    def t(name):  # transposed projection
        return v(name).T.contiguous()

    def kv_proj(i: int, which: str) -> Dict[str, Any]:
        prefix = f"model.layers.{i}.self_attn.{which}"
        ranks = cfg.ranks_for(i, which)
        if ranks is None or f"{prefix}.VT.weight" not in sd:
            p = {"w": t(f"{prefix}.weight")}
            if f"{prefix}.bias" in sd:
                p["b"] = v(f"{prefix}.bias")
            return p
        vt = t(f"{prefix}.VT.weight")  # (hidden, sum_ranks)
        us = [t(f"{prefix}.U.{g}.weight") for g in range(len(ranks))]  # (rank_g, group_dim)
        if len(set(ranks)) == 1:
            p = {"VT": vt, "U": torch.stack(us)}
        else:
            # ragged per-group ranks (the fisher search's output): per-group
            # matrices; the accuracy forward takes them, the Engine pads
            p = {"VT": vt, "U": tuple(us)}
        if f"{prefix}.U.0.bias" in sd:
            p["b"] = torch.stack([v(f"{prefix}.U.{g}.bias") for g in range(len(ranks))])
        if vt.shape[1] != sum(ranks):
            raise ValueError(f"{prefix}: VT has {vt.shape[1]} ranks, config {ranks}")
        return p

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}"
        q_p = {"w": t(f"{pre}.self_attn.q_proj.weight")}
        if f"{pre}.self_attn.q_proj.bias" in sd:
            q_p["b"] = v(f"{pre}.self_attn.q_proj.bias")
        attn = {
            "q_proj": q_p,
            "k_proj": kv_proj(i, "k_proj"),
            "v_proj": kv_proj(i, "v_proj"),
            "o_proj": {"w": t(f"{pre}.self_attn.o_proj.weight")},
        }
        if build_fused_o and "VT" in attn["v_proj"] and \
                not isinstance(attn["v_proj"]["U"], tuple):
            # ragged V has no stacked layout; the Engine pads and fuses it
            attn["o_proj"]["w_fused"] = fuse_o_proj(
                attn["o_proj"]["w"].float(), attn["v_proj"]["U"].float(), cfg).to(dtype)
        layers.append({
            "input_norm": v(f"{pre}.input_layernorm.weight"),
            "post_norm": v(f"{pre}.post_attention_layernorm.weight"),
            "attn": attn,
            "mlp": {
                "gate": t(f"{pre}.mlp.gate_proj.weight"),
                "up": t(f"{pre}.mlp.up_proj.weight"),
                "down": t(f"{pre}.mlp.down_proj.weight"),
            },
        })
        for name in [k for k in sd if k.startswith(pre + ".")]:
            del sd[name]  # free the host copy of the layer

    params = {
        "embed": v("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": v("model.norm.weight"),
        "lm_head": None if cfg.tie_word_embeddings or "lm_head.weight" not in sd
        else t("lm_head.weight"),
    }
    return params, cfg


def save_checkpoint(params: Dict[str, Any], cfg: ModelConfig, save_dir: str,
                    original_model_name_or_path: str = "",
                    extra_config: Optional[Dict[str, Any]] = None,
                    dtype=torch.float16) -> None:
    """Write params as an HF-style Palu checkpoint the reference can load
    (the utils.py:48-76 format: model.safetensors + config.json with
    head_wise_ranks, the palu model_type and architectures). Values are
    cast through f32 to `dtype` (f16 by default, as the reference)."""
    os.makedirs(save_dir, exist_ok=True)
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr, transpose):
        a = arr.float()
        sd[name] = (a.T if transpose else a).to(dtype).contiguous().cpu()

    put("model.embed_tokens.weight", params["embed"], False)
    put("model.norm.weight", params["final_norm"], False)
    if params.get("lm_head") is not None:
        put("lm_head.weight", params["lm_head"], True)

    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        put(f"{pre}.input_layernorm.weight", layer["input_norm"], False)
        put(f"{pre}.post_attention_layernorm.weight", layer["post_norm"], False)
        attn, mlp = layer["attn"], layer["mlp"]
        put(f"{pre}.self_attn.q_proj.weight", attn["q_proj"]["w"], True)
        if attn["q_proj"].get("b") is not None:
            put(f"{pre}.self_attn.q_proj.bias", attn["q_proj"]["b"], False)
        put(f"{pre}.self_attn.o_proj.weight", attn["o_proj"]["w"], True)
        for which in ("k_proj", "v_proj"):
            p = attn[which]
            prefix = f"{pre}.self_attn.{which}"
            if "VT" in p:
                put(f"{prefix}.VT.weight", p["VT"], True)
                # ragged: per-group (r_g, d); stacked: (G, r, d)
                for g, u in enumerate(p["U"]):
                    put(f"{prefix}.U.{g}.weight", u, True)
                    if p.get("b") is not None:
                        put(f"{prefix}.U.{g}.bias", p["b"][g], False)
            else:
                put(f"{prefix}.weight", p["w"], True)
                if p.get("b") is not None:
                    put(f"{prefix}.bias", p["b"], False)
        put(f"{pre}.mlp.gate_proj.weight", mlp["gate"], True)
        put(f"{pre}.mlp.up_proj.weight", mlp["up"], True)
        put(f"{pre}.mlp.down_proj.weight", mlp["down"], True)

    write_safetensors(sd, os.path.join(save_dir, "model.safetensors"))

    config = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "attention_bias": cfg.attention_bias,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": "float16",
        "model_type": _PALU_MODEL_TYPE[cfg.model_family] if cfg.head_wise_ranks
        else cfg.model_family,
        "architectures": [_PALU_ARCHITECTURES[cfg.model_family]] if cfg.head_wise_ranks
        else None,
        "head_wise_ranks": cfg.head_wise_ranks or {},
        "head_group_size": cfg.head_group_size,
        "original_model_name_or_path": original_model_name_or_path,
    }
    if cfg.sliding_window is not None:
        config["sliding_window"] = cfg.sliding_window
    if cfg.rope_scaling is not None:
        config["rope_scaling"] = cfg.rope_scaling
    if extra_config:
        config.update(extra_config)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump({k: v for k, v in config.items() if v is not None}, f, indent=2)
