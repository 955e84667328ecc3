"""Model configuration for the Llama family (Llama / TinyLlama / Mistral /
Qwen2) plus Palu compression metadata.

The port's own copy of palu_tpu/models/config.py (same fields, same
checks): importing the JAX package's module would pull in JAX through
palu_tpu/models/__init__.py.

Mirrors the reference's approach of riding the HF config with one extension
field `head_wise_ranks` (configuration_palu_llama.py:111,145) so checkpoints
interoperate: our importer reads reference-produced `palullama` /
`palumistral` / `paluqwen2` config.json files directly, and our exporter
writes the same format.

Family deltas (reference palu/model/):
  - llama: the base case (svd_llama/)
  - mistral: sliding_window passthrough (svd_mistral/)
  - qwen2: attention bias -> per-group bias carried by U (svd_qwen/,
    svd_linear.py:76,179,196)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["ModelConfig", "kv_info"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    attention_bias: bool = False  # qwen2: True for q/k/v
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    sliding_window: Optional[int] = None  # mistral
    # HF rope_scaling dict (type/rope_type, factor, ...); None = default RoPE.
    # The reference inherits this via transformers; models/rope.py reproduces it.
    rope_scaling: Optional[Dict] = None
    model_family: str = "llama"  # llama | mistral | qwen2

    # --- Palu compression metadata ---
    head_group_size: int = 4
    # HF-style module name -> per-group ranks, e.g.
    # {"model.layers.0.self_attn.k_proj": [352]*8, ...}
    head_wise_ranks: Optional[Dict[str, List[int]]] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim", self.hidden_size // self.num_attention_heads
            )

    @property
    def num_kv_groups(self) -> int:
        """Number of low-rank head groups G = num_key_value_heads / group_size."""
        return self.num_key_value_heads // self.head_group_size

    @property
    def group_dim(self) -> int:
        """Output dim per low-rank group = head_group_size * head_dim."""
        return self.head_group_size * self.head_dim

    def ranks_for(self, layer: int, which: str) -> Optional[List[int]]:
        """Per-group ranks of `model.layers.{layer}.self_attn.{which}`, or None
        if that projection is dense (uncompressed)."""
        if not self.head_wise_ranks:
            return None
        return self.head_wise_ranks.get(f"model.layers.{layer}.self_attn.{which}")

    def uniform_rank_for(self, layer: int, which: str) -> Optional[int]:
        ranks = self.ranks_for(layer, which)
        if ranks is None:
            return None
        if len(set(ranks)) != 1:
            raise ValueError(
                f"layer {layer} {which} has ragged ranks {ranks}; the runtime "
                "requires uniform ranks within a layer (models/llama."
                "pad_ragged_params pads them; the Engine does so at build)"
            )
        return ranks[0]


def kv_info(cfg: ModelConfig, num_heads_in_lr_groups: int) -> Tuple[int, int]:
    """(num_lr_groups, lr_group_dims) with the reference's divisibility checks
    (modeling_palu_llama.py:37-59)."""
    if cfg.num_attention_heads % num_heads_in_lr_groups:
        raise ValueError(
            f"num_heads {cfg.num_attention_heads} not divisible by group size "
            f"{num_heads_in_lr_groups}"
        )
    if cfg.num_key_value_heads % num_heads_in_lr_groups:
        raise ValueError(
            f"num_key_value_heads {cfg.num_key_value_heads} not divisible by "
            f"group size {num_heads_in_lr_groups}"
        )
    num_lr_kv_groups = cfg.num_key_value_heads // num_heads_in_lr_groups
    lr_group_dims = cfg.head_dim * num_heads_in_lr_groups
    return num_lr_kv_groups, lr_group_dims
