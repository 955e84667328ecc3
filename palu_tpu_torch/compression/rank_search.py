"""Rank allocation under a global parameter-ratio budget (the port's copy of
palu_tpu/compression/rank_search.py, which is pure Python: only the
import of ModelConfig differs).

Ports the reference's three search methods (palu/rank_search.py:86-231) to a
functional form over {module_name -> fisher stats} dicts:

  - uniform:        same ratio for every group (rank_search.py:88-104)
  - fisher:         per-head-group Fisher-proportional allocation (:105-168)
  - fisher_uniform: Fisher allocation across layers at whole-layer
                    granularity, then uniform split within the layer
                    (:169-230; the default and the only one the runtime
                    kernels need, since it yields uniform-within-layer ranks)

Shared mechanics kept bit-identical: proportional-to-mean-Fisher targets,
floor + greedy +1 residue distribution sorted by float-int gap (:150-162),
and final rounding to multiples of 32 (`rounding_search_result`, :11-17).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..models.config import ModelConfig, kv_info

__all__ = ["rounding_search_result", "split_values", "rank_search"]


def rounding_search_result(
    config: Dict[str, List[float]], block_size: int = 32
) -> Dict[str, List[int]]:
    """Round every rank to a positive multiple of block_size (rank_search.py:11-17)."""
    out = {}
    for name, ranks in config.items():
        out[name] = [max(1, round(r / block_size)) * block_size for r in ranks]
    return out


def split_values(data: Dict[str, List[float]], group_number: int) -> Dict[str, List[float]]:
    """Split each whole-layer rank into `group_number` per-group ranks
    (rank_search.py:28-33)."""
    return {
        k: [v // group_number for v in vals for _ in range(group_number)]
        for k, vals in data.items()
    }


def _fisher_allocate(
    module_names: List[str],
    fisher_means: Dict[str, List[float]],
    lr_group_dims: int,
    param_ratio_target: float,
) -> Dict[str, List[int]]:
    """Proportional allocation + greedy residue, reference semantics
    (rank_search.py:134-162)."""
    total_rank = sum(len(fisher_means[n]) for n in module_names) * lr_group_dims
    fisher_sum = sum(sum(fisher_means[n]) for n in module_names)
    target_rank = total_rank * param_ratio_target

    select: Dict[str, List[int]] = {}
    select_float: Dict[str, List[float]] = {}
    indexes: List[Tuple[str, int]] = []
    for name in module_names:
        fl = fisher_means[name]
        select[name] = [lr_group_dims] * len(fl)
        floats = []
        for i, f in enumerate(fl):
            rank_float = target_rank * f / fisher_sum
            floats.append(rank_float)
            indexes.append((name, i))
            select[name][i] = min(select[name][i], math.floor(rank_float))
        select_float[name] = floats

    indexes.sort(key=lambda x: select_float[x[0]][x[1]] - select[x[0]][x[1]])
    dif = target_rank - sum(sum(v) for v in select.values())
    while dif > 0:
        progressed = False
        for name, i in indexes:
            if select[name][i] == lr_group_dims:
                continue
            select[name][i] += 1
            dif -= 1
            progressed = True
            if dif <= 0:
                break
        if not progressed:
            break
    return select


def rank_search(
    cfg: ModelConfig,
    module_names: List[str],
    param_ratio_target: float,
    search_method: str = "fisher_uniform",
    head_group_size: int = 4,
    fisher_means: Optional[Dict[str, List[float]]] = None,
) -> Tuple[Dict[str, List[int]], int, int]:
    """Allocate per-group ranks for each k/v projection module.

    `fisher_means[name]` must hold the per-group mean Fisher values, where the
    grouping granularity depends on the method: `head_group_size` groups for
    "fisher", one whole-layer group for "fisher_uniform".

    Returns (select_result, rank_sum, total_rank).
    """
    if search_method == "uniform":
        num_groups, group_dims = kv_info(cfg, head_group_size)
        total_rank = num_groups * group_dims * len(module_names)
        select = {
            n: [group_dims * param_ratio_target] * num_groups for n in module_names
        }
        select = rounding_search_result(select)
    elif search_method == "fisher":
        assert fisher_means is not None
        num_groups, group_dims = kv_info(cfg, head_group_size)
        total_rank = num_groups * group_dims * len(module_names)
        select = _fisher_allocate(module_names, fisher_means, group_dims, param_ratio_target)
        select = rounding_search_result(select)
    elif search_method == "fisher_uniform":
        assert fisher_means is not None
        # one group per layer (get_kv_info called with num_key_value_heads,
        # rank_search.py:181)
        num_groups, group_dims = kv_info(cfg, cfg.num_key_value_heads)
        total_rank = num_groups * group_dims * len(module_names)
        select = _fisher_allocate(module_names, fisher_means, group_dims, param_ratio_target)
        select = split_values(select, cfg.num_key_value_heads // head_group_size)
        select = rounding_search_result(select)
    else:
        raise NotImplementedError(search_method)

    rank_sum = sum(sum(v) for v in select.values())
    return select, rank_sum, total_rank
