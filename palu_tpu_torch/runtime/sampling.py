"""Token sampling: greedy / temperature / top-k / top-p (port of
palu_tpu/runtime/sampling.py).

The JAX package draws with jax.random.categorical, which is the Gumbel-max
draw argmax(logits + g) with g = jax.random.gumbel(key, (1, V)) per row. The
port makes the same draw over a noise tensor the caller passes in, so a test
can hand it JAX's noise and hold the tokens equal; the engine and the
serving loop make the noise with `gumbel_noise` from a torch.Generator
seeded by (seed, step) or (seed, request id, step), which keeps a request's
stream independent of its lane and of the other lanes, as JAX's folded
keys do. Filtering follows JAX's order: temperature, then top-k, then top-p
on what top-k kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SamplingParams", "gumbel_noise", "sample", "sample_batched"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = no top-k
    top_p: float = 1.0  # 1 = no nucleus filtering


def gumbel_noise(shape, device, *ids: int) -> torch.Tensor:
    """Standard Gumbel noise of `shape` in f32 on `device`, drawn on the CPU
    from a generator seeded by the integers `ids` (mixed by numpy's
    SeedSequence), so the same ids give the same noise on any device."""
    seed = np.random.SeedSequence([int(i) % 2**64 for i in ids]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(seed[0]))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)  # as jax.random.gumbel
    return (-torch.log(-torch.log(u))).to(device)


def sample_batched(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Per-lane sampling over logits (B, V): temps (B,) f32, <= 0 for a
    greedy lane; top_ks (B,) int, 0 for no top-k; top_ps (B,) f32, >= 1 for
    no nucleus filtering; noise (B, V) Gumbel noise (rows of greedy lanes
    are not read). Returns (B,) int64 token ids: a lane's id is what
    `sample` gives on its row alone."""
    b, v = logits.shape
    greedy = logits.argmax(dim=-1)
    lf = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    neg_inf = torch.tensor(float("-inf"), device=lf.device)

    # per-lane top-k: threshold at the k-th largest (no filter when k == 0)
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    idx = torch.clamp(torch.where(top_ks > 0, top_ks - 1, v - 1), 0, v - 1).long()
    kth = torch.gather(sorted_desc, -1, idx[:, None])
    lf = torch.where((top_ks > 0)[:, None] & (lf < kth), neg_inf, lf)

    # per-lane top-p on the top-k-filtered distribution: keep the smallest
    # prefix whose cumulative mass reaches top_p
    sorted_f = torch.sort(lf, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_f, dim=-1), dim=-1)
    cutoff_idx = torch.clamp((cum < top_ps.float()[:, None]).sum(dim=-1), 0, v - 1)
    cutoff = torch.gather(sorted_f, -1, cutoff_idx[:, None])
    lf = torch.where((top_ps < 1.0)[:, None] & (lf < cutoff), neg_inf, lf)

    sampled = (lf + noise.float()).argmax(dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


def sample(logits: torch.Tensor, params: SamplingParams,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """(B,) token ids from logits (B, V) under one SamplingParams; noise
    (B, V) is needed unless the params are greedy."""
    if params.temperature <= 0.0:
        return logits.argmax(dim=-1)
    if noise is None:
        raise ValueError("sampling with temperature > 0 needs Gumbel noise")
    b, dev = logits.shape[0], logits.device
    return sample_batched(
        logits, torch.full((b,), params.temperature, dtype=torch.float32, device=dev),
        torch.full((b,), params.top_k, dtype=torch.int64, device=dev),
        torch.full((b,), params.top_p, dtype=torch.float32, device=dev), noise)
