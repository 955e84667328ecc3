"""Headwise low-rank (G-LRD) decomposition math in PyTorch (port of
palu_tpu/core/lowrank.py).

A projection weight W (out, in) is split into per-head-group blocks W_g
(group_dim, in) and each block factorized W_g ~= L_g @ R_g with rank r_g:

  - plain SVD (the reference's svd_linear.py:36-51): L = U sqrt(S),
    R = sqrt(S) Vt;
  - whitened SVD (svd_linear.py:6-34): the SVD of W_g @ S, S the Cholesky
    factor of the calibration Gram X^T X, with R mapped back through S^-1.

The result is a `LowRankWeights` of torch tensors on the caller's device:
  VT (sum(ranks), in) -- latent projection, x @ VT.T -> latents
  U  list of (group_dim, r_g) -- per-group reconstruction.
The SVD, Cholesky and inverse are torch.linalg calls on that device (the
JAX package runs them in numpy; neither is a kernel of the port), in f32
with the Gram's Cholesky in f64, as the reference does
(decomposition.py:150-152). `fuse_hadamard` rotates each group's rank dim
with core/hadamard.apply_hadamard: the FWHT kernel on CUDA tensors.

Singular vectors are defined up to sign, and cuSOLVER and LAPACK may pick
opposite ones: factors agree with the JAX package's up to a per-rank sign,
their products (reconstruct_dense) as they are.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .hadamard import apply_hadamard

__all__ = [
    "LowRankWeights",
    "decompose_svd",
    "decompose_whiten",
    "cholesky_with_psd_repair",
    "fuse_hadamard",
]


@dataclasses.dataclass
class LowRankWeights:
    """Factorized projection: x @ VT.T gives latents; per-group U reconstructs."""

    VT: torch.Tensor  # (sum(ranks), in_features)
    U: List[torch.Tensor]  # per group: (group_dim, rank_g)
    ranks: List[int]
    bias: Optional[List[torch.Tensor]] = None  # per group: (group_dim,), qwen2 attn bias

    @property
    def in_features(self) -> int:
        return self.VT.shape[1]

    @property
    def out_features(self) -> int:
        return sum(u.shape[0] for u in self.U)

    @property
    def num_groups(self) -> int:
        return len(self.ranks)

    def reconstruct_dense(self) -> torch.Tensor:
        """Recombine to a dense (out, in) weight (for tests / error metrics)."""
        blocks = []
        off = 0
        for u, r in zip(self.U, self.ranks):
            blocks.append(u @ self.VT[off:off + r])
            off += r
        return torch.cat(blocks, dim=0)


def _split_heads(weight: torch.Tensor, num_groups: int) -> torch.Tensor:
    out_features, in_features = weight.shape
    if out_features % num_groups:
        raise ValueError(
            f"out_features {out_features} not divisible by num_groups {num_groups}")
    return weight.reshape(num_groups, out_features // num_groups, in_features)


def _factors(U, S, Vt, ranks):
    """Per group g: L = U_g[:, :r] sqrt(S), R = sqrt(S) Vt_g[:r] (batched
    SVD results over the groups)."""
    Ls, Rs = [], []
    for g, r in enumerate(ranks):
        sqrt_s = torch.sqrt(S[g, :r])
        Ls.append(U[g, :, :r] * sqrt_s[None, :])
        Rs.append(sqrt_s[:, None] * Vt[g, :r, :])
    return Ls, Rs


def _bias(bias, n):
    return None if bias is None else list(bias.reshape(n, -1))


def decompose_svd(weight: torch.Tensor, ranks: Sequence[int],
                  bias: Optional[torch.Tensor] = None) -> LowRankWeights:
    """Plain per-head-group SVD decomposition (reference from_linear,
    svd_linear.py:206-236), one batched SVD over the groups."""
    blocks = _split_heads(weight, len(ranks)).float()
    U, S, Vt = torch.linalg.svd(blocks, full_matrices=False)
    Ls, Rs = _factors(U, S, Vt, ranks)
    return LowRankWeights(VT=torch.cat(Rs, dim=0), U=Ls, ranks=list(ranks),
                          bias=_bias(bias, len(ranks)))


def cholesky_with_psd_repair(gram: torch.Tensor) -> torch.Tensor:
    """f32 Cholesky factor of the Gram matrix, factored in f64, with the
    reference's eigenvalue-shift repair for non-PSD inputs
    (decomposition.py:150-170)."""
    gram = gram.double()
    chol, info = torch.linalg.cholesky_ex(gram)
    if int(info) != 0:
        eigvals = torch.linalg.eigvalsh(gram)
        eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
        chol = torch.linalg.cholesky(gram + (-eigvals[0] + 1e-3) * eye)
    return chol.float()


def decompose_whiten(weight: torch.Tensor, scale: torch.Tensor, ranks: Sequence[int],
                     bias: Optional[torch.Tensor] = None) -> LowRankWeights:
    """Whitened per-head-group decomposition (reference
    _per_head_whiten_decomposition_from_weight, svd_linear.py:6-34).

    `scale` is the Cholesky factor S of the input Gram matrix; the SVD is
    taken of W_g @ S and the right factor mapped back through S^-1 so that
    L @ R ~= W_g in the original input basis."""
    scale = scale.float()
    scale_inv = torch.linalg.inv(scale)
    blocks = _split_heads(weight, len(ranks)).float()
    U, S, Vt = torch.linalg.svd(blocks @ scale, full_matrices=False)
    Ls, Rs = _factors(U, S, Vt @ scale_inv, ranks)
    return LowRankWeights(VT=torch.cat(Rs, dim=0), U=Ls, ranks=list(ranks),
                          bias=_bias(bias, len(ranks)))


def fuse_hadamard(lr: LowRankWeights) -> LowRankWeights:
    """Bake an orthonormal Hadamard rotation Q into each group's (VT_g, U_g)
    pair: latents become Q^T @ latent while U_g @ Q undoes it -- numerically a
    no-op that redistributes latent outliers for quantization (reference
    fused_hadamard_matrix, svd_linear.py:156-168): apply_hadamard on VT_g^T
    (in, r) and on U_g (group_dim, r), in f32, two kernel launches per
    group on CUDA."""
    new_u, vt_blocks = [], []
    off = 0
    for g, r in enumerate(lr.ranks):
        vt_g = lr.VT[off:off + r]  # (r, in)
        vt_blocks.append(apply_hadamard(vt_g.T.float()).T.to(lr.VT.dtype))
        new_u.append(apply_hadamard(lr.U[g].float()).to(lr.U[g].dtype))
        off += r
    return LowRankWeights(VT=torch.cat(vt_blocks, dim=0), U=new_u, ranks=list(lr.ranks),
                          bias=lr.bias)
