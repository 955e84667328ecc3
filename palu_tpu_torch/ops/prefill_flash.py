"""Causal flash attention for chunked prefill with an absolute query offset
and a per-lane kv length (port of
palu_tpu/ops/pallas/prefill_flash.py::prefill_flash; the kernel is
csrc/prefill_flash.cu).

Query row i of lane b attends key positions p with p <= q_offset[b] + i and
p < kv_len[b] (and p > q_offset[b] + i - sliding_window when a window is
set); q-head h reads kv head h * nkv // nh. `prefill_flash` launches the
kernel (Hopper wgmma products, K/V tiles by TMA) for CUDA tensors and runs
`prefill_flash_ref`, its plain version, for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build

__all__ = ["prefill_flash", "prefill_flash_ref"]

LOG2E = math.log2(math.e)


def _lanes(x, b: int, device) -> torch.Tensor:
    t = torch.as_tensor(x, device=device).to(torch.int32)
    return t.expand(b).contiguous() if t.dim() == 0 else t


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, nh, Cq, hd) and k, v (B, nkv, S, hd)")
    b, nh, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or nh % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")


def prefill_flash_ref(q, k, v, q_offset, kv_len, *,
                      sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain version: materialize the masked f32 logits (B, nh, Cq, S),
    softmax, and contract with V. -> (B, nh, Cq, hd) in q's dtype."""
    _check(q, k, v)
    b, nh, cq, hd = q.shape
    nkv, s = k.shape[1], k.shape[2]
    rep = nh // nkv
    dev = q.device
    q_offset = _lanes(q_offset, b, dev)
    kv_len = _lanes(kv_len, b, dev)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(hd)
    pos = torch.arange(s, device=dev)[None, None, None, :]
    q_pos = q_offset.long()[:, None, None, None] + torch.arange(cq, device=dev)[None, None, :, None]
    valid = (pos <= q_pos) & (pos < kv_len.long()[:, None, None, None])
    if sliding_window is not None:
        valid &= pos > q_pos - sliding_window
    logits = torch.where(valid, logits, -1e30)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = torch.where(valid, p, 0.0)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / torch.clamp(den, min=1e-30)
    return out.to(q.dtype)


def prefill_flash(q, k, v, q_offset, kv_len, *,
                  sliding_window: Optional[int] = None) -> torch.Tensor:
    """Causal-with-offset flash attention -> (B, nh, Cq, hd).

    q (B, nh, Cq, hd) roped at absolute positions q_offset + i; k, v
    (B, nkv, S, hd) roped keys and values; q_offset, kv_len: (B,) or
    scalars. CUDA tensors (bf16) launch the kernel; CPU tensors run the
    plain version."""
    if not q.is_cuda:
        return prefill_flash_ref(q, k, v, q_offset, kv_len, sliding_window=sliding_window)
    _check(q, k, v)
    b, nh, cq, hd = q.shape
    nkv, s = k.shape[1], k.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("the prefill kernel takes bf16 q, k, v")
    if hd not in (64, 128):
        raise ValueError(f"the prefill kernel takes hd 64 or 128, got {hd}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must be on one device")
    dev = q.device
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc)):
        raise ValueError("the prefill kernel needs q, k, v on 16-byte boundaries (TMA)")
    off = _lanes(q_offset, b, dev)
    kvl = _lanes(kv_len, b, dev)
    out = torch.empty_like(qc)
    err = build.launcher("prefill_flash", "palu_prefill_flash", "p" * 6 + "i" * 7 + "fp")(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), off.data_ptr(),
        kvl.data_ptr(), b, nh, nkv, cq, s, hd, int(sliding_window or 0),
        float(LOG2E / math.sqrt(hd)), build.stream_ptr(dev))
    build.check(err, "prefill_flash")
    prefill_flash.launches += 1
    return out


prefill_flash.launches = 0
