"""The Palu inference engine in PyTorch (port of palu_tpu/runtime/engine.py:
EngineConfig, build_decode_b, Engine with layer-major chunked prefill,
decode and greedy generate).

  prefill: per layer, project the whole padded prompt to latents, write
           them to the quantized cache, rebuild dense K/V from the cache
           (so attention sees what decode will read, quantization error
           included), then per chunk: causal flash attention
           (ops/prefill_flash) -> dense o_proj -> MLP.
  decode:  per layer, project one token -> quantize-pack-append
           (ops/cache_append) -> latent decode attention over the packed
           cache (ops/palu_decode) -> U_v-fused o_proj -> MLP; lm_head
           once per step.

Weights may be stored int8 or int4 (EngineConfig.weight_bits, vt_bits,
embed_bits; core/wquant): the engine quantizes its own copy after building
the decode weights, decode runs the GEMV kernels (ops/gemv_int4,
ops/gemv_int8) and prefill multiplies by weights dequantized once per layer.
The kernels run when the engine's tensors are on CUDA; on the CPU their
plain versions run (tests). `_decode_paths` records which decode attention
path ran and `_gemv_paths` which weight paths the decode steps took.
The cache is updated in place (the JAX engine donates it to jit instead).
Qwen2 k/v biases, ragged ranks, per-chunk scales and sampling come with
later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..core.quant import QuantConfig
from ..core import wquant
from ..core.wquant import dense_operand, embed_rows, tied_head, wdot
from ..models import llama
from ..models import rope as rope_mod
from ..models.config import ModelConfig
from ..ops import build
from ..ops.cache_append import append_supported, append_token_quantized
from ..ops.gemv_int8 import MAX_ROWS
from ..ops.palu_decode import palu_decode
from ..ops.prefill_flash import prefill_flash
from . import cache as cache_lib

__all__ = ["EngineConfig", "Engine", "build_decode_b"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    s_max: int = 2048
    batch: int = 1
    dtype: Any = torch.bfloat16
    qcfg: Optional[QuantConfig] = None
    decode_chunk: int = 512
    device: str = "cuda"
    # 16 keeps weights in `dtype`; 8 stores q_proj, o_proj (and its U_v-fused
    # form), the MLP and lm_head as int8 with per-channel scales; 4 as packed
    # int4 with per-(128-row group, channel) scales (core/wquant)
    weight_bits: int = 16
    # 8 also stores the VT down-projections as int8 (needs weight_bits 8/4)
    vt_bits: int = 16
    # 8 stores the embedding table as int8 per vocabulary row, which also
    # serves a tied lm_head (needs weight_bits 8/4)
    embed_bits: int = 16


def build_decode_b(u_k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Group the per-kv-head U_k (G, rk, gs * hd) into per-q-head
    reconstruction matrices B: (G, heads_per_group, rk, hd); the `rep`
    q-heads of a kv head share its block (GQA)."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    rep = nh // nkv
    g, rk = u_k.shape[0], u_k.shape[1]
    per_kv = u_k.reshape(g, rk, cfg.head_group_size, hd).permute(0, 2, 1, 3)
    return per_kv.repeat_interleave(rep, dim=1).contiguous()


def _largest_divisor(n: int, at_most: int) -> int:
    d = max(1, min(at_most, n))
    while n % d:
        d -= 1
    return d


class Engine:
    """Latent-KV generation engine for one model: params, derived decode
    weights, and the prefill / decode / generate entry points."""

    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig):
        self.device = build.require_cuda(ecfg.device)
        if not cache_lib.rank_major(ecfg.qcfg):
            raise NotImplementedError(
                "the port's engine serves a per-row quantized latent cache "
                "(QuantConfig(bits < 16, group_size=0)); other caches come "
                "with a later slice")
        if cfg.attention_bias:
            raise NotImplementedError("k/v biases (Qwen2) come with a later slice")
        for i, layer in enumerate(params["layers"]):
            for which in ("k_proj", "v_proj"):
                if "VT" not in layer["attn"][which]:
                    raise NotImplementedError(
                        f"layer {i} {which} is dense; the engine needs low-rank k/v")
                cfg.uniform_rank_for(i, which)  # raises on ragged ranks
        if ecfg.weight_bits not in (16, 8, 4):
            raise ValueError(f"weight_bits must be 16, 8 or 4, got {ecfg.weight_bits}")
        if ecfg.vt_bits not in (16, 8):
            raise ValueError(f"vt_bits must be 16 or 8, got {ecfg.vt_bits}")
        if ecfg.vt_bits == 8 and ecfg.weight_bits == 16:
            raise ValueError("vt_bits=8 requires weight_bits=8 or 4")
        if ecfg.embed_bits not in (16, 8):
            raise ValueError(f"embed_bits must be 16 or 8, got {ecfg.embed_bits}")
        if ecfg.embed_bits == 8 and ecfg.weight_bits == 16:
            raise ValueError("embed_bits=8 requires weight_bits=8 or 4")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        # Chunks read fixed-size slices of the cache, so the chunk must
        # divide s_max: take the largest divisor not above decode_chunk.
        self._chunk = _largest_divisor(ecfg.s_max, ecfg.decode_chunk)
        self._fused_append = append_supported(ecfg.qcfg)
        self._decode_paths: set = set()
        self._gemv_paths: set = set()
        inv_freq, rope_scale = rope_mod.inv_freq_and_scale(cfg)
        # default schedule -> None: the decode paths compute it from theta
        self._inv_freq = inv_freq if cfg.rope_scaling else None
        self._rope_scale = float(rope_scale) if cfg.rope_scaling else 1.0
        self.derived = [
            {"b_k": build_decode_b(l["attn"]["k_proj"]["U"].float(), cfg).to(ecfg.dtype)}
            for l in params["layers"]
        ]
        if ecfg.weight_bits in (8, 4):
            # after the decode weights: b_k comes from the float U
            self.params = wquant.quantize_params(
                params, vt=ecfg.vt_bits == 8, embed=ecfg.embed_bits == 8,
                bits=ecfg.weight_bits)

    def init_cache(self):
        return cache_lib.init_cache(self.cfg, self.ecfg.batch, self.ecfg.s_max,
                                    self.ecfg.qcfg, device=self.device)

    # -- prefill -------------------------------------------------------------

    def _lm_head_logits(self, x, paths=None):
        x = llama.rms_norm(x, self.params["final_norm"], self.cfg.rms_norm_eps)
        return wdot(x, tied_head(self.params), paths)

    def _reconstruct_dense(self, entry, attn, rk: int, rv: int, n: int):
        """Dequantize + reconstruct (per kv head) + RoPE the first n cache
        positions of a layer into dense (B, nkv, n, hd) K and V."""
        cfg, ecfg = self.cfg, self.ecfg
        nkv, hd = cfg.num_key_value_heads, cfg.head_dim
        lat_k = cache_lib.decode_latents(cache_lib.seq_slice(entry["k"], 0, n),
                                         ecfg.qcfg, rk, ecfg.dtype).transpose(1, 2)
        b = lat_k.shape[0]
        k = llama.reconstruct_kv(lat_k, attn["k_proj"]).reshape(b, n, nkv, hd)
        pos = torch.arange(n, device=k.device)[None, :].expand(b, n)
        cos, sin = llama.rope_cos_sin_for(cfg, pos)
        k = llama.apply_rope(k.float(), cos, sin).to(ecfg.dtype)
        lat_v = cache_lib.decode_latents(cache_lib.seq_slice(entry["v"], 0, n),
                                         ecfg.qcfg, rv, ecfg.dtype).transpose(1, 2)
        v = llama.reconstruct_kv(lat_v, attn["v_proj"]).reshape(b, n, nkv, hd)
        return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def _prefill_layer_major(self, cache, ids: torch.Tensor, base: int):
        """Layer-major prefill of ids (B, m, C) written at offset `base`: the
        whole run advances one layer at a time, so each layer rebuilds its
        K/V prefix once; attention + MLP then run chunk by chunk. Returns
        the logits of the run's last chunk (B, C, V)."""
        cfg, ecfg = self.cfg, self.ecfg
        b, m, c_len = ids.shape
        run = m * c_len
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        dev = self.device
        n_read = -(-(base + run) // self._chunk) * self._chunk
        x = embed_rows(self.params["embed"], ids.reshape(b, run), ecfg.dtype)
        positions = base + torch.arange(run, device=dev)[None, :].expand(b, run)
        cos_all, sin_all = llama.rope_cos_sin_for(cfg, positions)
        offset = torch.full((b,), base, dtype=torch.int32, device=dev)

        for p_layer, entry in zip(self.params["layers"], cache["layers"]):
            attn = p_layer["attn"]
            h = llama.rms_norm(x, p_layer["input_norm"], cfg.rms_norm_eps)
            for side, proj in (("k", "k_proj"), ("v", "v_proj")):
                lat = llama.project_kv(h, attn[proj]).transpose(1, 2)  # (B, G, run, r)
                cache_lib.write_at_lanes(entry[side],
                                         cache_lib._encode(lat, ecfg.qcfg), offset)
            rk = attn["k_proj"]["U"].shape[1]
            rv = attn["v_proj"]["U"].shape[1]
            k_full, v_full = self._reconstruct_dense(entry, attn, rk, rv, n_read)
            q_w, o_w, mlp = attn["q_proj"]["w"], attn["o_proj"]["w"], p_layer["mlp"]
            if b * c_len > MAX_ROWS:
                # the chunk loop takes wdot's matmul paths: dequantize once
                q_w, o_w = dense_operand(q_w, ecfg.dtype), dense_operand(o_w, ecfg.dtype)
                mlp = {k: dense_operand(w, ecfg.dtype) for k, w in mlp.items()}

            for c in range(m):
                sl = slice(c * c_len, (c + 1) * c_len)
                q = wdot(h[:, sl], q_w).reshape(b, c_len, nh, hd)
                q = llama.apply_rope(q.float(), cos_all[:, sl], sin_all[:, sl]).to(ecfg.dtype)
                q_off = base + c * c_len
                out = prefill_flash(q.transpose(1, 2), k_full, v_full,
                                    torch.full((b,), q_off, dtype=torch.int32, device=dev),
                                    torch.full((b,), q_off + c_len, dtype=torch.int32, device=dev),
                                    sliding_window=cfg.sliding_window)
                xc = x[:, sl] + wdot(out.transpose(1, 2).reshape(b, c_len, nh * hd), o_w)
                h2 = llama.rms_norm(xc, p_layer["post_norm"], cfg.rms_norm_eps)
                x[:, sl] = xc + llama.mlp_forward(h2, mlp)

        cache["length"] = torch.full((b,), base + run, dtype=torch.int32, device=dev)
        return self._lm_head_logits(x[:, (m - 1) * c_len:])

    @torch.no_grad()
    def prefill_chunked(self, input_ids, chunk_size: int = 512, cache=None):
        """Stream a prompt through fixed-size chunks (one layer-major run;
        pad positions are causally invisible and decode overwrites them).
        Returns (last-token logits (B, 1, V), cache)."""
        input_ids = np.asarray(input_ids)
        b, total = input_ids.shape
        if b != self.ecfg.batch:
            raise ValueError(f"batch {b} != engine batch {self.ecfg.batch}")
        if total > self.ecfg.s_max:
            raise ValueError(f"prompt {total} exceeds s_max {self.ecfg.s_max}")
        if self.ecfg.s_max % chunk_size:
            raise ValueError(f"chunk_size {chunk_size} must divide s_max {self.ecfg.s_max}")
        if cache is None:
            cache = self.init_cache()
        n_chunks = -(-total // chunk_size)
        padded = np.zeros((b, n_chunks * chunk_size), np.int64)
        padded[:, :total] = input_ids
        ids = torch.as_tensor(padded, device=self.device).reshape(b, n_chunks, chunk_size)
        logits = self._prefill_layer_major(cache, ids, 0)
        last = logits[:, (total - 1) % chunk_size][:, None]
        cache["length"] = torch.full((b,), total, dtype=torch.int32, device=self.device)
        return last, cache

    def prefill_auto(self, input_ids, cache=None):
        return self.prefill_chunked(input_ids, chunk_size=self._chunk, cache=cache)

    # -- decode --------------------------------------------------------------

    def _append(self, bufs, lat, pos_w, writeable):
        """Quantize + pack + masked write of one token column lat (B, G, 1, r)."""
        qcfg = self.ecfg.qcfg
        if self._fused_append:
            append_token_quantized(lat[:, :, 0, :], bufs["codes_t"], bufs["scale_t"],
                                   pos_w, writeable, qcfg=qcfg, rank=lat.shape[-1],
                                   zero=bufs.get("zero_t"))
        else:  # exact 3-bit packing: the plain append, as in the JAX engine
            cache_lib.write_at_lanes_masked(bufs, cache_lib._encode(lat, qcfg),
                                            pos_w, writeable)

    def _decode_attention(self, q, entry, attn, der, kv_len):
        cfg, ecfg = self.cfg, self.ecfg
        b, nh, _ = q.shape
        rk = attn["k_proj"]["U"].shape[1]
        rv = attn["v_proj"]["U"].shape[1]
        kb, vb = entry["k"], entry["v"]
        self._decode_paths.add("palu_decode-kernel" if q.is_cuda else "palu_decode-plain")
        lat_out = palu_decode(
            q, der["b_k"], kb["codes_t"], kb["scale_t"], vb["codes_t"], vb["scale_t"],
            kv_len, qcfg=ecfg.qcfg, rk=rk, rv=rv, theta=cfg.rope_theta,
            sliding_window=cfg.sliding_window, inv_freq=self._inv_freq,
            rope_scale=self._rope_scale, xk_zero=kb.get("zero_t"),
            xv_zero=vb.get("zero_t"))
        return wdot(lat_out.to(ecfg.dtype).reshape(b, nh * rv), attn["o_proj"]["w_fused"],
                    self._gemv_paths)

    @torch.no_grad()
    def decode(self, token_ids, cache, active=None):
        """One decode step for token_ids (B, 1). `active` (B,) bool marks
        lanes that append and advance; inactive and full lanes get a no-op
        write and a frozen length, decided on the device."""
        cfg, ecfg = self.cfg, self.ecfg
        dev = self.device
        token_ids = torch.as_tensor(np.asarray(token_ids), device=dev)
        b = token_ids.shape[0]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=dev)
        pos = cache["length"]
        writeable = active & (pos < ecfg.s_max)
        pos_w = torch.clamp(pos, max=ecfg.s_max - 1)
        kv_len = torch.where(writeable, pos + 1, pos)
        x = embed_rows(self.params["embed"], token_ids, ecfg.dtype)  # (B, 1, H)
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        cos, sin = llama.rope_cos_sin_for(cfg, pos[:, None])

        for p_layer, entry, der in zip(self.params["layers"], cache["layers"],
                                       self.derived):
            attn = p_layer["attn"]
            h = llama.rms_norm(x, p_layer["input_norm"], cfg.rms_norm_eps)
            q = wdot(h, attn["q_proj"]["w"], self._gemv_paths).reshape(b, 1, nh, hd)
            q = llama.apply_rope(q.float(), cos, sin).to(ecfg.dtype)[:, 0]
            for side, proj in (("k", "k_proj"), ("v", "v_proj")):
                lat = llama.project_kv(h, attn[proj], self._gemv_paths).transpose(1, 2)
                self._append(entry[side], lat, pos_w, writeable)
            x = x + self._decode_attention(q, entry, attn, der, kv_len)[:, None, :]
            h2 = llama.rms_norm(x, p_layer["post_norm"], cfg.rms_norm_eps)
            x = x + llama.mlp_forward(h2, p_layer["mlp"], self._gemv_paths)

        cache["length"] = kv_len.to(torch.int32)
        return self._lm_head_logits(x, self._gemv_paths), cache

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy generation: chunked prefill, then one decode step per new
        token. Returns the new token ids (B, n) as numpy."""
        input_ids = np.asarray(input_ids)
        max_new_tokens = min(max_new_tokens, self.ecfg.s_max - input_ids.shape[1])
        logits, cache = self.prefill_auto(input_ids)
        out_tokens = []
        next_tok = logits[:, -1].argmax(dim=-1)[:, None].cpu().numpy()
        for _ in range(max_new_tokens):
            out_tokens.append(next_tok)
            if eos_token_id is not None and (next_tok == eos_token_id).all():
                break
            logits, cache = self.decode(next_tok, cache)
            next_tok = logits[:, -1].argmax(dim=-1)[:, None].cpu().numpy()
        return np.concatenate(out_tokens, axis=1)
