"""The Palu inference engine in PyTorch (port of palu_tpu/runtime/engine.py:
EngineConfig, build_decode_b, Engine with layer-major chunked prefill,
one-chunk prefill for serving, decode and generate with sampling).

  prefill: per layer, project the whole padded prompt to latents, write
           them to the cache, rebuild dense K/V from the cache (so
           attention sees what decode will read, quantization error
           included), then per chunk: causal flash attention
           (ops/prefill_flash) -> dense o_proj -> MLP.
  decode:  per layer, project one token -> append it to the cache ->
           latent decode attention over the cache -> U_v-fused o_proj ->
           MLP; lm_head once per step.

The cache is quantized (qcfg: rank-major codes with per-row scales, whose
append is quantize-pack-write, ops/cache_append, or with per-chunk scale
rows (group_size > 0, the reference's --lt_group_size), written by a
masked plain write as in the JAX engine; decode reads the codes,
ops/palu_decode) or holds the raw latents in `dtype` (qcfg None, the
paper's low-rank-only mode): seq-major (B, G, S, r) decoded by
ops/palu_decode_fp.palu_decode_fp, or rank-major (B, G, r, S) with
`rank_major_fp`, decoded by palu_decode_fp_t. The raw latents are
appended by a masked write, as the JAX engine does.

Weights may be stored int8 or int4 (EngineConfig.weight_bits, vt_bits,
embed_bits; core/wquant): the engine quantizes its own copy after building
the decode weights, decode runs the GEMV kernels (ops/gemv_int4,
ops/gemv_int8) and prefill multiplies by weights dequantized once per layer.
The kernels run when the engine's tensors are on CUDA; on the CPU their
plain versions run (tests). `_decode_paths` records which decode attention
path ran (and the packed decode's K-path mode) and `_gemv_paths` which
weight paths the decode steps took. The cache is updated in place (the JAX
engine donates it to jit instead).

The engine takes the JAX engine's formulation knobs for the packed decode,
validated and resolved once at build as there: kernel_int8_dots and
kernel_int8_rot pick the kernel's int8 K-path modes over rotation blocks of
`pallas_block` tokens; kernel_v_byte_dot and kernel_fuse_uv are exact
reformulations of the TPU's matrix-unit schedule (the same sums in another
order), so they reach no kernel and the default one runs. Layers whose k and v projections are both dense (the reference's
dense-KV baseline) keep roped K and V and decode with a flash pass over
them: scaled_dot_product_attention on CUDA tensors, its plain chunked
version (ops/attention.dense_flash_decode, the JAX engine's
_dense_flash_decode) on the CPU; their prefill comes with a later slice.
Ragged per-group ranks (the fisher search's output) are zero-padded to each
layer's largest rank when the engine is built (llama.pad_ragged_params), as
in the JAX engine. Qwen2's attention biases (cfg.attention_bias): the q
bias adds to q; the k bias, per q-head (`derived[i]["k_bias"]`, G x hpg x
hd), enters every decode kernel before RoPE; the v bias passes softmax
unchanged, so it becomes one constant row after the fused o_proj
(`derived[i]["o_bias_corr"]`, per-q-head v bias times o_proj, from the
dequantized codes under weight_bits 8 / 4 so that an engine built from
quantized params computes the same); prefill rebuilds K and V with their
biases. Layers with one dense side and per-chunk caches whose chunk does
not divide the rank (JAX's seq-major layout) come with later slices.
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
from ..ops.attention import dense_decode_sdpa, dense_flash_decode
from ..ops.gemv_int8 import MAX_ROWS
from ..ops.palu_decode import k_path_mode, palu_decode
from ..ops.palu_decode_fp import palu_decode_fp, palu_decode_fp_t
from ..ops.prefill_flash import prefill_flash
from . import cache as cache_lib
from . import sampling as sampling_lib

__all__ = ["EngineConfig", "Engine", "build_decode_b"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    s_max: int = 2048
    batch: int = 1
    dtype: Any = torch.bfloat16
    qcfg: Optional[QuantConfig] = None
    decode_chunk: int = 512
    device: str = "cuda"
    # unquantized cache only: store the latents rank-major (B, G, r, S) for
    # the v4 decode kernel (palu_decode_fp_t) instead of seq-major
    # (B, G, S, r) for the v1 kernel (palu_decode_fp)
    rank_major_fp: bool = False
    # 16 keeps weights in `dtype`; 8 stores q_proj, o_proj (and its U_v-fused
    # form), the MLP and lm_head as int8 with per-channel scales; 4 as packed
    # int4 with per-(128-row group, channel) scales (core/wquant)
    weight_bits: int = 16
    # 8 also stores the VT down-projections as int8 (needs weight_bits 8/4)
    vt_bits: int = 16
    # 8 stores the embedding table as int8 per vocabulary row, which also
    # serves a tied lm_head (needs weight_bits 8/4)
    embed_bits: int = 16
    # rotation block of the packed decode's int8 K-path modes; None uses
    # decode_chunk (both rounded down to a divisor of s_max)
    pallas_block: Optional[int] = None
    # the packed decode's formulation knobs (ops/palu_decode): v_byte_dot
    # (None = on for per-row nibble containers) and fuse_uv are exact
    # reformulations and run the default kernel; int8_dots / int8_rot pick
    # the int8 K-path modes
    kernel_v_byte_dot: Optional[bool] = None
    kernel_int8_dots: bool = False
    kernel_fuse_uv: bool = False
    kernel_int8_rot: bool = False


def build_decode_b(u_k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Group the per-kv-head U_k (G, rk, gs * hd) into per-q-head
    reconstruction matrices B: (G, heads_per_group, rk, hd); the `rep`
    q-heads of a kv head share its block (GQA)."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    rep = nh // nkv
    g, rk = u_k.shape[0], u_k.shape[1]
    per_kv = u_k.reshape(g, rk, cfg.head_group_size, hd).permute(0, 2, 1, 3)
    return per_kv.repeat_interleave(rep, dim=1).contiguous()


def _per_q_head(b: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A k or v projection's bias (G, group_dim) per q-head: (G, hpg, hd),
    the `rep` q-heads of a kv head sharing its slice, as build_decode_b."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per_kv = b.float().reshape(b.shape[0], cfg.head_group_size, hd)
    return per_kv.repeat_interleave(nh // nkv, dim=1)


def _o_bias_corr(attn, cfg: ModelConfig, weight_bits: int) -> torch.Tensor:
    """(H,) f32: the per-q-head v bias times o_proj, the constant the v bias
    adds after the fused o_proj (JAX's _build_derived). o_proj enters as the
    engine computes with it: dequantized when the params are quantized, and
    quantized then dequantized when the engine is about to quantize them."""
    o_w = attn["o_proj"]["w"]
    if wquant.is_quantized_weight(o_w):
        o_w = (wquant.unpack_weight4(o_w) if "wq4" in o_w
               else o_w["wq8"].float() * o_w["ws"].float())
    elif weight_bits == 4:
        o_w = wquant.unpack_weight4(wquant.quantize_weight4(o_w))
    elif weight_bits == 8:
        qw = wquant.quantize_weight(o_w)
        o_w = qw["wq8"].float() * qw["ws"].float()
    return _per_q_head(attn["v_proj"]["b"], cfg).reshape(-1) @ o_w.float()


def _kernel_knobs(ecfg: EngineConfig) -> dict:
    """The packed decode's formulation knobs, validated and resolved as the
    JAX engine does: v_byte_dot None turns on for per-row nibble-container
    caches; the others are opt-in and need a per-row (sub-byte) cache."""
    qk = ecfg.qcfg
    per_row = cache_lib.rank_major(qk)
    vbd = ecfg.kernel_v_byte_dot
    if vbd is None:
        vbd = per_row and qk.pack_bits == 4
    elif vbd and not (per_row and qk.pack_bits == 4):
        raise ValueError("kernel_v_byte_dot needs a per-row nibble-container cache "
                         "(QuantConfig.group_size == 0, pack width 4)")
    for name in ("kernel_int8_dots", "kernel_int8_rot"):
        if getattr(ecfg, name) and not (per_row and qk.pack_bits <= 4):
            raise ValueError(f"{name} needs per-row sub-byte codes "
                             "(QuantConfig.group_size == 0, pack width <= 4)")
    if ecfg.kernel_fuse_uv and not per_row:
        raise ValueError("kernel_fuse_uv needs a per-row quantized cache "
                         "(QuantConfig.group_size == 0)")
    knobs = {"v_byte_dot": vbd, "int8_dots": ecfg.kernel_int8_dots,
             "fuse_uv": ecfg.kernel_fuse_uv, "int8_rot": ecfg.kernel_int8_rot}
    return {k: True for k, on in knobs.items() if on}


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
        # ragged (fisher-search) checkpoints: pad per-group ranks up to the
        # layer max so the cache and the kernels see uniform ranks
        params, cfg = llama.pad_ragged_params(params, cfg)
        self._dense = []
        for i, layer in enumerate(params["layers"]):
            lowrank = ["VT" in layer["attn"][which] for which in ("k_proj", "v_proj")]
            if lowrank[0] != lowrank[1]:
                raise NotImplementedError(f"layer {i} has one dense k/v side; the port's "
                                          "engine takes layers with both or neither")
            self._dense.append(not lowrank[0])
            if lowrank[0]:
                for which in ("k_proj", "v_proj"):
                    cache_lib.check_layout(ecfg.qcfg, layer["attn"][which]["U"].shape[1])
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
        self._pallas_block = _largest_divisor(ecfg.s_max, ecfg.pallas_block or self._chunk)
        self._kernel_knobs = _kernel_knobs(ecfg)
        # the packed decode's K-path mode, checked once against every
        # low-rank layer's K rank (int8_rot's int32 sums) and kept with the
        # decode path's name
        self._int8_knobs = {k: True for k in ("int8_dots", "int8_rot")
                            if k in self._kernel_knobs}
        mode = "exact"
        if cache_lib.quantized(ecfg.qcfg):
            for layer, dense in zip(params["layers"], self._dense):
                if not dense:
                    mode = k_path_mode(ecfg.qcfg, layer["attn"]["k_proj"]["U"].shape[1],
                                       cfg.head_dim, **self._int8_knobs)
        self._packed_path = "palu_decode" + ("" if mode == "exact" else f"_{mode}")
        self._fused_append = append_supported(ecfg.qcfg)
        self._decode_paths: set = set()
        self._gemv_paths: set = set()
        inv_freq, rope_scale = rope_mod.inv_freq_and_scale(cfg)
        # default schedule -> None: the decode paths compute it from theta
        self._inv_freq = inv_freq if cfg.rope_scaling else None
        self._rope_scale = float(rope_scale) if cfg.rope_scaling else 1.0
        self.derived = [{} if dense else self._build_derived(l["attn"])
                        for l, dense in zip(params["layers"], self._dense)]
        if ecfg.weight_bits in (8, 4):
            # after the decode weights: b_k comes from the float U
            self.params = wquant.quantize_params(
                params, vt=ecfg.vt_bits == 8, embed=ecfg.embed_bits == 8,
                bits=ecfg.weight_bits)

    def _build_derived(self, attn) -> dict:
        """A low-rank layer's decode weights: b_k (G, hpg, rk, hd), and with
        biases k_bias (G, hpg, hd) and o_bias_corr (H,), in the engine
        dtype; k_bias is kept in f32 after that rounding, as the decode
        wrappers take it, so that no launch casts it."""
        cfg, dt = self.cfg, self.ecfg.dtype
        der = {"b_k": build_decode_b(attn["k_proj"]["U"].float(), cfg).to(dt)}
        if attn["k_proj"].get("b") is not None:
            der["k_bias"] = _per_q_head(attn["k_proj"]["b"], cfg).to(dt).float()
        if attn["v_proj"].get("b") is not None:
            der["o_bias_corr"] = _o_bias_corr(attn, cfg, self.ecfg.weight_bits).to(dt)
        return der

    def init_cache(self):
        return cache_lib.init_cache(self.cfg, self.ecfg.batch, self.ecfg.s_max,
                                    self.ecfg.qcfg, device=self.device, dtype=self.ecfg.dtype,
                                    rank_major_fp=self.ecfg.rank_major_fp)

    def _encode(self, lat):
        """Latents (B, G, S, r) -> the cache's buffer update."""
        return cache_lib._encode(lat, self.ecfg.qcfg, self.ecfg.dtype, self.ecfg.rank_major_fp)

    # -- prefill -------------------------------------------------------------

    def _lm_head_logits(self, x, paths=None):
        x = llama.rms_norm(x, self.params["final_norm"], self.cfg.rms_norm_eps)
        return wdot(x, tied_head(self.params), paths)

    def _reconstruct_dense(self, entry, attn, rk: int, rv: int, n: int):
        """Read back (dequantizing) + reconstruct (per kv head) + RoPE the
        first n cache positions of a layer into dense (B, nkv, n, hd) K and
        V."""
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
        if any(self._dense):
            raise NotImplementedError("prefill of dense k/v layers comes with a later slice "
                                      "(ROADMAP A item 2); decode them from a seeded cache")
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
                cache_lib.write_at_lanes(entry[side], self._encode(lat), offset)
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
                q = wdot(h[:, sl], q_w)
                if attn["q_proj"].get("b") is not None:
                    q = q + attn["q_proj"]["b"]
                q = q.reshape(b, c_len, nh, hd)
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

    @torch.no_grad()
    def prefill_chunk(self, ids_chunk, cache, off: int):
        """Advance one prefill chunk ids_chunk (B, chunk) at sequence offset
        `off` through every layer (the serving loop interleaves these with
        decode steps, so admitting a long prompt never stalls the running
        lanes). ids_chunk must be padded to the engine chunk; pad positions
        are causally invisible. Returns (the chunk's logits (B, chunk, V),
        cache); the caller tracks the real length and sets cache["length"]
        when the prompt is complete."""
        ids = torch.as_tensor(np.asarray(ids_chunk), device=self.device)
        b, c_len = ids.shape
        if b != self.ecfg.batch or c_len != self._chunk:
            raise ValueError(f"chunk must be ({self.ecfg.batch}, {self._chunk}), got "
                             f"{tuple(ids.shape)}")
        if off < 0 or off + c_len > self.ecfg.s_max:
            raise ValueError(f"chunk at {off} does not fit s_max {self.ecfg.s_max}")
        return self._prefill_layer_major(cache, ids[:, None, :], off), cache

    # -- decode --------------------------------------------------------------

    def _append(self, bufs, lat, pos_w, writeable):
        """Masked write of one token column lat (B, G, 1, r): quantized and
        packed by the append kernel where it covers the cache, else the
        plain write (raw latents, exact 3-bit packing), as in the JAX
        engine."""
        if self._fused_append:
            append_token_quantized(lat[:, :, 0, :], bufs["codes_t"], bufs["scale_t"],
                                   pos_w, writeable, qcfg=self.ecfg.qcfg, rank=lat.shape[-1],
                                   zero=bufs.get("zero_t"))
        else:
            cache_lib.write_at_lanes_masked(bufs, self._encode(lat), pos_w, writeable)

    def _decode_attention(self, q, entry, attn, der, kv_len):
        cfg, ecfg = self.cfg, self.ecfg
        b, nh, _ = q.shape
        rk = attn["k_proj"]["U"].shape[1]
        rv = attn["v_proj"]["U"].shape[1]
        kb, vb = entry["k"], entry["v"]
        side = "kernel" if q.is_cuda else "plain"
        kw = dict(theta=cfg.rope_theta, sliding_window=cfg.sliding_window,
                  inv_freq=self._inv_freq, rope_scale=self._rope_scale,
                  k_bias=der.get("k_bias"))
        if cache_lib.quantized(ecfg.qcfg):
            self._decode_paths.add(f"{self._packed_path}-{side}")
            lat_out = palu_decode(
                q, der["b_k"], kb["codes_t"], kb["scale_t"], vb["codes_t"], vb["scale_t"],
                kv_len, qcfg=ecfg.qcfg, rk=rk, rv=rv, xk_zero=kb.get("zero_t"),
                xv_zero=vb.get("zero_t"), block_s=self._pallas_block, **self._int8_knobs,
                **kw)
        else:
            fn, key = ((palu_decode_fp_t, "lat_t") if ecfg.rank_major_fp
                       else (palu_decode_fp, "lat"))
            self._decode_paths.add(f"{fn.__name__}-{side}")
            lat_out = fn(q, der["b_k"], kb[key], vb[key], kv_len, **kw)
        out = wdot(lat_out.to(ecfg.dtype).reshape(b, nh * rv), attn["o_proj"]["w_fused"],
                   self._gemv_paths)
        if "o_bias_corr" in der:
            out = out + der["o_bias_corr"]
        return out

    def _dense_attention(self, q, entry, attn, kv_len):
        """Decode attention of a dense layer over its roped K/V, then the
        dense o_proj."""
        cfg = self.cfg
        b = q.shape[0]
        k, v = entry["k"]["lat"], entry["v"]["lat"]
        if q.is_cuda:
            self._decode_paths.add("dense_sdpa-kernel")
            out = dense_decode_sdpa(q, k, v, kv_len, cfg.sliding_window)
        else:
            self._decode_paths.add("dense_flash-plain")
            out = dense_flash_decode(q, k, v, kv_len, self._chunk, cfg.sliding_window)
        return wdot(out.to(self.ecfg.dtype).reshape(b, -1), attn["o_proj"]["w"],
                    self._gemv_paths)

    def _append_dense(self, entry, h, attn, cos, sin, pos_w, writeable):
        """Masked write of one token's roped K and its V (B, n_kv, 1, hd)."""
        cfg, dt = self.cfg, self.ecfg.dtype
        b = h.shape[0]
        shape = (b, 1, cfg.num_key_value_heads, cfg.head_dim)
        k = llama.project_kv(h, attn["k_proj"], self._gemv_paths).reshape(shape)
        k = llama.apply_rope(k.float(), cos, sin).to(dt).transpose(1, 2)
        v = llama.project_kv(h, attn["v_proj"], self._gemv_paths).reshape(shape)
        cache_lib.write_at_lanes_masked(entry["k"], {"lat": k}, pos_w, writeable)
        cache_lib.write_at_lanes_masked(entry["v"], {"lat": v.to(dt).transpose(1, 2)}, pos_w,
                                        writeable)

    @torch.no_grad()
    def decode(self, token_ids, cache, active=None):
        """One decode step for token_ids (B, 1), host ids or a device
        tensor (kept on the device). `active` (B,) bool marks lanes that
        append and advance; inactive and full lanes get a no-op write and a
        frozen length, decided on the device."""
        cfg, ecfg = self.cfg, self.ecfg
        dev = self.device
        if not isinstance(token_ids, torch.Tensor):
            token_ids = torch.as_tensor(np.asarray(token_ids))
        token_ids = token_ids.to(dev)
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

        for p_layer, entry, der, dense in zip(self.params["layers"], cache["layers"],
                                              self.derived, self._dense):
            attn = p_layer["attn"]
            h = llama.rms_norm(x, p_layer["input_norm"], cfg.rms_norm_eps)
            q = wdot(h, attn["q_proj"]["w"], self._gemv_paths)
            if attn["q_proj"].get("b") is not None:
                q = q + attn["q_proj"]["b"]
            q = q.reshape(b, 1, nh, hd)
            q = llama.apply_rope(q.float(), cos, sin).to(ecfg.dtype)[:, 0]
            if dense:
                self._append_dense(entry, h, attn, cos, sin, pos_w, writeable)
                x = x + self._dense_attention(q, entry, attn, kv_len)[:, None, :]
            else:
                for side, proj in (("k", "k_proj"), ("v", "v_proj")):
                    lat = llama.project_kv(h, attn[proj], self._gemv_paths).transpose(1, 2)
                    self._append(entry[side], lat, pos_w, writeable)
                x = x + self._decode_attention(q, entry, attn, der, kv_len)[:, None, :]
            h2 = llama.rms_norm(x, p_layer["post_norm"], cfg.rms_norm_eps)
            x = x + llama.mlp_forward(h2, p_layer["mlp"], self._gemv_paths)

        cache["length"] = kv_len.to(torch.int32)
        return self._lm_head_logits(x, self._gemv_paths), cache

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int, eos_token_id: Optional[int] = None,
                 sampling: Optional[sampling_lib.SamplingParams] = None,
                 seed: int = 0) -> np.ndarray:
        """Chunked prefill, then one decode step per new token. Greedy, or
        with `sampling` (temperature > 0) temperature / top-k / top-p
        sampling whose Gumbel noise for step t is drawn from a generator
        seeded with (seed, t). Returns the new token ids (B, n) as numpy."""
        input_ids = np.asarray(input_ids)
        max_new_tokens = min(max_new_tokens, self.ecfg.s_max - input_ids.shape[1])
        sampled = sampling is not None and sampling.temperature > 0.0

        def pick(logits, step):
            lg = logits[:, -1]
            if sampled:
                noise = sampling_lib.gumbel_noise(lg.shape, lg.device, seed, step)
                return sampling_lib.sample(lg, sampling, noise)[:, None].cpu().numpy()
            return lg.argmax(dim=-1)[:, None].cpu().numpy()

        logits, cache = self.prefill_auto(input_ids)
        out_tokens = []
        next_tok = pick(logits, 0)
        for step in range(max_new_tokens):
            out_tokens.append(next_tok)
            if eos_token_id is not None and (next_tok == eos_token_id).all():
                break
            logits, cache = self.decode(next_tok, cache)
            next_tok = pick(logits, step + 1)
        return np.concatenate(out_tokens, axis=1)
