"""The Palu inference engine in PyTorch (port of palu_tpu/runtime/engine.py:
EngineConfig, build_decode_b, Engine with layer-major chunked prefill,
one-chunk prefill for serving, one-shot and bucketed prefill, decode and
generate with sampling).

  prefill: per layer, project the whole padded prompt to latents, write
           them to the cache, rebuild dense K/V from the cache (so
           attention sees what decode will read, quantization error
           included), then per chunk: causal flash attention
           (ops/prefill_flash) -> dense o_proj -> MLP. The chunked
           prefill takes low-rank k/v layers only, as in JAX; the one-shot
           prefill (`prefill`, and `prefill_bucketed`, which right-pads
           the prompt to a power-of-two bucket) takes any layer: a dense
           side writes roped K / raw V to the cache, a low-rank side its
           latents, read back as in the chunked prefill; the whole prompt
           then runs one causal attention (the prefill_flash kernel on
           CUDA, ops/attention.mha_prefill on the CPU). prefill_auto
           streams chunks for all-low-rank engines and takes the bucketed
           one-shot prefill otherwise, as JAX decides.
  decode:  per layer, project one token -> append it to the cache ->
           latent decode attention over the cache -> U_v-fused o_proj ->
           MLP; lm_head once per step.

The cache is quantized (qcfg: rank-major codes with per-row scales, whose
append is quantize-pack-write, one ops/cache_append.KVAppend launch a
layer for both sides, or with per-chunk scale
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
_dense_flash_decode) on the CPU. A layer with one dense side builds and
prefills, and `decode` refuses it with a ValueError: the JAX engine has no
decode for such a layer (its decode attention reads both sides' U).
Ragged per-group ranks (the fisher search's output) are zero-padded to each
layer's largest rank when the engine is built (llama.pad_ragged_params), as
in the JAX engine. The decode reconstruction B (`derived[i]["b_k"]`) and
the k bias are kept per kv-head (G x hpg / rep x ...; JAX keeps them per
q-head), built once here: every latent decode takes that form and its
kernel rebuilds K once per kv-head. Qwen2's attention
biases (cfg.attention_bias): the q
bias adds to q; the k bias (`derived[i]["k_bias"]`), enters every decode
kernel before RoPE; the v bias passes softmax
unchanged, so it becomes one constant row after the fused o_proj
(`derived[i]["o_bias_corr"]`, per-q-head v bias times o_proj, from the
dequantized codes under weight_bits 8 / 4 so that an engine built from
quantized params computes the same); prefill rebuilds K and V with their
biases. Per-chunk caches whose chunk is not a multiple of 8 dividing the
rank take JAX's seq-major layout (runtime/cache.py), which no kernel
reads, in JAX as here: their append is the plain masked write and their
decode ops/attention.flash_decode_latent over decode_latents chunks, in
PyTorch on either device (`_decode_paths`: "flash_decode_latent-plain").

Layer-stacked decode (EngineConfig.stacked_decode, JAX's scanned decode):
the weights and the cache carry a leading (L, ...) axis
(params["layers_stacked"], cache_lib.init_cache_stacked); each layer
computes with views of the stacked weights, and the decode kernels read
the whole stacked cache with layer_idx = the layer (no per-layer slice of
the cache reaches a kernel). None resolves to False, as in JAX; True
raises when the configuration cannot stack (_stacked_ineligible_reason).
An engine built from another stacked engine's params is stacked.

Sequence-parallel decode (EngineConfig.mesh with a `seq` axis named by
seq_axis, parallel/mesh.py): this process holds S_local = s_max / n of
every cache column range of its data lanes (runtime/cache.py) and decodes
them with pos_offset and return_stats; ops/attention.py merges the shards
over the axis's process group. A token's append lands only on the process
that owns its position. Prefill runs whole on every process (the same
computation), each keeping its own columns; a prefill chunk past offset 0
would need the other shards' columns and comes with a later slice.
A mesh without a seq axis shards the batch lanes over `data` only; a
`model` axis above 1 (tensor parallelism) comes with a later slice.
"""

from __future__ import annotations

import dataclasses
import weakref
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
from ..ops.cache_append import KVAppend, append_supported
from ..ops.attention import (dense_decode_sdpa, dense_flash_decode, flash_decode_latent,
                             flash_decode_latent_seq_sharded,
                             flash_decode_latent_seq_sharded_rank_major, mha_prefill)
from ..ops.gemv_int8 import MAX_ROWS
from ..ops.palu_decode import _expand, k_path_mode, palu_decode
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
    # a torch.distributed DeviceMesh (parallel/mesh.py): "data" shards the
    # batch lanes (batch is the global batch), "seq" (named by seq_axis)
    # the cache's sequence; a "model" axis must be 1
    mesh: Any = None
    seq_axis: Optional[str] = None
    # stack the layers' weights and cache on a leading axis and decode with
    # the kernels' layer_idx; None resolves to False (the JAX default)
    stacked_decode: Optional[bool] = None


def build_decode_b(u_k: torch.Tensor, cfg: ModelConfig, compact: bool = False) -> torch.Tensor:
    """Group the per-kv-head U_k (G, rk, gs * hd) into per-q-head
    reconstruction matrices B: (G, heads_per_group, rk, hd); the `rep`
    q-heads of a kv head share its block (GQA). compact: one block per
    kv-head, (G, gs, rk, hd), the form palu_decode also takes."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    g, rk = u_k.shape[0], u_k.shape[1]
    per_kv = u_k.reshape(g, rk, cfg.head_group_size, hd).permute(0, 2, 1, 3)
    return (per_kv if compact else per_kv.repeat_interleave(nh // nkv, dim=1)).contiguous()


def _per_q_head(b: torch.Tensor, cfg: ModelConfig, compact: bool = False) -> torch.Tensor:
    """A k or v projection's bias (G, group_dim) per q-head: (G, hpg, hd),
    the `rep` q-heads of a kv head sharing its slice, as build_decode_b
    (compact: per kv-head, (G, gs, hd))."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per_kv = b.float().reshape(b.shape[0], cfg.head_group_size, hd)
    return per_kv if compact else per_kv.repeat_interleave(nh // nkv, dim=1)


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


def _stack_layers(layers: list):
    """Per-layer param trees -> one tree with a leading (L,) axis on every
    tensor leaf (None leaves stay None); raises unless the layers share one
    structure, shape and dtype per leaf."""
    first = layers[0]
    if isinstance(first, dict):
        if any(not isinstance(n, dict) or n.keys() != first.keys() for n in layers):
            raise ValueError("stacked_decode requires homogeneous layers")
        return {k: _stack_layers([n[k] for n in layers]) for k in first}
    if first is None:
        if any(n is not None for n in layers):
            raise ValueError("stacked_decode requires homogeneous layers")
        return None
    if any(not isinstance(n, torch.Tensor) or n.shape != first.shape or n.dtype != first.dtype
           for n in layers):
        raise ValueError("stacked_decode requires homogeneous layers")
    return torch.stack(layers)


def _layer_views(stacked, n_layers: int) -> list:
    """Per-layer trees of views into a stacked tree (no copy)."""
    def view(node, i):
        if isinstance(node, dict):
            return {k: view(v, i) for k, v in node.items()}
        return None if node is None else node[i]
    return [view(stacked, i) for i in range(n_layers)]


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
        pre_stacked = "layers_stacked" in params
        if pre_stacked:
            # another stacked engine's params: stacked (and quantized
            # under weight_bits 8 / 4) already
            layers = _layer_views(params["layers_stacked"], cfg.num_hidden_layers)
        else:
            # ragged (fisher-search) checkpoints: pad per-group ranks up to
            # the layer max so the cache and the kernels see uniform ranks
            params, cfg = llama.pad_ragged_params(params, cfg)
            layers = params["layers"]
        # per layer, whether its k and v projections are dense; _dense: both
        self._dense_sides = [tuple("VT" not in layer["attn"][w] for w in ("k_proj", "v_proj"))
                             for layer in layers]
        self._dense = [all(d) for d in self._dense_sides]
        self._one_sided = [i for i, d in enumerate(self._dense_sides) if any(d) and not all(d)]
        self._all_lowrank = not any(map(any, self._dense_sides))
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
        self._init_mesh()
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
            for layer, sides in zip(layers, self._dense_sides):
                if not any(sides):
                    mode = k_path_mode(ecfg.qcfg, layer["attn"]["k_proj"]["U"].shape[1],
                                       cfg.head_dim, **self._int8_knobs)
        self._packed_path = "palu_decode" + ("" if mode == "exact" else f"_{mode}")
        self._fused_append = append_supported(ecfg.qcfg)
        self._append_memo = None  # (weakrefs of a cache's buffers, its layers' KVAppend)
        self._decode_paths: set = set()
        self._gemv_paths: set = set()
        inv_freq, rope_scale = rope_mod.inv_freq_and_scale(cfg)
        # default schedule -> None: the decode paths compute it from theta
        self._inv_freq = inv_freq if cfg.rope_scaling else None
        self._rope_scale = float(rope_scale) if cfg.rope_scaling else 1.0
        self.derived = [{} if any(sides) else self._build_derived(l["attn"])
                        for l, sides in zip(layers, self._dense_sides)]
        if pre_stacked:
            self._stacked = True
            if ecfg.stacked_decode is False:
                raise ValueError("params are layer-stacked; stacked_decode cannot be "
                                 "disabled for them")
            reason = self._stacked_ineligible_reason()
            if reason:
                raise ValueError(f"stacked params but ineligible config: {reason}")
        else:
            if ecfg.weight_bits in (8, 4):
                # after the decode weights: b_k comes from the float U
                self.params = wquant.quantize_params(
                    params, vt=ecfg.vt_bits == 8, embed=ecfg.embed_bits == 8,
                    bits=ecfg.weight_bits)
            reason = self._stacked_ineligible_reason()
            if ecfg.stacked_decode and reason:
                raise ValueError(f"stacked_decode unavailable: {reason}")
            self._stacked = bool(ecfg.stacked_decode)  # None -> False, as in JAX
            if self._stacked:
                new = dict(self.params)
                new["layers_stacked"] = _stack_layers(new.pop("layers"))
                self.params = new
        self._layers = (_layer_views(self.params["layers_stacked"], cfg.num_hidden_layers)
                        if self._stacked else self.params["layers"])
        if self._stacked:
            self._build_derived_stacks()

    def _init_mesh(self) -> None:
        """The mesh's share of this process: its data lanes (self._lanes,
        self.batch) and, with seq_axis, its sequence shard (self._seq: its
        index on the axis, S_local and its first position); the ctor's
        checks of JAX's engine for a seq-sharded cache."""
        ecfg, cfg = self.ecfg, self.cfg
        self.batch, self._lanes, self._seq = ecfg.batch, slice(0, ecfg.batch), None
        if ecfg.mesh is None:
            if ecfg.seq_axis is not None:
                raise ValueError("seq_axis needs a mesh")
            return
        from ..parallel.mesh import axis_group
        from ..parallel.multihost import host_local_batch_slice

        names = tuple(ecfg.mesh.mesh_dim_names or ())
        if "data" not in names:
            raise ValueError(f"the mesh needs a 'data' axis, got {names}")
        if "model" in names and ecfg.mesh.shape[names.index("model")] > 1:
            raise NotImplementedError(
                "tensor parallelism over a 'model' mesh axis comes with a later slice of the "
                "port (ROADMAP A, the rest of the parallelism: tensor parallelism); use a "
                "('data', 'seq') mesh or model = 1")
        self._lanes = host_local_batch_slice(ecfg.batch, ecfg.mesh)
        self.batch = self._lanes.stop - self._lanes.start
        if ecfg.seq_axis is None:
            return
        _, idx, n = axis_group(ecfg.mesh, ecfg.seq_axis)
        if ecfg.s_max % n:
            raise ValueError(f"s_max {ecfg.s_max} does not split over {n} sequence shards")
        if not self._all_lowrank:
            raise NotImplementedError(
                "seq_axis with dense k/v layers comes with a later slice of the port (ROADMAP "
                "A, the rest of the parallelism: seq_axis with dense layers)")
        qk = ecfg.qcfg
        if cache_lib.quantized(qk) and qk.group_size > 0:
            # per-chunk caches shard over seq only in the rank-major layout
            for i in range(cfg.num_hidden_layers):
                for which in ("k_proj", "v_proj"):
                    r = cfg.uniform_rank_for(i, which)
                    if r is not None and not cache_lib.rank_major_chunked(qk, r):
                        raise ValueError(
                            "seq_axis with per-chunk scales requires the rank-major layout: "
                            f"group_size must be a multiple of 8 dividing every rank (layer "
                            f"{i} {which} rank {r}, group_size {qk.group_size})")
        s_local = ecfg.s_max // n
        self._seq = {"index": idx, "s_local": s_local, "lo": idx * s_local}

    def _stacked_ineligible_reason(self) -> Optional[str]:
        """None when the layer-stacked decode can serve this configuration,
        else why not (JAX's checks; the port always runs its kernels)."""
        ecfg, cfg = self.ecfg, self.cfg
        if ecfg.mesh is not None or ecfg.seq_axis is not None:
            return "mesh/seq_axis decode runs the per-layer sharded paths"
        n = cfg.num_hidden_layers
        rks = {cfg.uniform_rank_for(i, "k_proj") for i in range(n)}
        rvs = {cfg.uniform_rank_for(i, "v_proj") for i in range(n)}
        if len(rks) != 1 or len(rvs) != 1 or None in rks or None in rvs:
            return "requires all-low-rank k/v with uniform ranks across layers"
        rk, rv = rks.pop(), rvs.pop()
        if cache_lib.quantized(ecfg.qcfg):
            if not (cache_lib.rank_major(ecfg.qcfg)
                    or (cache_lib.rank_major_chunked(ecfg.qcfg, rk)
                        and cache_lib.rank_major_chunked(ecfg.qcfg, rv))):
                return "quantized cache layout is not rank-major"
        elif not ecfg.rank_major_fp:
            return "fp cache must be rank_major_fp (the v4 kernel's layout)"
        if not self._all_lowrank:
            return "dense k/v layer present"
        for key in ("k_bias", "o_bias_corr"):
            if len({key in d for d in self.derived}) > 1:
                return f"{key} present in only some layers"
        return None

    def _build_derived_stacks(self) -> None:
        """Stack the derived decode weights (b_k, and k_bias / o_bias_corr
        when every layer has them) and let each layer's entry view its
        row."""
        for key in ("b_k", "k_bias", "o_bias_corr"):
            if all(key in d for d in self.derived):
                st = torch.stack([d[key] for d in self.derived])
                for i, d in enumerate(self.derived):
                    d[key] = st[i]

    def _build_derived(self, attn) -> dict:
        """A low-rank layer's decode weights: b_k (G, hpg / rep, rk, hd), and
        with biases k_bias (G, hpg / rep, hd) and o_bias_corr (H,), in the
        engine dtype; k_bias is kept in f32 after that rounding, as the
        decode wrappers take it, so that no launch casts it. b_k and k_bias
        are per kv-head (rep q-heads read each), the compact form every
        latent decode takes (JAX keeps one per q-head)."""
        cfg, dt = self.cfg, self.ecfg.dtype
        der = {"b_k": build_decode_b(attn["k_proj"]["U"].float(), cfg, True).to(dt)}
        if attn["k_proj"].get("b") is not None:
            der["k_bias"] = _per_q_head(attn["k_proj"]["b"], cfg, True).to(dt).float()
        if attn["v_proj"].get("b") is not None:
            der["o_bias_corr"] = _o_bias_corr(attn, cfg, self.ecfg.weight_bits).to(dt)
        return der

    def init_cache(self):
        """This process's cache: per layer, layer-stacked, or its sequence
        shard (S_local columns) of its data lanes."""
        ecfg = self.ecfg
        init = cache_lib.init_cache_stacked if self._stacked else cache_lib.init_cache
        s_max = ecfg.s_max if self._seq is None else self._seq["s_local"]
        return init(self.cfg, self.batch, s_max, ecfg.qcfg, device=self.device,
                    dtype=ecfg.dtype, rank_major_fp=ecfg.rank_major_fp)

    def _layer_entry(self, cache, i: int) -> dict:
        """Layer i's {"k", "v"} buffers in the per-layer shapes: the cache's
        own, or views of the stacked cache (writes land in the stack)."""
        if self._stacked:
            view = cache_lib.layer_view(cache["stack"], i)
            return {side: cache_lib.stacked_unsqueeze(b, self.ecfg.qcfg)
                    for side, b in view.items()}
        return cache["layers"][i]

    def _prefill_entry(self, cache, i: int) -> dict:
        """Where prefill writes and reads layer i: its cache entry, or for a
        sequence shard full-length buffers (every process computes the
        whole prefill; _keep_columns keeps its own)."""
        if self._seq is None:
            return self._layer_entry(cache, i)
        ecfg = self.ecfg
        attn = self._layers[i]["attn"]
        return {side: cache_lib._layer_buffers(
                    self.batch, self.cfg.num_kv_groups, ecfg.s_max,
                    attn[f"{side}_proj"]["U"].shape[1], ecfg.qcfg, self.device, ecfg.dtype,
                    ecfg.rank_major_fp) for side in ("k", "v")}

    def _keep_columns(self, cache, i: int, full: dict, n: int) -> None:
        """A sequence shard keeps the columns it owns of the first n that
        prefill wrote into `full`."""
        if self._seq is None:
            return
        lo, s_local = self._seq["lo"], self._seq["s_local"]
        keep = min(n, lo + s_local) - lo
        if keep <= 0:
            return
        for side, bufs in full.items():
            own = cache_lib.seq_slice(cache["layers"][i][side], 0, keep)
            src = cache_lib.seq_slice(bufs, lo, keep)
            for k, t in own.items():
                t.copy_(src[k])

    def _local_rows(self, x, what: str):
        """This process's data lanes of a global batch of ecfg.batch rows
        (under a mesh every process is given the whole batch, as JAX's
        engine takes global arrays)."""
        if x.shape[0] != self.ecfg.batch:
            raise ValueError(f"{what}: batch {x.shape[0]} is not the engine batch "
                             f"{self.ecfg.batch}")
        return x if self.batch == self.ecfg.batch else x[self._lanes]

    def _encode(self, lat):
        """Latents (B, G, S, r) -> the cache's buffer update."""
        return cache_lib._encode(lat, self.ecfg.qcfg, self.ecfg.dtype, self.ecfg.rank_major_fp)

    # -- prefill -------------------------------------------------------------

    def _lm_head_logits(self, x, paths=None):
        x = llama.rms_norm(x, self.params["final_norm"], self.cfg.rms_norm_eps)
        return wdot(x, tied_head(self.params), paths)

    def _rebuild_side(self, bufs, proj, n: int, rope=None):
        """Read back (dequantizing) and reconstruct (per kv head) the first n
        cache positions of one low-rank side into dense (B, n, nkv, hd), in
        the engine dtype; with rope = (cos, sin) of positions 0..n-1 (K),
        roped in f32 first."""
        cfg, ecfg = self.cfg, self.ecfg
        lat = cache_lib.decode_latents(cache_lib.seq_slice(bufs, 0, n), ecfg.qcfg,
                                       proj["U"].shape[1], ecfg.dtype).transpose(1, 2)
        out = llama.reconstruct_kv(lat, proj).reshape(lat.shape[0], n, cfg.num_key_value_heads,
                                                      cfg.head_dim)
        return out if rope is None else llama.apply_rope(out.float(), *rope).to(ecfg.dtype)

    def _reconstruct_dense(self, entry, attn, n: int):
        """The first n cache positions of a low-rank layer as dense
        (B, nkv, n, hd) roped K and V."""
        b = self.batch
        pos = torch.arange(n, device=self.device)[None, :].expand(b, n)
        rope = llama.rope_cos_sin_for(self.cfg, pos)
        k = self._rebuild_side(entry["k"], attn["k_proj"], n, rope)
        v = self._rebuild_side(entry["v"], attn["v_proj"], n)
        return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def _prefill_layer_major(self, cache, ids: torch.Tensor, base: int):
        """Layer-major prefill of ids (B, m, C) written at offset `base`: the
        whole run advances one layer at a time, so each layer rebuilds its
        K/V prefix once; attention + MLP then run chunk by chunk. Returns
        the logits of the run's last chunk (B, C, V)."""
        cfg, ecfg = self.cfg, self.ecfg
        if not self._all_lowrank:
            raise NotImplementedError("the chunked prefill takes low-rank k/v layers only, as "
                                      "JAX's does; prefill a model with dense k/v layers with "
                                      "prefill or prefill_bucketed (prefill_auto picks it)")
        b, m, c_len = ids.shape
        run = m * c_len
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        dev = self.device
        n_read = -(-(base + run) // self._chunk) * self._chunk
        x = embed_rows(self.params["embed"], ids.reshape(b, run), ecfg.dtype)
        positions = base + torch.arange(run, device=dev)[None, :].expand(b, run)
        cos_all, sin_all = llama.rope_cos_sin_for(cfg, positions)
        offset = torch.full((b,), base, dtype=torch.int32, device=dev)

        if self._seq is not None and base > 0:
            raise NotImplementedError(
                "a prefill chunk past offset 0 on a sequence shard needs the other shards' "
                "columns; it comes with a later slice (ROADMAP A, the rest of the parallelism: "
                "a prefill chunk past offset 0 on a sequence shard)")
        for i, p_layer in enumerate(self._layers):
            entry = self._prefill_entry(cache, i)
            attn = p_layer["attn"]
            h = llama.rms_norm(x, p_layer["input_norm"], cfg.rms_norm_eps)
            for side, proj in (("k", "k_proj"), ("v", "v_proj")):
                lat = llama.project_kv(h, attn[proj]).transpose(1, 2)  # (B, G, run, r)
                cache_lib.write_at_lanes(entry[side], self._encode(lat), offset)
            k_full, v_full = self._reconstruct_dense(entry, attn, n_read)
            self._keep_columns(cache, i, entry, base + run)
            del entry
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
        input_ids = self._local_rows(np.asarray(input_ids), "prefill")
        b, total = input_ids.shape
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

    def _prefill_attention(self, q, k, v):
        """The one-shot prefill's causal attention of q (B, s, nh, hd) over
        k, v (B, s, nkv, hd) -> (B, s, nh * hd): the prefill_flash kernel
        on CUDA tensors (q offset 0, kv length s), mha_prefill (JAX's
        einsum) on the CPU."""
        window = self.cfg.sliding_window
        if not q.is_cuda:
            return mha_prefill(q, k, v, window)
        b, s = q.shape[:2]
        out = prefill_flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0, s,
                            sliding_window=window)
        return out.transpose(1, 2).reshape(b, s, -1)

    def _prefill_oneshot(self, cache, ids: torch.Tensor, last_pos: torch.Tensor):
        """JAX's _prefill_impl (and _prefill_impl_stacked), one layer at a
        time: ids (B, s) at offset 0 through every layer, each side of
        each layer written to the cache and read back as decode will see
        it, one causal attention over the whole prompt. Returns the logits
        of each lane's row last_pos (B, 1, V); the cache's length becomes
        last_pos + 1."""
        cfg, ecfg = self.cfg, self.ecfg
        b, s = ids.shape
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        dev = self.device
        x = embed_rows(self.params["embed"], ids, ecfg.dtype)
        rope = llama.rope_cos_sin_for(cfg, torch.arange(s, device=dev)[None, :].expand(b, s))
        zero = torch.zeros((b,), dtype=torch.int32, device=dev)
        for i, p_layer in enumerate(self._layers):
            entry = self._prefill_entry(cache, i)
            attn = p_layer["attn"]
            h = llama.rms_norm(x, p_layer["input_norm"], cfg.rms_norm_eps)
            q = wdot(h, attn["q_proj"]["w"])
            if attn["q_proj"].get("b") is not None:
                q = q + attn["q_proj"]["b"]
            q = llama.apply_rope(q.reshape(b, s, nh, hd).float(), *rope).to(ecfg.dtype)
            kv = []
            for side, dense in zip(("k", "v"), self._dense_sides[i]):
                proj = attn[f"{side}_proj"]
                raw = llama.project_kv(h, proj)
                if dense:  # K cached post-RoPE, V as projected
                    t = raw.reshape(b, s, nkv, hd)
                    t = (llama.apply_rope(t.float(), *rope) if side == "k" else t).to(ecfg.dtype)
                    cache_lib.write_at_lanes(entry[side], {"lat": t.transpose(1, 2)}, zero)
                else:  # latents cached pre-RoPE, read back
                    cache_lib.write_at_lanes(entry[side], self._encode(raw.transpose(1, 2)),
                                             zero)
                    t = self._rebuild_side(entry[side], proj, s, rope if side == "k" else None)
                kv.append(t)
            self._keep_columns(cache, i, entry, s)
            del entry
            x = x + wdot(self._prefill_attention(q, *kv), attn["o_proj"]["w"])
            h2 = llama.rms_norm(x, p_layer["post_norm"], cfg.rms_norm_eps)
            x = x + llama.mlp_forward(h2, p_layer["mlp"])
        cache["length"] = (last_pos + 1).to(torch.int32)
        return self._lm_head_logits(x[torch.arange(b, device=dev), last_pos.long()][:, None])

    @torch.no_grad()
    def prefill(self, input_ids, cache=None, real_len=None):
        """One-shot prefill of the whole prompt (JAX's Engine.prefill), for
        any mix of dense and low-rank layers. input_ids (B, s) may be
        right-padded: real_len (an int or (B,)) marks each lane's true
        length, and pad positions are causally invisible to real ones and
        overwritten by decode. Returns (the logits of each lane's last real
        token (B, 1, V), cache)."""
        input_ids = np.asarray(input_ids)
        if input_ids.shape[0] != self.ecfg.batch:
            raise ValueError(f"batch {input_ids.shape[0]} != engine batch {self.ecfg.batch}")
        if input_ids.shape[1] > self.ecfg.s_max:
            raise ValueError(f"prompt length {input_ids.shape[1]} exceeds cache s_max "
                             f"{self.ecfg.s_max}")
        if cache is None:
            cache = self.init_cache()
        if real_len is None:
            real_len = input_ids.shape[1]
        last = np.array(np.broadcast_to(np.asarray(real_len, np.int64) - 1, (self.ecfg.batch,)))
        ids = torch.as_tensor(self._local_rows(input_ids, "prefill"), device=self.device)
        last_pos = torch.as_tensor(self._local_rows(last, "prefill real_len"), device=self.device)
        return self._prefill_oneshot(cache, ids, last_pos), cache

    def prefill_bucketed(self, input_ids, cache=None):
        """prefill with the prompt right-padded to a power-of-two bucket
        (from 32, capped at s_max), as JAX's, so that prompts of many
        lengths share a few shapes."""
        input_ids = np.asarray(input_ids)
        real = input_ids.shape[1]
        bucket = 32
        while bucket < real:
            bucket *= 2
        bucket = min(bucket, self.ecfg.s_max)
        if bucket < real:
            raise ValueError(f"prompt {real} exceeds s_max {self.ecfg.s_max}")
        if bucket > real:
            input_ids = np.pad(input_ids, ((0, 0), (0, bucket - real)))
        return self.prefill(input_ids, cache=cache, real_len=real)

    def prefill_auto(self, input_ids, cache=None):
        """The fixed-chunk stream when every k/v layer is low-rank (always
        for a Palu-compressed model, and for the stacked engine), else the
        bucketed one-shot prefill, as JAX's prefill_auto decides."""
        if self._all_lowrank:
            return self.prefill_chunked(input_ids, chunk_size=self._chunk, cache=cache)
        return self.prefill_bucketed(input_ids, cache=cache)

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
        if b != self.batch or c_len != self._chunk:
            raise ValueError(f"chunk must be ({self.batch}, {self._chunk}), got "
                             f"{tuple(ids.shape)}")
        if off < 0 or off + c_len > self.ecfg.s_max:
            raise ValueError(f"chunk at {off} does not fit s_max {self.ecfg.s_max}")
        return self._prefill_layer_major(cache, ids[:, None, :], off), cache

    # -- decode --------------------------------------------------------------

    def _appends(self, cache) -> list:
        """Per layer, the two-side append into `cache` (ops/cache_append.KVAppend,
        None for a dense layer), its buffers checked once per cache: kept
        while the cache holds the same buffer tensors it was built on."""
        entries = [cache["stack"]] if self._stacked else cache["layers"]
        leaves = [t for e in entries for side in e.values() for t in side.values()]
        memo = self._append_memo
        if memo is None or len(memo[0]) != len(leaves) or any(
                r() is not t for r, t in zip(memo[0], leaves)):
            appends = []
            for i, (p_layer, dense) in enumerate(zip(self._layers, self._dense)):
                if dense:
                    appends.append(None)
                    continue
                entry = self._layer_entry(cache, i)
                ranks = [p_layer["attn"][f"{s}_proj"]["U"].shape[1] for s in ("k", "v")]
                appends.append(KVAppend((entry["k"], entry["v"]), ranks, qcfg=self.ecfg.qcfg))
            memo = self._append_memo = (tuple(weakref.ref(t) for t in leaves), appends)
        return memo[1]

    def _append(self, entry, append, lats, pos_w, writeable):
        """Masked write of one token's K and V columns lats (B, G, 1, r_k /
        r_v): quantized and packed by one append launch for both sides where
        the kernel covers the cache, else the plain write (raw latents,
        exact 3-bit packing, per-chunk scales), as in the JAX engine."""
        if append is not None:
            append([lat[:, :, 0, :] for lat in lats], pos_w, writeable)
            return
        for side, lat in zip(("k", "v"), lats):
            cache_lib.write_at_lanes_masked(entry[side], self._encode(lat), pos_w, writeable)

    def _decode_attention(self, q, entry, attn, der, kv_len, layer_idx=None):
        """Latent decode attention of one layer and the U_v-fused o_proj.
        `entry` is the layer's buffers, or with layer_idx the stacked
        cache's {"k", "v"} (the kernel reads layer layer_idx of it); on a
        sequence shard the shards are merged (ops/attention.py)."""
        cfg, ecfg = self.cfg, self.ecfg
        b, nh, _ = q.shape
        rk = attn["k_proj"]["U"].shape[1]
        rv = attn["v_proj"]["U"].shape[1]
        kb, vb = entry["k"], entry["v"]
        side = "kernel" if q.is_cuda else "plain"
        kw = dict(theta=cfg.rope_theta, sliding_window=cfg.sliding_window,
                  inv_freq=self._inv_freq, rope_scale=self._rope_scale,
                  k_bias=der.get("k_bias"))
        if self._seq is not None:
            lat_out = self._decode_seq(q, kb, vb, der["b_k"], kv_len, rk, rv, side, kw)
        elif "codes" in kb:  # JAX's seq-major per-chunk layout: no kernel reads it
            self._decode_paths.add("flash_decode_latent-plain")
            lat_out = self._decode_seq_major(q, kb, vb, der, kv_len, rk, rv)
        elif cache_lib.quantized(ecfg.qcfg):
            tag = "" if layer_idx is None else "[layer_idx]"
            self._decode_paths.add(f"{self._packed_path}{tag}-{side}")
            lat_out = palu_decode(
                q, der["b_k"], kb["codes_t"], kb["scale_t"], vb["codes_t"], vb["scale_t"],
                kv_len, qcfg=ecfg.qcfg, rk=rk, rv=rv, xk_zero=kb.get("zero_t"),
                xv_zero=vb.get("zero_t"), block_s=self._pallas_block, **self._int8_knobs,
                layer_idx=layer_idx, **kw)
        elif layer_idx is not None:
            self._decode_paths.add(f"palu_decode_fp_t[layer_idx]-{side}")
            lat_out = palu_decode_fp_t(q, der["b_k"], kb["lat_t"], vb["lat_t"], kv_len,
                                       layer_idx=layer_idx, **kw)
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

    def _decode_seq_major(self, q, kb, vb, der, kv_len, rk: int, rv: int):
        """Decode over the seq-major per-chunk cache: flash_decode_latent over
        decode_latents of each decode_chunk of the cache, in PyTorch on
        either device, as JAX runs it in XLA (its xla-chunked-fallback)."""
        cfg, ecfg = self.cfg, self.ecfg
        chunk = self._chunk
        b_k, k_bias = _expand(q, der["b_k"], der.get("k_bias"))

        def read(bufs, rank):
            return lambda i: cache_lib.decode_latents(
                cache_lib.seq_slice(bufs, i * chunk, chunk), ecfg.qcfg, rank, ecfg.dtype)

        return flash_decode_latent(q, read(kb, rk), read(vb, rv), b_k, ecfg.s_max // chunk,
                                   chunk, kv_len, cfg.head_dim, cfg.rope_theta, rv,
                                   cfg.sliding_window, inv_freq=self._inv_freq,
                                   rope_scale=self._rope_scale, k_bias=k_bias)

    def _decode_seq(self, q, kb, vb, b_k, kv_len, rk: int, rv: int, side: str, kw: dict):
        """This process's sequence shard decoded and merged with the other
        shards: the rank-major caches through their kernels with
        pos_offset and return_stats, the seq-major bf16 cache in plain
        PyTorch (as JAX runs it in XLA)."""
        ecfg, cfg = self.ecfg, self.cfg
        mesh, axis, s_local = ecfg.mesh, ecfg.seq_axis, self._seq["s_local"]
        if cache_lib.quantized(ecfg.qcfg) or ecfg.rank_major_fp:
            quant = cache_lib.quantized(ecfg.qcfg)
            name = self._packed_path if quant else "palu_decode_fp_t"
            self._decode_paths.add(f"{name}[seq]-{side}")
            return flash_decode_latent_seq_sharded_rank_major(
                q, kb, vb, b_k, kv_len, mesh, axis, qcfg=ecfg.qcfg if quant else None,
                rk=rk, rv=rv, block_s=min(self._pallas_block, s_local),
                kernel_knobs=self._int8_knobs, **kw)
        self._decode_paths.add(f"flash_decode_latent[seq]-{side}")
        kw = dict(kw, rope_theta=kw.pop("theta"))
        return flash_decode_latent_seq_sharded(
            q, kb["lat"], vb["lat"], b_k, kv_len, mesh, axis,
            _largest_divisor(s_local, self._chunk), cfg.head_dim, **kw)

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
        if self._one_sided:
            raise ValueError(
                f"layers {self._one_sided} have one dense k/v side: the JAX package has no "
                "decode for such layers (its decode attention reads both sides' U), so the "
                "port has none either; they prefill only")
        dev = self.device
        if not isinstance(token_ids, torch.Tensor):
            token_ids = torch.as_tensor(np.asarray(token_ids))
        token_ids = self._local_rows(token_ids.to(dev), "decode")
        b = token_ids.shape[0]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=dev)
        else:
            active = self._local_rows(active.to(dev), "decode active")
        pos = cache["length"]
        writeable = active & (pos < ecfg.s_max)
        pos_w = torch.clamp(pos, max=ecfg.s_max - 1)
        kv_len = torch.where(writeable, pos + 1, pos)
        # where this token's column lands: the owning sequence shard only
        pos_a, wr_a = ((pos_w, writeable) if self._seq is None else
                       cache_lib.shard_write(pos_w, writeable, self._seq["lo"],
                                             self._seq["s_local"]))
        x = embed_rows(self.params["embed"], token_ids, ecfg.dtype)  # (B, 1, H)
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        cos, sin = llama.rope_cos_sin_for(cfg, pos[:, None])
        appends = self._appends(cache) if self._fused_append else [None] * len(self._dense)

        for i, (p_layer, der, dense, append) in enumerate(zip(self._layers, self.derived,
                                                              self._dense, appends)):
            entry = self._layer_entry(cache, i)
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
                lats = [llama.project_kv(h, attn[proj], self._gemv_paths).transpose(1, 2)
                        for proj in ("k_proj", "v_proj")]
                self._append(entry, append, lats, pos_a, wr_a)
                if self._stacked:  # the kernel reads layer i of the whole stack
                    x = x + self._decode_attention(q, cache["stack"], attn, der, kv_len,
                                                   layer_idx=i)[:, None, :]
                else:
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
