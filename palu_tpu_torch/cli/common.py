"""Shared flags and loading of the eval CLIs (port of
palu_tpu/cli/common.py; the reference's utils.py:101-110 add_common_args).

Flags and defaults are the JAX CLI's. `load_for_eval` loads onto the card
unless --use_cpu is given (asking for CUDA where there is none raises).
"""

from __future__ import annotations

import argparse

import torch

from ..core import lowrank
from ..core.quant import QuantConfig
from ..models import hf_io, llama
from ..ops import build


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--model_name_or_path", type=str, required=True,
                        help="local HF dir (dense or palu* compressed)")
    parser.add_argument("--lt_bits", type=int, default=16,
                        help="bits for low-rank latents; <16 quantizes")
    parser.add_argument("--lt_group_size", type=int, default=0)
    parser.add_argument("--lt_sym", action="store_true")
    parser.add_argument("--lt_clip_ratio", type=float, default=1.0)
    parser.add_argument("--lt_hadamard", action="store_true",
                        help="apply the Hadamard rotation to latents (fused "
                        "into VT/U weights at load time)")
    parser.add_argument("--lt_container", type=int, default=0,
                        help="cache storage field width per code (0 = lt_bits"
                        "; e.g. 4 stores 3-bit codes in nibbles: identical "
                        "accuracy, 4/3x cache bytes)")
    parser.add_argument("--use_cpu", action="store_true")
    return parser


def quant_config_from_args(args):
    return QuantConfig(
        bits=args.lt_bits,
        group_size=args.lt_group_size,
        sym=args.lt_sym,
        clip_ratio=args.lt_clip_ratio,
        hadamard=args.lt_hadamard,
        container=getattr(args, "lt_container", 0),
    )


def load_for_eval(args):
    """Load bf16 (params, cfg) on the card (the CPU with --use_cpu); with
    --lt_hadamard fuse the Hadamard rotation into each low-rank k/v side's
    VT and U (lowrank.fuse_hadamard: the FWHT kernel on the card, 2 launches
    per group and side) and rebuild o_proj's U_v-fused weight (reference
    configure_latent_quantizer + fused_hadamard_matrix, svd_linear.py:142-168).
    Low-rank sides must have one rank in every group, as the JAX function
    requires."""
    dev = build.require_cuda("cpu" if getattr(args, "use_cpu", False) else "cuda")
    dtype = torch.bfloat16
    params, cfg = hf_io.load_params(args.model_name_or_path, dtype=dtype, device=dev)
    if not args.lt_hadamard:
        return params, cfg
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        attn = dict(layer["attn"])
        for which in ("k_proj", "v_proj"):
            p = attn[which]
            if "VT" not in p:
                continue
            if llama.is_ragged(p):
                raise ValueError(
                    f"--lt_hadamard needs one rank in every group; layer {i} {which} has "
                    f"ranks {[u.shape[0] for u in p['U']]}")
            g, r = p["U"].shape[:2]
            lr = lowrank.fuse_hadamard(lowrank.LowRankWeights(
                VT=p["VT"].float().T, U=[u.float().T for u in p["U"]], ranks=[r] * g))
            newp = {"VT": lr.VT.T.to(dtype), "U": torch.stack([u.T for u in lr.U]).to(dtype)}
            if p.get("b") is not None:
                newp["b"] = p["b"]
            attn[which] = newp
        if "VT" in attn["v_proj"]:
            attn["o_proj"] = dict(attn["o_proj"])
            attn["o_proj"]["w_fused"] = llama.fuse_o_proj(
                attn["o_proj"]["w"].float(), attn["v_proj"]["U"].float(), cfg).to(dtype)
        new_layers.append({**layer, "attn": attn})
    return {**params, "layers": new_layers}, cfg
