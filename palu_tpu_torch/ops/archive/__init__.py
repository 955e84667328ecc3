"""Superseded decode generations, kept only as A/B baselines (port of
palu_tpu/ops/pallas/archive).

v2 (palu_decode2: cos/sin computed in the kernel from the positions, the
affine dequantization folded past the products) and v3 (palu_decode3:
block-relative RoPE tables, scales and zeros packed (B, S, 2G)) have no
product call site: the engine runs
ops/palu_decode (v4) and ops/palu_decode_fp / palu_decode_seq. They stay
importable for palu_tpu_torch.tools.ab_v2 and their tests, each kernel
beside its plain version and counting its launches."""
