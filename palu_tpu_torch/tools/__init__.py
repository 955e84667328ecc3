"""The decode and GEMV probes of tools/ (tpu_dissect, tpu_stream_probe,
tpu_unpack_probe, tpu_gemv_probe) as entry points on the card, each on its
own hand-written kernel held against its plain version:

  python -m palu_tpu_torch.tools.dissect [seq] [block_s] [modes]
  python -m palu_tpu_torch.tools.stream_probe [probe ...]
  python -m palu_tpu_torch.tools.unpack_probe [variant ...]
  python -m palu_tpu_torch.tools.gemv_probe [probe ...]

Each runs on CUDA unless --use_cpu is given (then the plain versions run, at
the size asked for)."""
