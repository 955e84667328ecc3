"""Command-line entry points of the port: the latency benchmarks of the JAX
package's palu_tpu/cli (run_latency_kernel, run_latency_attention,
serve_bench) with the same flags, defaults and JSON keys, plus --use_cpu."""
