"""palu_tpu_torch: the Palu low-rank + quantized latent KV-cache engine in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package `palu_tpu`, which stays the reference: the layout
(core/, models/, ops/, runtime/) and the function names follow it. This
package imports torch and numpy, never jax and never palu_tpu. Entry points
run on CUDA unless the caller passes device="cpu"; on the CPU every kernel
wrapper runs its plain PyTorch version.
"""
