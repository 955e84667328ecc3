"""Where the port's stacked cache parts from JAX's stacked engine: for each
cache layout of tests/test_torch_engine_stacked.py's main case, the code
bytes that differ, and the f32 elements (scales, zeros, raw latents) that
differ with their largest difference relative to the leaf's max|JAX|. Run from the repo root:

    python tests/torch_stacked_cache_bytes.py

The f32 leaves come from h @ VT, which XLA and PyTorch sum in different
orders, so they may differ in their last bits; the codes must not."""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)
import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_engine_stacked as t  # noqa: E402


def main() -> None:
    for name in ("palu_flash_decode4", "palu_flash_decode4_quantized"):  # as the tests' fixture
        setattr(t.jpk4, name, functools.partial(getattr(t.jpk4, name),
                                                compute_dtype=jnp.float32))
    for name, (qkw, rm) in t.QCFGS.items():
        jeng, stacked, _ = t._engines(*t._lowrank_model(rank=16, gs=2), qkw, rm)
        ids = np.random.default_rng(0).integers(0, 64, (1, 12))
        _, jcache = t._run(jeng, ids)
        _, tcache = t._run(stacked, ids)
        codes = floats = n_floats = 0
        rel = 0.0
        for side in ("k", "v"):
            for key, jbuf in jcache["stack"][side].items():
                a, b = tcache["stack"][side][key].numpy(), np.asarray(jbuf)
                if key == "codes_t":
                    codes += int((a != b).sum())
                else:
                    floats += int((a != b).sum())
                    n_floats += a.size
                    rel = max(rel, float(np.abs(a - b).max() / np.abs(b).max()))
        print(f"{name}: code bytes differing {codes}; f32 elements differing {floats} "
              f"of {n_floats}, at most {rel:.3g} of max|JAX|")


if __name__ == "__main__":
    main()
