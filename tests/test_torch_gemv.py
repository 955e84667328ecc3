"""The port's plain GEMV versions (ops/gemv_int4, ops/gemv_int8) against
the JAX Pallas kernels run in interpret mode, as tests/test_gemv_int4.py and
tests/test_gemv_int8.py run them: f32 inputs within 1e-5 of max|y|; bf16
inputs within 2^-7 of max|y| (the output's bf16 rounding, and in the MLP
the bf16 rounding of h, can each land one bf16 step apart). Also the
dispatch: at most 8 rows take the GEMV (its plain version on the CPU),
more rows the matmul paths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import wquant as jw
from palu_tpu.ops.pallas.gemv_int4 import gemv_int4 as jgemv4, mlp_gemv_int4 as jmlp4
from palu_tpu.ops.pallas.gemv_int8 import gemv_int8 as jgemv8, mlp_gemv_int8 as jmlp8
from palu_tpu_torch.convert import params_from_numpy
from palu_tpu_torch.core import wquant as tw
from palu_tpu_torch.models import llama
from palu_tpu_torch.ops import gemv_int4, gemv_int8

H, I, N = 512, 512, 256
F32_TOL, BF16_TOL = 1e-5, 2.0**-7


def _rand(shape, seed, s=0.05):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * s


def _quant(bits, shape, seed):
    w = _rand(shape, seed)
    jq = jw.quantize_weight4(w) if bits == 4 else jw.quantize_weight(w)
    return jq, params_from_numpy({k: np.asarray(v) for k, v in jq.items()}, device="cpu")


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _x(rows, k, seed, dtype):
    x = _rand((rows, k), seed, 1.0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(dtype)


DTYPES = [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_gemv_int4_ref_matches_pallas(rows, dtype, tol):
    jq, tq = _quant(4, (H, N), 1)
    jx, tx = _x(rows, H, 2, dtype)
    want = jgemv4(jx, jq, block_n=128, interpret=True)
    got = gemv_int4.gemv_int4(tx, tq)  # CPU tensor: the plain version
    assert got.dtype == dtype
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_mlp_gemv_int4_ref_matches_pallas(rows, dtype, tol):
    (jg, tg), (ju, tu), (jd, td) = (_quant(4, (H, I), 3), _quant(4, (H, I), 4),
                                    _quant(4, (I, H), 5))
    jx, tx = _x(rows, H, 6, dtype)
    want = jmlp4(jx, jg, ju, jd, block_n=128, interpret=True)
    got = gemv_int4.mlp_gemv_int4(tx, tg, tu, td)
    assert got.dtype == dtype
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_gemv_int8_ref_matches_pallas(rows, dtype, tol):
    jq, tq = _quant(8, (H, N), 7)
    jx, tx = _x(rows, H, 8, dtype)
    want = jgemv8(jx, jq, block_n=128, interpret=True)
    got = gemv_int8.gemv_int8(tx, tq)
    assert got.dtype == dtype
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_mlp_gemv_int8_ref_matches_pallas(rows, dtype, tol):
    (jg, tg), (ju, tu), (jd, td) = (_quant(8, (H, I), 9), _quant(8, (H, I), 10),
                                    _quant(8, (I, H), 11))
    jx, tx = _x(rows, H, 12, dtype)
    want = jmlp8(jx, jg, ju, jd, block_n=128, interpret=True)
    got = gemv_int8.mlp_gemv_int8(tx, tg, tu, td)
    assert got.dtype == dtype
    _close(got, want, tol)


def test_gemv_int8_transposed_head():
    e = _rand((N, H), 13)  # (V, H) table; the tied head reads it as (H, V)
    jq = jw.quantize_embed(e)
    head = {"wq8": jq["eq8"].T, "ws": jq["es"].T}
    tq = params_from_numpy({k: np.asarray(v) for k, v in jq.items()}, device="cpu")
    jx, tx = _x(3, H, 14, torch.float32)
    want = jgemv8(jx, head, block_n=128, interpret=True)
    got = gemv_int8.gemv_int8(tx, {"wq8": tq["eq8"].T, "ws": tq["es"].T})
    _close(got, want, F32_TOL)


def test_preconditions_raise():
    _, t4 = _quant(4, (H, N), 15)
    _, t8 = _quant(8, (H, N), 16)
    for fn, w in ((gemv_int4.gemv_int4, t4), (gemv_int8.gemv_int8, t8)):
        with pytest.raises(ValueError):
            fn(torch.zeros(9, H), w)  # more than 8 rows
        with pytest.raises(ValueError):
            fn(torch.zeros(1, H - 128), w)  # K mismatch
    _, narrow = _quant(8, (H, 192), 17)
    with pytest.raises(ValueError):
        gemv_int8.gemv_int8(torch.zeros(1, H), narrow)  # N % 128
    _, small_group = _quant(4, (192, N), 18)  # group shrinks to 32
    with pytest.raises(ValueError):
        gemv_int4.gemv_int4(torch.zeros(1, 192), small_group)


@pytest.mark.parametrize("bits", [8, 4])
def test_dispatch_records_paths(bits):
    _, w = _quant(bits, (H, N), 19)
    mlp = {"gate": _quant(bits, (H, I), 20)[1], "up": _quant(bits, (H, I), 21)[1],
           "down": _quant(bits, (I, H), 22)[1]}
    kind = f"int{bits}"
    small, large = set(), set()
    tw.wdot(torch.zeros(2, 1, H), w, small)
    llama.mlp_forward(torch.zeros(8, H), mlp, small)
    assert small == {f"gemv_{kind}-plain", f"mlp_gemv_{kind}-plain"}
    tw.wdot(torch.zeros(3, 3, H), w, large)
    llama.mlp_forward(torch.zeros(9, H), mlp, large)
    assert large == {"int4-dequant-matmul" if bits == 4 else "int8-matmul"}
    # the MLP kernel computes the three wdots' function
    x = torch.from_numpy(_rand((5, H), 23, 1.0))
    fused = llama.mlp_forward(x, mlp)
    three = tw.wdot(torch.nn.functional.silu(tw.wdot(x[None], mlp["gate"]))
                    * tw.wdot(x[None], mlp["up"]), mlp["down"])[0]
    torch.testing.assert_close(fused, three, rtol=0, atol=F32_TOL * three.abs().max().item())
