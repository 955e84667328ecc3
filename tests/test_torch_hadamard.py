"""core/hadamard.py and ops/hadamard.py on the CPU against the JAX package:
the generated Hadamard matrices element for element (every order of
_K_PRIORITY and every power of two to 4096), get_hadK, fwht and
apply_hadamard within 1e-6 of max|JAX| (the K x K einsum sums in another
order), and the plain hadamard_transform_ref within 1e-5 of max|JAX| of
the Pallas kernel run in interpret mode, as tests/test_fwht_kernel.py runs
it, at the ranks of the fuse_hadamard path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import hadamard as jh
from palu_tpu.ops.pallas import fwht as jfwht
from palu_tpu_torch.core import hadamard as th
from palu_tpu_torch.ops.hadamard import MAX_N, hadamard_transform, hadamard_transform_ref

ORDERS = list(jh._K_PRIORITY) + [2**i for i in range(13)]


@pytest.mark.parametrize("n", ORDERS)
def test_hadamard_matrix_matches_jax(n):
    got, want = th.hadamard_matrix(n), jh.hadamard_matrix(n)
    assert got.dtype == want.dtype and got.shape == (n, n)
    np.testing.assert_array_equal(got, want)


def test_constructions_are_copies():
    assert th._K_PRIORITY == jh._K_PRIORITY
    assert th._PALEY_RECIPES == jh._PALEY_RECIPES
    assert th._WILLIAMSON_ROWS == jh._WILLIAMSON_ROWS


@pytest.mark.parametrize("n", list(range(32, 513, 32)) + [12, 20, 24, 2048, 3904, 4096])
def test_get_hadk_and_full_matrix_match_jax(n):
    (gh, gk), (wh, wk) = th.get_hadK(n), jh.get_hadK(n)
    assert gk == wk
    assert (gh is None) == (wh is None)
    if gh is not None:
        np.testing.assert_array_equal(gh, wh)
    if n <= 512:
        np.testing.assert_array_equal(th.full_hadamard_matrix(n),
                                      jfwht.full_hadamard_matrix(n))


def test_get_hadk_rejects_unknown_orders():
    for n in (3, 6, 100, 200):
        with pytest.raises(ValueError):
            th.get_hadK(n)


@pytest.mark.parametrize("n", [1, 2, 64, 1024])
def test_fwht_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((3, 4, n)).astype(np.float32)
    want = np.asarray(jh.fwht(jnp.asarray(x)))
    got = th.fwht(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    got1 = th.fwht(torch.from_numpy(x).transpose(1, 2), axis=1).transpose(1, 2).numpy()
    np.testing.assert_array_equal(got1, got)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n", [96, 128, 160, 352, 480, 512, 1024])
def test_apply_hadamard_matches_jax(n, transpose):
    x = np.random.default_rng(n).standard_normal((5, 3, n)).astype(np.float32)
    want = np.asarray(jh.apply_hadamard(jnp.asarray(x), transpose=transpose))
    got = th.apply_hadamard(torch.from_numpy(x), transpose=transpose)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_apply_hadamard_keeps_dtype_and_inverts():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 352)).astype(np.float32))
    y = th.apply_hadamard(x)
    back = th.apply_hadamard(y, transpose=True)  # kron(H_K, H_m)/sqrt(n) is orthogonal
    assert (back - x).abs().max() <= 1e-5
    assert th.apply_hadamard(x.bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("n", [96, 160, 224, 288, 352, 384, 416, 480, 512])
def test_plain_transform_matches_pallas_interpret(n):
    x = np.random.default_rng(0).standard_normal((37, n)).astype(np.float32)
    want = np.asarray(jfwht.hadamard_transform(jnp.asarray(x), block_rows=16, interpret=True))
    got = hadamard_transform(torch.from_numpy(x))  # CPU tensor: the plain version
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    ref = hadamard_transform_ref(torch.from_numpy(x), transpose=True).numpy()
    want_t = np.asarray(jh.apply_hadamard(jnp.asarray(x), transpose=True))
    assert np.abs(ref - want_t).max() <= 1e-5 * np.abs(want_t).max()


def test_transform_on_cpu_runs_plain_and_keeps_shape():
    n0 = hadamard_transform.launches
    x = torch.randn((3, 5, 128), generator=torch.Generator().manual_seed(1))
    out = hadamard_transform(x.bfloat16())
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert hadamard_transform.launches == n0
    assert MAX_N == 4096


def test_random_sign_diagonal_matches_jax():
    np.testing.assert_array_equal(th.random_sign_diagonal(256, seed=3),
                                  jh.random_sign_diagonal(256, seed=3))
