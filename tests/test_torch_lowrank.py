"""core/lowrank.py on the CPU against the JAX package: SVD and whitened
factors equal up to a per-rank sign (LAPACK and the port's torch.linalg may
pick either sign of a singular vector) within 1e-5 of max|JAX|, their
products (reconstruct_dense) within 1e-5 of max|JAX| as they are, the
Cholesky with its PSD repair within 1e-5, and fuse_hadamard on JAX's own
factors (carried across with convert.lowrank_from_numpy) within 1e-6."""

import numpy as np
import pytest
import torch

from palu_tpu.core import lowrank as jlr
from palu_tpu_torch.convert import lowrank_from_numpy
from palu_tpu_torch.core import lowrank as tlr

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _signs(got_vt, want_vt):
    """Per-rank signs mapping the port's rows of VT onto JAX's."""
    return np.where((got_vt * want_vt).sum(-1) < 0, -1.0, 1.0).astype(np.float32)


def _check_factors(t, j):
    assert t.ranks == j.ranks
    vt = t.VT.numpy()
    s = _signs(vt, j.VT)
    _close(vt * s[:, None], j.VT)
    off = 0
    for tu, ju, r in zip(t.U, j.U, j.ranks):
        _close(tu.numpy() * s[None, off:off + r], ju)
        off += r
    _close(t.reconstruct_dense(), j.reconstruct_dense())


def _weight(seed, out=64, inp=48):
    return np.random.default_rng(seed).standard_normal((out, inp)).astype(np.float32)


@pytest.mark.parametrize("ranks", [[8, 8, 8, 8], [4, 12, 16, 2]])
def test_decompose_svd_matches_jax(ranks):
    w = _weight(0)
    bias = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    j = jlr.decompose_svd(w, ranks, bias)
    t = tlr.decompose_svd(torch.from_numpy(w), ranks, torch.from_numpy(bias))
    _check_factors(t, j)
    for tb, jb in zip(t.bias, j.bias):
        np.testing.assert_array_equal(tb.numpy(), jb)
    assert (t.in_features, t.out_features, t.num_groups) == (48, 64, 4)


def test_decompose_svd_full_rank_is_exact():
    w = _weight(2)
    t = tlr.decompose_svd(torch.from_numpy(w), [16, 16, 16, 16])
    _close(t.reconstruct_dense(), w)


def _scale(seed, n=48, samples=200):
    x = np.random.default_rng(seed).standard_normal((samples, n)).astype(np.float32)
    return np.linalg.cholesky((x.T @ x).astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("ranks", [[8, 8, 8, 8], [16, 4, 8, 12]])
def test_decompose_whiten_matches_jax(ranks):
    w, scale = _weight(3), _scale(4)
    j = jlr.decompose_whiten(w, scale, ranks)
    t = tlr.decompose_whiten(torch.from_numpy(w), torch.from_numpy(scale), ranks)
    _check_factors(t, j)
    assert t.bias is None


@pytest.mark.parametrize("psd", [True, False])
def test_cholesky_with_psd_repair_matches_jax(psd):
    x = np.random.default_rng(5).standard_normal((20 if not psd else 80, 32))
    gram = x.T @ x
    if not psd:
        gram -= 0.5 * np.eye(32)  # rank 20 minus a shift: negative eigenvalues
        with pytest.raises(np.linalg.LinAlgError):
            np.linalg.cholesky(gram)
    want = jlr.cholesky_with_psd_repair(gram)
    got = tlr.cholesky_with_psd_repair(torch.from_numpy(gram))
    assert got.dtype == torch.float32
    _close(got, want)
    assert np.allclose(got.numpy(), np.tril(got.numpy()))


@pytest.mark.parametrize("ranks", [[32, 24], [12, 48], [64, 64]])
def test_fuse_hadamard_matches_jax(ranks):
    w = _weight(6, out=128, inp=96)
    j = jlr.decompose_svd(w, ranks)
    t = lowrank_from_numpy(j.VT, j.U, j.ranks, device="cpu")
    jf, tf = jlr.fuse_hadamard(j), tlr.fuse_hadamard(t)
    _close(tf.VT, jf.VT, 1e-6)
    for tu, ju in zip(tf.U, jf.U):
        _close(tu, ju, 1e-6)
    # the rotation cancels in U VT^T
    _close(tf.reconstruct_dense(), j.reconstruct_dense())
    assert not np.allclose(tf.VT.numpy(), j.VT)


def test_lowrank_from_numpy_defaults_to_the_card():
    """Without a device it asks for CUDA, which raises where there is none."""
    j = jlr.decompose_svd(_weight(7, out=64, inp=32), [16])
    if torch.cuda.is_available():
        assert lowrank_from_numpy(j.VT, j.U, j.ranks).VT.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lowrank_from_numpy(j.VT, j.U, j.ranks)
