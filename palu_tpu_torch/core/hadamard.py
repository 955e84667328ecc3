"""Hadamard transform machinery in PyTorch (port of palu_tpu/core/hadamard.py).

The non-power-of-2 Hadamard factors are generated, not tabulated (Sylvester
doubling, Paley I/II over GF(p^k), and Williamson quadruples): this is the
JAX package's numpy code, copied because that module imports JAX.

Semantics (the reference's hadamard_utils.py:85-147): apply_hadamard(x)
multiplies the last dim by the orthonormal matrix H_n / sqrt(n), where
n = K * 2^m and H_n = kron(H_K, H_m): a length-2^m FWHT on contiguous
chunks, then a K x K Hadamard mix across chunks. `get_hadK(n)` follows the
reference's K-selection priority order.

On a CUDA tensor apply_hadamard runs the hand-written FWHT kernel
(ops/hadamard.hadamard_transform, n <= 4096); on a CPU tensor it runs the
JAX package's own formulation (fwht on the chunks, then the K x K einsum).
Both compute in f32 and return x's dtype.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "is_pow2",
    "hadamard_matrix",
    "full_hadamard_matrix",
    "get_hadK",
    "fwht",
    "apply_hadamard",
    "random_sign_diagonal",
]


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


# ---------------------------------------------------------------------------
# GF(p^k) arithmetic (tiny fields only; used offline at trace/build time)
# ---------------------------------------------------------------------------


def _poly_mul_mod(a, b, mod_poly, p):
    """Multiply polynomials a*b over GF(p), reduce mod mod_poly (all coeff
    lists, lowest degree first)."""
    res = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            res[i + j] = (res[i + j] + ai * bj) % p
    # reduce mod mod_poly (monic, degree d)
    d = len(mod_poly) - 1
    while len(res) > d:
        lead = res[-1]
        if lead:
            shift = len(res) - 1 - d
            for i, mi in enumerate(mod_poly):
                res[shift + i] = (res[shift + i] - lead * mi) % p
        res.pop()
    while len(res) < d:
        res.append(0)
    return res


def _find_irreducible(p: int, k: int):
    """Brute-force a monic irreducible polynomial of degree k over GF(p).

    Only used for tiny fields (p^k <= 256ish), so trial division by all
    monic polynomials of degree 1..k//2 is fine.
    """
    if k == 1:
        return [0, 1]  # x

    def polys(deg):
        # all monic polys of given degree, coeffs lowest-first
        for idx in range(p**deg):
            coeffs = []
            t = idx
            for _ in range(deg):
                coeffs.append(t % p)
                t //= p
            yield coeffs + [1]

    def poly_divmod_rem_zero(a, b):
        # return True if b divides a (over GF(p))
        a = list(a)
        db = len(b) - 1
        inv_lead = pow(b[-1], p - 2, p)
        while len(a) - 1 >= db and any(a):
            if a[-1] == 0:
                a.pop()
                continue
            q = a[-1] * inv_lead % p
            shift = len(a) - 1 - db
            for i, bi in enumerate(b):
                a[shift + i] = (a[shift + i] - q * bi) % p
            a.pop()
        return not any(a)

    for cand in polys(k):
        if all(
            not poly_divmod_rem_zero(cand, d)
            for deg in range(1, k // 2 + 1)
            for d in polys(deg)
        ):
            return cand
    raise RuntimeError(f"no irreducible polynomial found for GF({p}^{k})")


def _gf_elements_and_chi(q: int):
    """Return (elements, chi) for GF(q): elements as tuples, chi the quadratic
    character (chi[x] = 0 if x==0, +1 if x is a nonzero square, else -1)."""
    # factor q = p^k
    p = None
    for cand in range(2, q + 1):
        if q % cand == 0:
            p = cand
            break
    k = 0
    t = q
    while t > 1:
        assert t % p == 0, f"{q} is not a prime power"
        t //= p
        k += 1
    mod_poly = _find_irreducible(p, k)

    elements = []
    for idx in range(q):
        coeffs = []
        t = idx
        for _ in range(k):
            coeffs.append(t % p)
            t //= p
        elements.append(tuple(coeffs))

    squares = set()
    for e in elements:
        sq = tuple(_poly_mul_mod(list(e), list(e), mod_poly, p))
        squares.add(sq)

    zero = tuple([0] * k)

    def chi(x):
        if x == zero:
            return 0
        return 1 if x in squares else -1

    def sub(a, b):
        return tuple((ai - bi) % p for ai, bi in zip(a, b))

    return elements, chi, sub


# ---------------------------------------------------------------------------
# Hadamard matrix constructions
# ---------------------------------------------------------------------------


def _paley_I(q: int) -> np.ndarray:
    """Paley construction I: Hadamard matrix of order q+1 for prime power
    q === 3 (mod 4)."""
    assert q % 4 == 3
    elems, chi, sub = _gf_elements_and_chi(q)
    n = q + 1
    Q = np.empty((q, q), dtype=np.int8)
    for i, a in enumerate(elems):
        for j, b in enumerate(elems):
            Q[i, j] = chi(sub(a, b))
    S = np.zeros((n, n), dtype=np.int8)
    S[0, 1:] = 1
    S[1:, 0] = -1
    S[1:, 1:] = Q
    H = S + np.eye(n, dtype=np.int8)
    return H


def _paley_II(q: int) -> np.ndarray:
    """Paley construction II: Hadamard matrix of order 2(q+1) for prime power
    q === 1 (mod 4)."""
    assert q % 4 == 1
    elems, chi, sub = _gf_elements_and_chi(q)
    m = q + 1
    Q = np.empty((q, q), dtype=np.int8)
    for i, a in enumerate(elems):
        for j, b in enumerate(elems):
            Q[i, j] = chi(sub(a, b))
    S = np.zeros((m, m), dtype=np.int8)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    A = np.array([[1, 1], [1, -1]], dtype=np.int8)
    B = np.array([[1, -1], [-1, -1]], dtype=np.int8)
    H = np.kron(S, A) + np.kron(np.eye(m, dtype=np.int8), B)
    return H


# Orders the reference supports via hardcoded tables (hadamard_utils.py:5-83)
# and how we construct each. 92/156/172 have no Paley construction; they are
# Williamson-type orders: H = [[A,B,C,D],[-B,A,-D,C],[-C,D,A,-B],[-D,-C,B,A]]
# from symmetric +-1 circulants with A^2+B^2+C^2+D^2 = 4t I. The t=23 (order
# 92), t=39 (order 156), and t=43 (order 172) quadruples below were found by
# our own searches (tools/williamson_search.py: PSD filter + meet-in-the-
# middle over symmetric sequences) and are verified by the H H^T = n I
# assert at build -- every order the reference tabulates is covered by a
# generated construction.
_WILLIAMSON_ROWS = {
    23: (
        (1, -1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, 1, -1, 1, 1, -1, -1, -1),
        (1, -1, -1, 1, 1, -1, 1, 1, 1, 1, -1, -1, -1, -1, 1, 1, 1, 1, -1, 1, 1, -1, -1),
        (-1, 1, 1, 1, 1, 1, -1, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, -1, 1, 1, 1, 1, 1),
        (1, 1, 1, -1, 1, -1, 1, -1, 1, 1, -1, 1, 1, -1, 1, 1, -1, 1, -1, 1, -1, 1, 1),
    ),
    # rowsums (11, 5, 5, 1); found by tools/williamson_search.py, verified
    # H H^T = 172 I at build
    43: (
        (1, -1, 1, 1, 1, -1, 1, -1, -1, 1, 1, -1, -1, -1, 1, 1, 1, 1, 1, 1, 1,
         -1, -1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, 1, 1, -1),
        (1, -1, -1, 1, 1, -1, 1, 1, 1, -1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1,
         1, 1, -1, 1, 1, -1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, 1, -1, 1, 1, -1, -1),
        (1, 1, -1, 1, -1, -1, 1, 1, 1, 1, -1, 1, -1, -1, 1, -1, 1, -1, -1, -1, -1,
         -1, -1, -1, -1, -1, -1, 1, -1, 1, -1, -1, 1, -1, 1, 1, 1, 1, -1, -1, 1, -1, 1),
        (1, -1, -1, -1, 1, 1, -1, 1, 1, 1, -1, -1, 1, -1, 1, -1, 1, -1, 1, 1, -1,
         -1, -1, -1, 1, 1, -1, 1, -1, 1, -1, 1, -1, -1, 1, 1, 1, -1, 1, 1, -1, -1, -1),
    ),
    # rowsums (5, 5, 5, 9); found by tools/williamson_search.py (PSD-filtered
    # meet-in-the-middle over symmetric sequences), verified H H^T = 156 I
    39: (
        (1, -1, -1, -1, 1, -1, -1, 1, 1, 1, 1, -1, -1, -1, -1, 1, -1, 1, -1, 1,
         1, -1, 1, -1, 1, -1, -1, -1, -1, 1, 1, 1, 1, -1, -1, 1, -1, -1, -1),
        (1, -1, 1, 1, -1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1,
         1, 1, -1, 1, -1, 1, -1, -1, 1, 1, -1, -1, -1, -1, -1, -1, 1, 1, -1),
        (1, 1, -1, -1, 1, 1, 1, -1, 1, -1, -1, 1, 1, -1, 1, -1, -1, -1, -1, -1,
         -1, -1, -1, -1, -1, 1, -1, 1, 1, -1, -1, 1, -1, 1, 1, 1, -1, -1, 1),
        (1, -1, -1, -1, 1, -1, -1, -1, 1, -1, 1, 1, -1, 1, 1, -1, -1, -1, -1, 1,
         1, -1, -1, -1, -1, 1, 1, -1, 1, 1, -1, 1, -1, -1, -1, 1, -1, -1, -1),
    ),
}


def _williamson(t: int) -> np.ndarray:
    """Hadamard matrix of order 4t from a Williamson quadruple of order t."""
    rows = _WILLIAMSON_ROWS[t]

    def circ(row):
        r = np.asarray(row, dtype=np.int8)
        return np.stack([np.roll(r, k) for k in range(t)])

    A, B, C, D = map(circ, rows)
    return np.block(
        [[A, B, C, D], [-B, A, -D, C], [-C, D, A, -B], [-D, -C, B, A]]
    ).astype(np.int8)


_PALEY_RECIPES = {
    12: ("I", 11),
    20: ("I", 19),
    28: ("II", 13),
    36: ("II", 17),
    40: ("D", 20),  # Sylvester doubling of 20
    44: ("I", 43),
    52: ("II", 25),
    60: ("I", 59),
    68: ("I", 67),
    76: ("II", 37),
    84: ("I", 83),
    108: ("I", 107),
    140: ("I", 139),
    180: ("I", 179),
    244: ("I", 243),
}

# K-selection priority order copied from the reference's if/elif chain
# (hadamard_utils.py:5-83). Note 28/36 are tried before 40/20 there.
_K_PRIORITY = (244, 180, 172, 156, 140, 108, 92, 84, 76, 68, 60, 52, 44, 36, 28, 40, 20, 12)


@functools.lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """Return an n x n (+1/-1) Hadamard matrix, generated (not tabulated)."""
    if n == 1:
        return np.array([[1]], dtype=np.int8)
    if n == 2:
        return np.array([[1, 1], [1, -1]], dtype=np.int8)
    if n % 2 == 0 and is_pow2(n):
        H = hadamard_matrix(n // 2)
        return np.block([[H, H], [H, -H]]).astype(np.int8)
    if n % 4 == 0 and n // 4 in _WILLIAMSON_ROWS:
        H = _williamson(n // 4)
        Hl = H.astype(np.int64)
        assert (Hl @ Hl.T == n * np.eye(n, dtype=np.int64)).all(), n
        return H
    recipe = _PALEY_RECIPES.get(n)
    if recipe is None:
        raise NotImplementedError(
            f"No Hadamard construction for order {n}; supported orders are "
            f"powers of two, 4t for t in {sorted(_WILLIAMSON_ROWS)} "
            f"(Williamson), and {sorted(_PALEY_RECIPES)} (Paley I/II)."
        )
    kind, arg = recipe
    if kind == "I":
        H = _paley_I(arg)
    elif kind == "II":
        H = _paley_II(arg)
    else:  # doubling
        Hh = hadamard_matrix(arg)
        H = np.block([[Hh, Hh], [Hh, -Hh]]).astype(np.int8)
    # sanity: H H^T = n I (promote first: int8 matmul overflows for n > 127)
    Hl = H.astype(np.int64)
    assert (Hl @ Hl.T == n * np.eye(n, dtype=np.int64)).all(), f"bad Hadamard order {n}"
    return H


def get_hadK(n: int):
    """Factor n = K * 2^m following the reference's priority order.

    Returns (hadK, K) where hadK is the KxK Hadamard matrix as float32
    ndarray (or None when K == 1). Mirrors hadamard_utils.py:5-83.
    """
    for K in _K_PRIORITY:
        if n % K == 0 and is_pow2(n // K):
            return hadamard_matrix(K).astype(np.float32), K
    if is_pow2(n):
        return None, 1
    raise ValueError(f"cannot factor {n} into K * 2^m with a known Hadamard K")


@functools.lru_cache(maxsize=None)
def full_hadamard_matrix(n: int) -> np.ndarray:
    """Orthonormal n x n Hadamard H/sqrt(n) with the reference's K*2^m
    structure (chunk-FWHT then KxK mix == kron(H_K, H_m)); f32, as
    palu_tpu/ops/pallas/fwht.py builds the Pallas kernel's constant."""
    hadK, K = get_hadK(n)
    m = n // K
    h_m = hadamard_matrix(m).astype(np.float64)
    if K == 1:
        h = h_m
    else:
        h = np.kron(hadK.astype(np.float64), h_m)
    return (h / math.sqrt(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along `axis` (length 2^m),
    as log2(n) reshape/add/sub steps in x's dtype."""
    if axis != -1:
        x = x.movedim(axis, -1)
    n = x.shape[-1]
    if not is_pow2(n):
        raise ValueError(f"fwht length must be a power of two, got {n}")
    orig_shape = x.shape
    h = 1
    while h < n:
        x = x.reshape(*orig_shape[:-1], n // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    x = x.reshape(orig_shape)
    if axis != -1:
        x = x.movedim(-1, axis)
    return x


def apply_hadamard(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Multiply the last dim of x by the orthonormal Hadamard H_n / sqrt(n)
    (with transpose, by kron(H_K^T, H_m) / sqrt(n)). CUDA tensors run the
    FWHT kernel (ops/hadamard, n <= 4096, larger n raise); CPU tensors the
    JAX package's formulation in f32. Returns x's dtype."""
    if x.is_cuda:
        from ..ops.hadamard import hadamard_transform

        return hadamard_transform(x, transpose=transpose)
    n = x.shape[-1]
    hadK, K = get_hadK(n)
    xf = x.float()
    if K == 1:
        out = fwht(xf)
    else:
        xs = fwht(xf.reshape(*x.shape[:-1], K, n // K))
        hk = torch.from_numpy(hadK.T if transpose else hadK)
        out = torch.einsum("...km,jk->...jm", xs, hk).reshape(x.shape)
    # XLA compiles JAX's `out / sqrt(n)` as a multiply by the f32 reciprocal
    inv = float(np.float32(1.0) / np.float32(math.sqrt(n)))
    return (out * inv).to(x.dtype)


def random_sign_diagonal(n: int, seed: int = 0) -> np.ndarray:
    """Random +-1 diagonal for randomized-Hadamard rotations (QuIP#-style,
    reference random_hadamard_matrix, hadamard_utils.py:118-123)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=n) * 2 - 1).astype(np.float32)
