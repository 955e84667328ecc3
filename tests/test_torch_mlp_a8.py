"""palu_tpu_torch.tools.mlp_a8_probe: the W8A8 MLP's plain version on the
CPU against the JAX tool's Pallas kernel (tools/tpu_mlp_a8_probe.py, loaded
as in test_torch_probes with H, INTER and BN set small and pallas_call in
interpret mode), on the same int8 weights and bf16 activation row, and the
entry point with --use_cpu.

The activation codes xq are held bit for bit. The codes of h are held
within 1: JAX's silu (x * logistic(x)) and PyTorch's (x / (1 + exp(-x)))
differ in the last bits, so a code on a rounding edge can move; at this
size (H 256, I 512, BN 128, 4 rows) no code differs, and the count is
asserted so that a change shows. The output is held within 2^-7 of
max|JAX| (bf16 output, one rounding apart plus such a code)."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu_torch.core.wquant import quantize_weight
from palu_tpu_torch.tools import mlp_a8_probe
from test_torch_probes import load_tool, to_jax

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(H=256, INTER=512, BN=128, CHAIN=2, K=2)
GEMV_TOL = 2.0 ** -7
# codes of h that differ from JAX's at this size (asserted, see above)
HQ_DIFFERING = 0


def _weights(seed: int, rows: int):
    rng = np.random.default_rng(seed)
    h, i = SMALL["H"], SMALL["INTER"]

    def w(shape):
        return quantize_weight(torch.from_numpy(
            (rng.standard_normal(shape) * 0.02).astype(np.float32)))

    x = torch.from_numpy((rng.standard_normal((rows, h)) * 0.1).astype(np.float32))
    return x.bfloat16(), w((h, i)), w((h, i)), w((i, h))


def _jax_w(w):
    return {"wq8": jnp.asarray(w["wq8"].numpy()), "ws": jnp.asarray(w["ws"].numpy())}


def _jax_codes(x, wg, wu):
    """JAX's xq and hq, formed by the tool kernel's own jnp lines (outside
    pallas_call): xq of the row, hq of each BN tile."""
    xb = x.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xb), axis=1, keepdims=True) / 127.0, 1e-30)
    xq = jnp.round(xb / xs).astype(jnp.int8)

    def dot(w):
        return jax.lax.dot_general(xq, w["wq8"], (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32).astype(jnp.float32)

    h = jax.nn.silu(dot(wg) * (xs * wg["ws"])) * (dot(wu) * (xs * wu["ws"]))
    tiles = []
    for n0 in range(0, h.shape[1], SMALL["BN"]):
        ht = h[:, n0:n0 + SMALL["BN"]]
        hs = jnp.maximum(jnp.max(jnp.abs(ht), axis=1, keepdims=True) / 127.0, 1e-30)
        tiles.append(jnp.round(ht / hs).astype(jnp.int8))
    return np.asarray(xq), np.asarray(jnp.concatenate(tiles, axis=1))


@pytest.mark.parametrize("rows,seed", [(1, 0), (4, 1)])
def test_mlp_a8_matches_jax(rows, seed):
    x, wg, wu, wd = _weights(seed, rows)
    ns = load_tool("tpu_mlp_a8_probe", **SMALL)
    jw = [_jax_w(w) for w in (wg, wu, wd)]
    want = np.asarray(ns["mlp_a8"](to_jax(x), *jw).astype(jnp.float32))
    xq_j, hq_j = _jax_codes(to_jax(x), jw[0], jw[1])
    out, xq, hq = mlp_a8_probe.mlp_a8(x, wg, wu, wd, bn=SMALL["BN"], codes=True)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert np.array_equal(xq.numpy(), xq_j)
    diff = np.abs(hq.numpy().astype(np.int32) - hq_j.astype(np.int32))
    assert diff.max() <= 1
    assert int((diff > 0).sum()) == HQ_DIFFERING
    err = np.abs(out.float().numpy() - want).max()
    assert err <= GEMV_TOL * np.abs(want).max(), err


def test_mlp_a8_tile_scale_is_per_bn():
    """bn is part of the function: h's scale covers one tile of bn columns."""
    x, wg, wu, wd = _weights(2, 1)
    a = mlp_a8_probe.mlp_a8_ref(x, wg, wu, wd, bn=128, codes=True)
    b = mlp_a8_probe.mlp_a8_ref(x, wg, wu, wd, bn=512, codes=True)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[2], b[2])


def _tool_variants():
    """The keys the JAX tool's main times: r["w8a16"], r["a8"]."""
    tree = ast.parse((ROOT / "tools" / "tpu_mlp_a8_probe.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [t.slice.value for n in ast.walk(main) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript) and isinstance(t.slice,
                                                                               ast.Constant)]


def test_entry_point_runs_on_cpu(capsys, monkeypatch):
    assert mlp_a8_probe.VARIANTS == _tool_variants()
    monkeypatch.setenv("BN", "64")
    assert mlp_a8_probe.parser().parse_args([]).bn == 64
    monkeypatch.delenv("BN")
    a = mlp_a8_probe.parser().parse_args([])
    assert (a.h, a.inter, a.bn, a.nch) == (4096, 11008, 256, 64)
    recs = mlp_a8_probe.main(["--use_cpu", "--json", "--h", "256", "--inter", "512",
                              "--bn", "128"])
    assert [r["variant"] for r in recs] == ["w8a16", "a8", "summary"]
    assert all("cpu_ms" in r and "us" not in r for r in recs[:2])
    assert recs[1]["held"]["ok"] and recs[1]["held"]["xq"]["tol"] == "exact"
    assert 0 < recs[2]["rel_err"] < 0.1
    assert len(capsys.readouterr().out.strip().splitlines()) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mlp_a8_probe.main([])
