"""The probes of palu_tpu_torch/tools (their plain versions on the CPU)
against the JAX tools' Pallas kernels in interpret mode, on the same inputs
at a small size, and each entry point end to end with --use_cpu.

The tool files run their benchmarks when imported, so each is loaded as its
imports and function definitions only (ast), into a namespace whose module
constants are set small and whose `pl.pallas_call` adds interpret=True.
Tolerances: checksums and extracted integer totals exact; the f32 paths
1e-5 of max|reference|; the dissect's full / nologits outputs 2e-3 of
max|JAX| (the bf16 class: the tool rounds the rotated K, q and p to bf16
before its dots); the bf16 GEMVs 2^-7 of max|JAX| (one bf16 output
rounding apart)."""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as jax_pl

from palu_tpu_torch.tools import dissect, gemv_probe, stream_probe, unpack_probe

ROOT = Path(__file__).resolve().parent.parent
MIX_TOL = 2e-3      # the dissect's bf16 class
F32_TOL = 1e-5
GEMV_TOL = 2.0 ** -7


class _InterpretPl:
    """jax.experimental.pallas with pallas_call running in interpret mode."""

    def __getattr__(self, name):
        return getattr(jax_pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        return jax_pl.pallas_call(*args, interpret=True, **kwargs)


@functools.lru_cache(maxsize=None)
def _tool_source(name: str):
    path = ROOT / "tools" / f"{name}.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    body = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    return compile(ast.Module(body=body, type_ignores=[]), str(path), "exec")


def load_tool(name: str, **consts) -> dict:
    """The tool's imports and functions, with `consts` as its module
    constants and pallas_call in interpret mode (no compile cache set)."""
    ns = {"__name__": f"_jax_{name}", **consts}
    exec(_tool_source(name), ns)
    ns["pl"] = _InterpretPl()
    return ns


def bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def np_fold(*arrays) -> int:
    """The probes' checksum in numpy: per 16-byte piece the XOR of its four
    little-endian words, summed."""
    total = 0
    for a in arrays:
        w = np.ascontiguousarray(a).view(np.uint32).reshape(-1, 4)
        total += int((w[:, 0] ^ w[:, 1] ^ w[:, 2] ^ w[:, 3]).astype(np.uint64).sum())
    return total


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# dissect
# ---------------------------------------------------------------------------

DS = dict(seq=512, block_s=128, hpg=2, rk=32, rv=64, hd=32, theta=10000.0)


def _dissect_case(g: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    hpg, rk, rv, hd, s = DS["hpg"], DS["rk"], DS["rv"], DS["hd"], DS["seq"]
    q = bf16(rng.standard_normal((1, g * hpg, hd)))
    b_k = bf16(rng.standard_normal((g, hpg, rk, hd)) * 0.1)
    x_k = bf16(rng.standard_normal((1, g, s, rk)))
    x_v = bf16(rng.standard_normal((1, g, s, rv)))
    kv_len = torch.tensor([s], dtype=torch.int32)
    return q, b_k, x_k, x_v, kv_len


def _jax_dissect(mode: str, g: int, ops):
    ns = load_tool("tpu_dissect", g=g, nh=g * DS["hpg"], half=DS["hd"] // 2, **DS)
    q, b_k, x_k, x_v, kv_len = (to_jax(t) for t in ops)
    b1, b2 = ns["split_b_halves"](b_k)
    q1, q2 = ns["_q_blockdiag"](q, g, DS["hpg"], DS["hd"] // 2)
    return np.asarray(ns["call"](mode, q1, q2, b1, b2, x_k, x_v, kv_len), np.float64)


@pytest.mark.parametrize("g", [1, 2])
def test_dissect_full_matches_jax(g):
    ops = _dissect_case(g)
    want = _jax_dissect("full", g, ops)
    got = dissect.palu_decode_fp_dissect("full", *ops)  # CPU: the plain version
    _close(got.numpy(), want, MIX_TOL)
    # and the production plain decode, both in f32
    from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp_ref
    _close(got.numpy(), palu_decode_fp_ref(*ops).numpy(), F32_TOL)


def test_dissect_nologits_matches_jax():
    """At G 1 the TPU block's group-0 fake logits and the port's per-group
    ones are the same function."""
    ops = _dissect_case(1, seed=1)
    want = _jax_dissect("nologits", 1, ops)
    got = dissect.palu_decode_fp_dissect("nologits", *ops)
    _close(got.numpy(), want, MIX_TOL)


def test_dissect_nologits_uses_each_groups_own_latents():
    q, b_k, x_k, x_v, kv_len = _dissect_case(2, seed=2)
    out = dissect.dissect_ref("nologits", q, b_k, x_k, x_v, kv_len)["out"]
    for gi in range(2):  # group gi alone gives its heads' rows
        one = dissect.dissect_ref("nologits", q[:, gi * 2:(gi + 1) * 2], b_k[gi:gi + 1],
                                  x_k[:, gi:gi + 1], x_v[:, gi:gi + 1], kv_len)["out"]
        assert torch.allclose(out[:, gi * 2:(gi + 1) * 2], one, rtol=0, atol=0)


def test_dissect_novalue_statistics_match_full():
    """novalue's (m, l) against the softmax statistics of the full logits,
    formed independently in f64."""
    q, b_k, x_k, x_v, kv_len = _dissect_case(2, seed=3)
    stats = dissect.palu_decode_fp_dissect("novalue", q, b_k, x_k, x_v, kv_len)
    _close(stats.numpy(), dissect.dissect_ref("full", q, b_k, x_k, x_v, kv_len)["stats"].numpy(),
           F32_TOL)
    hd, half, s = DS["hd"], DS["hd"] // 2, DS["seq"]
    k = np.einsum("gtr,ghrd->ghtd", x_k[0].double().numpy(), b_k.double().numpy())
    inv = 1.0 / 10000.0 ** (np.arange(half) * 2.0 / hd)
    ang = np.arange(s)[:, None] * inv[None, :]
    c, sn = np.cos(ang), np.sin(ang)
    r1 = k[..., :half] * c - k[..., half:] * sn
    r2 = k[..., half:] * c + k[..., :half] * sn
    qg = q[0].double().numpy().reshape(2, 2, hd)
    lg = (np.einsum("ghtd,ghd->ght", r1, qg[..., :half]) +
          np.einsum("ghtd,ghd->ght", r2, qg[..., half:])) / np.sqrt(hd)
    m = lg.max(-1)
    l = np.exp(lg - m[..., None]).sum(-1)
    _close(stats[0, :, 0].numpy(), m.reshape(-1), F32_TOL)
    _close(stats[0, :, 1].numpy(), l.reshape(-1), F32_TOL)


def test_dissect_dmaonly_and_noop_match_jax():
    """dmaonly: the f64 sum of every element against the tool's f32 sum
    (1e-5 of sum|x|), the checksum of 16-bit patterns against numpy; noop:
    the fold against numpy, and the tool's noop counts its S / block_s
    blocks."""
    g = 2
    ops = _dissect_case(g, seed=4)
    x_k, x_v = ops[2], ops[3]
    want = _jax_dissect("dmaonly", g, ops)
    ref = dissect.dissect_ref("dmaonly", *ops)
    scale = x_k.double().abs().sum() + x_v.double().abs().sum()
    assert abs(float(ref["sum"]) - want[0, 0, 0]) <= F32_TOL * float(scale)
    bits = sum(int(t.view(torch.int16).numpy().view(np.uint16).astype(np.int64).sum())
               for t in (x_k, x_v))
    assert int(dissect.palu_decode_fp_dissect("dmaonly", *ops)[0]) == bits
    assert int(dissect.palu_decode_fp_dissect("noop", *ops)[0]) == np_fold(
        x_k.view(torch.int16).numpy(), x_v.view(torch.int16).numpy())
    assert np.all(_jax_dissect("noop", g, ops) == DS["seq"] // DS["block_s"])


def test_dissect_walks_whole_tiles_below_kv_len():
    q, b_k, x_k, x_v, _ = _dissect_case(1, seed=5)
    kv_len = torch.tensor([100], dtype=torch.int32)  # tiles [0, 128)
    ck = dissect.dissect_ref("noop", q, b_k, x_k, x_v, kv_len)["checksum"]
    assert int(ck[0]) == np_fold(x_k[0, :, :128].contiguous().view(torch.int16).numpy(),
                                 x_v[0, :, :128].contiguous().view(torch.int16).numpy())


# ---------------------------------------------------------------------------
# stream probe
# ---------------------------------------------------------------------------

SP = dict(seq=1024, g=2, rk=32, rv=96)


@pytest.mark.parametrize("probe", ["bs256", "bs512", "merged256", "konly256"])
def test_stream_probe_matches_jax(probe):
    ns = load_tool("tpu_stream_probe", **SP)
    rng = np.random.default_rng(0)
    x = {"x_k": bf16(rng.standard_normal((1, SP["g"], SP["seq"], SP["rk"]))),
         "x_v": bf16(rng.standard_normal((1, SP["g"], SP["seq"], SP["rv"]))),
         "x_m": bf16(rng.standard_normal((SP["seq"], SP["g"] * (SP["rk"] + SP["rv"]))))}
    ns.update({k: to_jax(v) for k, v in x.items()})
    arrays, rows, _ = stream_probe._kernel_probe(probe, x)
    if probe.startswith("merged"):
        fn, args = ns["make_merged"](rows)
    else:
        fn, args = ns["make_split"](rows, konly=probe.startswith("konly"))
    c = rng.standard_normal((8, 128)).astype(np.float32)
    want = np.asarray(fn(jnp.asarray(c), *args))
    out, ck = stream_probe.stream_probe(torch.from_numpy(c), arrays, rows, 64)
    assert np.array_equal(out.numpy(), want)
    assert int(ck[0]) == np_fold(*(a.view(torch.int16).numpy() for a in arrays))


# ---------------------------------------------------------------------------
# unpack probe
# ---------------------------------------------------------------------------

UP = dict(seq=512, BS=128, g=2, rk=32, rv=64, hd=32, W=16)
INT_VARIANTS = ["ext4nc", "ext4cc", "ext3nc", "ext3cc", "conv8"]


@functools.lru_cache(maxsize=None)
def _unpack_case():
    rng = np.random.default_rng(7)
    g, rk, rv, s, bs, w = UP["g"], UP["rk"], UP["rv"], UP["seq"], UP["BS"], UP["W"]
    t = {"pk4": rng.integers(0, 255, (g, rk // 2, s), dtype=np.uint8),
         "pv4": rng.integers(0, 255, (g, rv // 2, s), dtype=np.uint8),
         "pk3": rng.integers(0, 255, (g, 3 * rk // 8, s), dtype=np.uint8),
         "pv3": rng.integers(0, 255, (g, 3 * rv // 8, s), dtype=np.uint8),
         "ck8": rng.integers(-127, 127, (g, rk, s), dtype=np.int8),
         "cv8": rng.integers(-127, 127, (g, rv, s), dtype=np.int8)}
    x = {k: torch.from_numpy(v) for k, v in t.items()}
    x["b1"] = bf16(rng.standard_normal((g, rk, w)) * 0.1)
    x["bv"] = bf16(rng.standard_normal((g, bs, 8)) * 0.1)
    return x


def _jax_unpack(variant: str):
    x = _unpack_case()
    ns = load_tool("tpu_unpack_probe", **UP, **{k: to_jax(v) for k, v in x.items()})
    fn, args = ns["make"](variant)
    return np.asarray(fn(jnp.zeros((8, 128), jnp.float32), *args), np.float64)


def _kw():
    return dict(rk=UP["rk"], rv=UP["rv"], bs=UP["BS"])


@pytest.mark.parametrize("variant", INT_VARIANTS)
def test_unpack_integer_variants_match_jax(variant):
    """The tool adds, per block, the first 128 tokens' column sums of every
    extracted value (times 1e-20): the port's per-token sums give the same;
    the port's total is their exact sum, and nc / cc agree."""
    x = _unpack_case()
    kc, vc = unpack_probe._operands(variant, x)[:2]
    tsum = unpack_probe.token_sums(variant, kc, vc, UP["rk"], UP["rv"]).numpy()
    want = _jax_unpack(variant)
    cols = tsum.reshape(-1, UP["BS"])[:, :128].sum(0) * 1e-20
    _close(want, np.broadcast_to(cols, (8, 128)), F32_TOL)
    total = unpack_probe.unpack_probe(variant, kc, vc, **_kw())
    assert int(total[0]) == int(tsum.sum())
    # an independent count: numpy bit arithmetic on the raw codes
    k, v = kc.numpy().astype(np.int64), vc.numpy().astype(np.int64)
    if variant.startswith("ext4"):
        raw = sum(int(((a & 15) + (a >> 4)).sum()) for a in (k, v))
    elif variant.startswith("ext3"):  # bit b of plane p is worth 2^p
        raw = 0
        for a in (k, v):
            r = a.shape[1] // 3
            for plane in range(3):
                raw += int(sum(((a[:, plane * r:(plane + 1) * r] >> b) & 1).sum()
                               for b in range(8))) << plane
    else:
        raw = int(k.sum() + v.sum())
    assert int(total[0]) == raw


def test_unpack_base_matches_jax():
    x = _unpack_case()
    want = _jax_unpack("base")
    k, v = x["pk4"].numpy().astype(np.float64), x["pv4"].numpy().astype(np.float64)
    blocks = [(k[0, 0:8, i:i + 128] + v[0, 0:8, i:i + 128]) * 1e-20
              for i in range(0, UP["seq"], UP["BS"])]
    _close(want, sum(blocks), F32_TOL)
    got = unpack_probe.unpack_probe("base", x["pk4"], x["pv4"], **_kw())
    assert int(got[0]) == np_fold(x["pk4"].numpy(), x["pv4"].numpy())


@pytest.mark.parametrize("variant", ["ext4mm", "ext4ccmm"])
def test_unpack_mm_variants_match_jax(variant):
    """The tool keeps token (row) i < 8 of each block's K product summed
    over W, and of V's products per part (ext4mm: row i of each part;
    ext4ccmm: rows 0-7 of part 0 as one scalar): formed from the port's
    extracted values, in f64. The port's own partials against a direct
    f64 product."""
    x = _unpack_case()
    g, bs, nb = UP["g"], UP["BS"], UP["seq"] // UP["BS"]
    xk = unpack_probe._values("ext4", x["pk4"], UP["rk"]).double()        # (G, rk, S)
    xv = unpack_probe._values("ext4", x["pv4"], UP["rv"]).double()        # (G, rv, S)
    bsum = x["b1"].double().sum(-1)                                      # (G, rk)
    psum = x["bv"].double().sum(-1)                                      # (G, BS)
    xb = torch.einsum("grs,gr->gs", xk, bsum).reshape(g, nb, bs)         # sum_w xb per token
    half = UP["rv"] // 2
    vrow = torch.einsum("grbt,gt->grb", xv.reshape(g, UP["rv"], nb, bs), psum)  # (G, rv, nb)
    k_rows = xb[:, :, :8].sum((0, 1))                                    # (8,)
    if variant == "ext4mm":
        v_rows = (vrow[:, :8] + vrow[:, half:half + 8]).sum((0, 2))
        expect = (k_rows + v_rows)[:, None].expand(8, 128)
    else:
        expect = k_rows[:, None].expand(8, 128) + vrow[:, :8].sum()
    _close(_jax_unpack(variant), (expect * 1e-20).numpy(), F32_TOL)
    got = unpack_probe.unpack_probe(variant, x["pk4"], x["pv4"], x["b1"], x["bv"], **_kw())
    direct_k = torch.einsum("grs,grw->gs", xk, x["b1"].double()).reshape(g, nb, bs).sum(-1)
    direct_v = torch.einsum("grbt,gtj->gb", xv.reshape(g, UP["rv"], nb, bs), x["bv"].double())
    _close(got.numpy(), torch.stack([direct_k, direct_v]).numpy(), F32_TOL)


def test_unpack_parts_match_jax_formulas():
    x = _unpack_case()
    ns = load_tool("tpu_unpack_probe", **UP)
    for rank, key in ((UP["rk"], "pk3"), (UP["rv"], "pv3")):
        ref = jnp.asarray(x[key].numpy())
        got = unpack_probe.unpack3_parts(x[key][0], rank)
        for a, b in zip(got, ns["unpack3_parts"](ref, 0, rank)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(unpack_probe.unpack4_parts(x["pk4"][1]),
                    ns["unpack4_parts"](jnp.asarray(x["pk4"].numpy()), 1)):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# GEMV probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("transposed", [False, True], ids=["W", "WT"])
def test_gemv_bf16_matches_jax(rows, transposed):
    k, n, bn = 256, 512, 128
    ns = load_tool("tpu_gemv_probe", K=k, N=n, BN=bn)
    rng = np.random.default_rng(rows)
    w = bf16(rng.standard_normal((k, n)) * 0.02)
    x = bf16(rng.standard_normal((rows, k)) * 0.1)
    if transposed:
        wt = w.t().contiguous()
        want = ns["gemv_pallas_t"](to_jax(x), to_jax(wt), bn)
        got = gemv_probe.gemv_bf16_t(x, wt, bn)
    else:
        want = ns["gemv_pallas"](to_jax(x), to_jax(w), bn)
        got = gemv_probe.gemv_bf16(x, w, bn)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), GEMV_TOL)


# ---------------------------------------------------------------------------
# entry points with --use_cpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,argv,n", [
    (dissect, ["256", "64", "--use_cpu", "--json"], 5),
    (stream_probe, ["--seq", "512", "--use_cpu", "--json", "bs128", "merged256", "konly64",
                    "xla128", "xlasum"], 5),
    (unpack_probe, ["--seq", "512", "--bs", "128", "--use_cpu", "--json"], 8),
    (gemv_probe, ["--k", "256", "--n", "512", "--k2", "256", "--n2", "384", "--bn", "128",
                  "--use_cpu", "--json", "xla", "xla8", "xlaT", "pallas", "pallasT", "all3",
                  "nop", "kgemv", "kmlp", "i8", "i8noscale", "bfmlp", "i8mlp3"], 13),
], ids=["dissect", "stream_probe", "unpack_probe", "gemv_probe"])
def test_entry_points_run_on_cpu(tool, argv, n, capsys):
    recs = tool.main(argv)
    assert len(recs) == n
    assert all("cpu_ms" in r and "us" not in r for r in recs)
    assert all(r["held"]["ok"] for r in recs if "held" in r)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == n


def test_entry_points_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for tool in (dissect, stream_probe, unpack_probe, gemv_probe):
        with pytest.raises(RuntimeError):
            tool.main([])


def test_knobs_and_variant_names_are_the_tools(monkeypatch):
    monkeypatch.setenv("NCH", "7")
    monkeypatch.setenv("SEQ", "2048")
    assert stream_probe.parser().parse_args([]).nch == 7
    assert unpack_probe.parser().parse_args([]).seq == 2048
    monkeypatch.delenv("NCH")
    monkeypatch.delenv("SEQ")
    assert dissect.parser().parse_args([]).seq == 65536
    assert dissect.parser().parse_args([]).block_s == 1024
    assert stream_probe.DEFAULT_PROBES == ["bs1024", "bs4096", "merged1024", "merged4096",
                                           "konly1024", "xla2048", "xlasum"]
    assert unpack_probe.VARIANTS == ("base", "ext4nc", "ext4cc", "ext4mm", "ext4ccmm",
                                     "ext3nc", "ext3cc", "conv8")
    assert gemv_probe.DEFAULT_PROBES == ["xla", "xla8", "xlaT", "pallas", "pallasT", "all3"]
    a = unpack_probe.parser().parse_args([])
    assert (a.seq, a.bs, a.nch) == (65536, 1024, 64)
    a = gemv_probe.parser().parse_args([])
    assert (a.nch, a.bn, a.kbn) == (96, 512, 0)
    with pytest.raises(SystemExit):
        gemv_probe.main(["--use_cpu", "--kbn", "256", "--k", "256", "--n", "256",
                         "--k2", "256", "--n2", "256", "kgemv"])
