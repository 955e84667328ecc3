"""The port's CLIs on the CPU (--use_cpu) at tiny sizes: each latency CLI
prints the JSON records of its JAX counterpart in palu_tpu/cli, with the
same keys, and drives the paths it names (the plain versions here); the
compression CLI writes the JAX CLI's checkpoint."""

import json
import sys

import numpy as np
import pytest
import torch

from palu_tpu.cli import run_latency_attention as jattn
from palu_tpu.cli import run_latency_kernel as jkernel
from palu_tpu.cli import serve_bench as jserve
from palu_tpu_torch.cli import run_latency_attention, run_latency_kernel, serve_bench
from palu_tpu_torch.ops.hadamard import hadamard_transform
from palu_tpu_torch.ops.palu_decode import palu_decode
from palu_tpu_torch.ops.palu_decode_fp import palu_decode_fp
from palu_tpu_torch.ops.palu_decode_seq import palu_decode_seq_quantized


def _json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def _jax_cli(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    capsys.readouterr()
    mod.main()
    return _json_lines(capsys.readouterr().out)


def _port_cli(mod, argv, capsys):
    capsys.readouterr()
    mod.main([*argv, "--use_cpu"])
    return _json_lines(capsys.readouterr().out)


KERNEL = ["--num_heads", "8", "--head_dim", "32", "--total_rank", "64", "--total_rank_v",
          "128", "--target_seq_lens", "100", "200", "--block_s", "64", "--json"]


@pytest.mark.parametrize("lt_bits", ["16", "3"])
def test_run_latency_kernel_keys(lt_bits, monkeypatch, capsys):
    """The plain providers' keys against the JAX CLI's (its `ours` needs the
    TPU), then `ours` through the wrappers' plain versions."""
    argv = [*KERNEL, "--lt_bits", lt_bits]
    want = _jax_cli(jkernel, [*argv, "--providers", "WX", "xla"], monkeypatch, capsys)
    got = _port_cli(run_latency_kernel, [*argv, "--providers", "WX", "xla"], capsys)
    assert [set(r) for r in got] == [set(r) for r in want]
    assert [r["seq_len"] for r in got] == [100, 200]
    n = (palu_decode_fp.launches, palu_decode_seq_quantized.launches)
    ours = _port_cli(run_latency_kernel, argv, capsys)
    assert [set(r) for r in ours] == [set(r) | {"ours_us", "ours_p20", "ours_p80"}
                                      for r in want]
    assert all(r["ours_us"] > 0 for r in ours)
    assert (palu_decode_fp.launches, palu_decode_seq_quantized.launches) == n  # CPU: plain


ATTN = ["--prompt_len", "150", "--n_steps", "2", "--num_heads", "8", "--head_dim", "32",
        "--vocab_size", "128", "--total_rank_k", "64", "--total_rank_v", "128",
        "--decode_chunk", "64", "--json"]


@pytest.mark.parametrize("extra,path", [
    (["--palu", "--lt_bits", "3", "--lt_sym", "--lt_container", "4"], "palu_decode-plain"),
    (["--palu", "--lt_bits", "3", "--lt_sym", "--lt_container", "4", "--int8_rot"],
     "palu_decode_int8_rot-plain"),
    (["--palu", "--lt_bits", "4", "--int8_dots", "--v_byte_dot", "0"],
     "palu_decode_int8_dots-plain"),
    (["--palu"], "palu_decode_fp-plain"),
    ([], "dense_flash-plain"),
], ids=["palu_3bit", "int8_rot", "int8_dots", "palu_bf16", "dense"])
def test_run_latency_attention_keys(extra, path, monkeypatch, capsys):
    """Same record keys and mode as the JAX CLI (its XLA paths:
    --no_pallas), and the port's engine took the named decode path."""
    want = _jax_cli(jattn, [*ATTN, *extra, "--no_pallas"], monkeypatch, capsys)
    args = run_latency_attention.parser().parse_args([*ATTN, *extra, "--use_cpu"])
    stats, engine = run_latency_attention.run(args)
    assert set(stats) == set(want[0])
    assert (stats["mode"], stats["lt_bits"]) == (want[0]["mode"], want[0]["lt_bits"])
    assert stats["tpot_ms"] > 0 and stats["n_steps"] == 2
    assert engine._decode_paths == {path}
    assert engine.ecfg.s_max == 192  # ((150 + 2 + 16) // 64 + 1) * 64, as in JAX
    with pytest.raises(SystemExit):  # not carried over: no plain switch on the card
        run_latency_attention.parser().parse_args([*ATTN, "--no_pallas"])


SERVE = ["--num_requests", "5", "--lanes", "2", "--prompt_len", "24", "--max_new_tokens",
         "3", "--s_max", "64", "--num_layers", "2", "--num_heads", "4", "--head_dim", "32",
         "--rank", "32", "--vocab_size", "128", "--decode_chunk", "16", "--json"]


@pytest.mark.parametrize("extra", [
    [],
    ["--lt_bits", "3", "--lt_sym", "--lt_container", "4", "--int8_rot", "--pallas_block",
     "32", "--steady_steps", "2", "--chained_ref", "2", "--sample_frac", "0.5"],
], ids=["default", "int8_rot_steady"])
def test_serve_bench_keys(extra, monkeypatch, capsys):
    """The record's keys (and the steady record's) and its counts equal the
    JAX CLI's; every request finishes on the native scheduler."""
    want = _jax_cli(jserve, [*SERVE, *extra, "--use_cpu"], monkeypatch, capsys)[0]
    n = palu_decode.launches
    got = _port_cli(serve_bench, [*SERVE, *extra], capsys)[0]
    assert set(got) == set(want)
    assert set(got.get("steady", {})) == set(want.get("steady", {}))
    for key in ("requests", "total_tokens", "lanes", "scheduler"):
        assert got[key] == want[key], key
    assert got["scheduler"] == "NativeScheduler" and got["requests"] == 5
    assert palu_decode.launches == n


def _unrotated_factors(sd, n_layers, groups):
    """Per (layer, side, group): U_g (group_dim, r) and VT_g^T (in, r) of a
    Hadamard-fused checkpoint with the rotation undone (H is orthogonal:
    apply_hadamard with transpose inverts it), in f32."""
    from palu_tpu_torch.core.hadamard import apply_hadamard

    out = {}
    for i in range(n_layers):
        for side in ("k_proj", "v_proj"):
            pre = f"model.layers.{i}.self_attn.{side}"
            vt = torch.from_numpy(sd[f"{pre}.VT.weight"].astype(np.float32))
            off = 0
            for g in range(groups):
                u = torch.from_numpy(sd[f"{pre}.U.{g}.weight"].astype(np.float32))
                r = u.shape[1]
                out[pre, g] = (apply_hadamard(u, transpose=True),
                               apply_hadamard(vt[off:off + r].T, transpose=True))
                off += r
    return out


def test_compress_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """cli.compress --use_cpu (uniform search, svd, --hadamard) on a tiny
    dense checkpoint writes what the JAX CLI writes: the same config.json
    and the same tensors, the low-rank factors up to the SVD's per-rank
    sign (compared with the rotation undone, within 1e-2 of max: both are
    bf16 values stored in f16), and their products U_g VT_g as they are.
    The port's checkpoint then loads into the port's engine and serves."""
    from safetensors.numpy import load_file

    import jax
    import jax.numpy as jnp
    from palu_tpu.cli import compress as jcompress
    from palu_tpu.models import hf_io as jhf
    from palu_tpu.models import llama as jl
    from palu_tpu.models.config import ModelConfig
    from palu_tpu_torch.cli import compress
    from palu_tpu_torch.core.quant import QuantConfig
    from palu_tpu_torch.models import hf_io
    from palu_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=192,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
    src = tmp_path / "tiny-llama"
    jhf.save_checkpoint(jl.init_params(cfg, jax.random.key(0), dtype=jnp.float32), cfg,
                        str(src), dtype=np.float32)
    argv = ["--model_name_or_path", str(src), "--search_method", "uniform",
            "--decompose_method", "svd", "--hadamard", "--param_ratio_target", "0.5",
            "--use_cpu"]
    jdir = tmp_path / "jax_out"
    monkeypatch.setattr(sys, "argv", ["compress", *argv, "--output_dir", str(jdir)])
    capsys.readouterr()
    jcompress.main()
    jout = capsys.readouterr().out
    monkeypatch.chdir(tmp_path)
    n = hadamard_transform.launches
    compress.main(argv)  # default output directory, in the working directory
    tout = capsys.readouterr().out
    tdir = tmp_path / "tiny-llama_ratio-0.5_gs-4-uniform"
    assert tout == jout.replace(str(jdir), tdir.name)
    assert hadamard_transform.launches == n  # on the CPU: the plain version

    with open(jdir / "config.json") as f, open(tdir / "config.json") as g:
        jcfg_raw, tcfg_raw = json.load(f), json.load(g)
    assert tcfg_raw == jcfg_raw
    assert tcfg_raw["head_wise_ranks"]["model.layers.1.self_attn.v_proj"] == [64]
    want = load_file(str(jdir / "model.safetensors"))
    got = load_file(str(tdir / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float16 and got[k].shape == want[k].shape
        if ".VT." not in k and ".U." not in k:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fw, fg = _unrotated_factors(want, 2, 1), _unrotated_factors(got, 2, 1)
    for key, (wu, wvt) in fw.items():
        gu, gvt = fg[key]
        sign = torch.where((gvt * wvt).sum(0) < 0, -1.0, 1.0)
        for a, b in ((gu * sign, wu), (gvt * sign, wvt)):
            assert (a - b).abs().max() <= 1e-2 * b.abs().max(), key
        prod_w, prod_g = wu @ wvt.T, gu @ gvt.T
        assert (prod_g - prod_w).abs().max() <= 1e-2 * prod_w.abs().max(), key

    params, lcfg = hf_io.load_params(str(tdir), dtype=torch.float32, device="cpu")
    eng = Engine(params, lcfg, EngineConfig(s_max=32, dtype=torch.float32, decode_chunk=16,
                                            qcfg=QuantConfig(bits=3, group_size=0, sym=True,
                                                             container=4), device="cpu"))
    toks = eng.generate(np.arange(10)[None, :] % 128, max_new_tokens=4)
    assert toks.shape == (1, 4) and eng._decode_paths == {"palu_decode-plain"}
