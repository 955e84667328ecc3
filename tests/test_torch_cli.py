"""The port's latency CLIs on the CPU (--use_cpu) at tiny sizes: each prints
the JSON records of its JAX counterpart in palu_tpu/cli, with the same keys,
and drives the paths it names (the plain versions here)."""

import json
import sys

import pytest

from palu_tpu.cli import run_latency_attention as jattn
from palu_tpu.cli import run_latency_kernel as jkernel
from palu_tpu.cli import serve_bench as jserve
from palu_tpu_torch.cli import run_latency_attention, run_latency_kernel, serve_bench
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
