"""The port's eval CLIs (palu_tpu_torch.cli.run_ppl_eval, run_lm_eval,
run_long_bench; cli.common) with --use_cpu against their JAX counterparts
in palu_tpu/cli, on one tiny compressed checkpoint both read: a random
2-layer Llama written by transformers, compressed by the port's CLI
(uniform ranks, SVD), with a BPE tokenizer trained offline on this file's
text (as tests/test_cli.py trains one). Both load bf16 weights, as the CLIs
do."""

import argparse
import json
import os
import re
import sys
import warnings

import numpy as np
import pytest
import torch

from palu_tpu.cli import common as jcommon
from palu_tpu.cli import run_lm_eval as jlm
from palu_tpu.cli import run_long_bench as jlb
from palu_tpu.cli import run_ppl_eval as jppl
from palu_tpu_torch.cli import common, compress, run_lm_eval, run_long_bench, run_ppl_eval
from palu_tpu_torch.models import llama
from palu_tpu_torch.ops.hadamard import hadamard_transform
from test_torch_evals import _fixture_docs

TASKS = "openbookqa,hellaswag,piqa,arc_easy,arc_challenge,winogrande"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(checkpoint dir, corpus path, fixture dir)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    root = tmp_path_factory.mktemp("eval_cli")
    torch.manual_seed(3)
    src = str(root / "dense")
    LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=512,
        initializer_range=0.2)).float().save_pretrained(src, safe_serialization=True)
    with open(__file__) as f:
        text = f.read() * 4
    corpus = str(root / "corpus.txt")
    with open(corpus, "w") as f:
        f.write(text)
    bpe = Tokenizer(models.BPE(unk_token="<unk>"))
    bpe.pre_tokenizer = pre_tokenizers.Whitespace()
    bpe.train_from_iterator([text], trainers.BpeTrainer(
        vocab_size=500, special_tokens=["<unk>", "<s>", "</s>"]))
    tok = PreTrainedTokenizerFast(tokenizer_object=bpe, unk_token="<unk>", bos_token="<s>",
                                  eos_token="</s>")
    out = str(root / "palu")
    compress.main(["--model_name_or_path", src, "--output_dir", out, "--search_method",
                   "uniform", "--decompose_method", "svd", "--head_group_size", "2",
                   "--param_ratio_target", "0.8", "--use_cpu"])
    tok.save_pretrained(out)
    fixtures = root / "fixtures"
    fixtures.mkdir()
    for task in TASKS.split(","):
        with open(fixtures / f"{task}.jsonl", "w") as f:
            f.writelines(json.dumps(d) + "\n" for d in _fixture_docs(task))
    rng = np.random.default_rng(0)
    words = text.split()
    for name in ("qasper", "trec"):
        with open(fixtures / f"{name}.jsonl", "w") as f:
            for i in range(2):
                f.write(json.dumps({
                    "context": " ".join(rng.choice(words, 60)), "input": f"what is {i}?",
                    "answers": ["ckpt", "the model"], "all_classes": ["ckpt", "model"],
                }) + "\n")
    return out, corpus, str(fixtures)


def _jax_main(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _port_main(mod, argv, capsys):
    capsys.readouterr()
    mod.main([*argv, "--use_cpu"])
    return capsys.readouterr().out


def test_common_args_match_jax():
    want, got = argparse.ArgumentParser(), argparse.ArgumentParser()
    jcommon.add_common_args(want)
    common.add_common_args(got)
    assert ({a.dest: (a.default, a.required) for a in got._actions}
            == {a.dest: (a.default, a.required) for a in want._actions})
    argv = ["--model_name_or_path", "m", "--lt_bits", "3", "--lt_sym", "--lt_hadamard",
            "--lt_group_size", "8", "--lt_clip_ratio", "0.9", "--lt_container", "4"]
    import dataclasses

    assert dataclasses.asdict(common.quant_config_from_args(got.parse_args(argv))) == \
        dataclasses.asdict(jcommon.quant_config_from_args(want.parse_args(argv)))


def test_load_for_eval_fuses_hadamard_like_jax(ckpt):
    """--lt_hadamard: the same fused VT / U / w_fused as JAX's load_for_eval
    (the FWHT's plain version on the CPU; SVD factors carried in the file),
    in bf16 within one rounding, and the forward's logits agree with the
    unfused load (the rotation cancels)."""
    import jax

    out, _, _ = ckpt
    args = argparse.Namespace(model_name_or_path=out, lt_hadamard=True, use_cpu=True)
    n = hadamard_transform.launches
    got, cfg = common.load_for_eval(args)
    assert hadamard_transform.launches == n  # CPU tensors: the plain version
    want, _ = jcommon.load_for_eval(args)
    for tl, jl in zip(got["layers"], want["layers"]):
        for which in ("k_proj", "v_proj"):
            for key in ("VT", "U"):
                t = tl["attn"][which][key].float().numpy()
                j = np.asarray(jax.numpy.asarray(jl["attn"][which][key], "float32"))
                assert np.abs(t - j).max() <= 2.0**-7 * np.abs(j).max(), (which, key)
        t = tl["attn"]["o_proj"]["w_fused"].float().numpy()
        j = np.asarray(jax.numpy.asarray(jl["attn"]["o_proj"]["w_fused"], "float32"))
        assert np.abs(t - j).max() <= 2.0**-7 * np.abs(j).max()
    plain, _ = common.load_for_eval(argparse.Namespace(model_name_or_path=out,
                                                       lt_hadamard=False, use_cpu=True))
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (1, 32)))
    a = llama.forward(_f32(got), ids, cfg, value_mode="fused")
    b = llama.forward(_f32(plain), ids, cfg, value_mode="fused")
    assert (a - b).abs().max() <= 2e-2 * b.abs().max()


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_f32(v) for v in tree)
    return tree.float() if torch.is_tensor(tree) else tree


def test_load_for_eval_refuses_ragged_and_missing_cuda(ckpt, monkeypatch):
    out, _, _ = ckpt
    args = argparse.Namespace(model_name_or_path=out, lt_hadamard=True, use_cpu=True)
    from palu_tpu_torch.models import hf_io

    real = hf_io.load_params

    def ragged(*a, **kw):
        params, cfg = real(*a, **kw)
        p = params["layers"][0]["attn"]["k_proj"]
        params["layers"][0]["attn"]["k_proj"] = {
            "VT": p["VT"][:, :-1], "U": (p["U"][0], p["U"][1][:-1])}
        return params, cfg

    monkeypatch.setattr(hf_io, "load_params", ragged)
    with pytest.raises(ValueError, match="one rank in every group"):
        common.load_for_eval(args)
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            common.load_for_eval(argparse.Namespace(model_name_or_path=out,
                                                    lt_hadamard=False, use_cpu=False))
        for mod in (run_ppl_eval, run_lm_eval, run_long_bench):
            with pytest.raises(RuntimeError, match="CUDA"):
                mod.main(["--model_name_or_path", out])


# bf16 weights and activations in both packages, summed in different
# orders: each token's NLL moves by a few bf16 roundings of the logits
# (2^-8 of a value each), and the ppl by as much relative to its mean NLL
PPL_RTOL = 2e-2


@pytest.mark.parametrize("extra", [[], ["--lt_bits", "3", "--lt_sym", "--lt_hadamard"],
                                   ["--lt_bits", "4", "--lt_group_size", "8"]],
                         ids=["bf16", "3bit_sym_hadamard", "4bit_asym_gs8"])
def test_run_ppl_eval_matches_jax(ckpt, extra, monkeypatch, capsys):
    out, corpus, _ = ckpt
    argv = ["--model_name_or_path", out, "--datasets", "wikitext2", "--seqlen", "64",
            "--local_text_path", corpus, *extra]
    want = _jax_main(jppl, [*argv, "--use_cpu"], monkeypatch, capsys)
    got = _port_main(run_ppl_eval, argv, capsys)
    pat = re.compile(r"^PPL \[wikitext2\]: ([0-9.eE+-]+)$", re.M)
    (w,), (g,) = pat.findall(want), pat.findall(got)
    assert np.isfinite(float(g)) and float(g) > 1.0
    assert abs(float(g) - float(w)) <= PPL_RTOL * float(w), (got, want)


def test_run_lm_eval_matches_jax(ckpt, tmp_path, monkeypatch, capsys):
    out, _, fixtures = ckpt
    argv = ["--model_name_or_path", out, "--tasks", TASKS, "--fixture_dir", fixtures,
            "--lt_bits", "3", "--lt_sym"]
    _jax_main(jlm, [*argv, "--output_dir", str(tmp_path / "jax"), "--use_cpu"],
              monkeypatch, capsys)
    printed = _port_main(run_lm_eval, [*argv, "--output_dir", str(tmp_path / "port")], capsys)
    name = f"{os.path.basename(out)}_3.json"
    with open(tmp_path / "jax" / name) as f:
        want = json.load(f)
    with open(tmp_path / "port" / name) as f:
        got = json.load(f)
    assert got == want and list(got) == TASKS.split(",")
    assert json.loads(printed) == got
    args = ["--model_name_or_path", out, "--tasks", "piqa", "--fixture_dir", fixtures,
            "--max_samples", "1", "--output_dir", str(tmp_path / "one")]
    _port_main(run_lm_eval, args, capsys)
    with open(tmp_path / "one" / f"{os.path.basename(out)}_16.json") as f:
        assert set(json.load(f)) == {"piqa"}


def _recorded_generate(monkeypatch, engine_cls, runs):
    """Engine.generate of `engine_cls` that appends (engine, prompt ids,
    new tokens) to `runs`."""
    real = engine_cls.generate

    def generate(self, input_ids, *a, **kw):
        toks = real(self, input_ids, *a, **kw)
        runs.append((self, np.asarray(input_ids), np.asarray(toks)))
        return toks

    monkeypatch.setattr(engine_cls, "generate", generate)


# The two CLIs' bf16 engines' parity, as a share of max|logits|: the
# largest gap between their logits at the step where their greedy tokens
# part. Over the bf16 cache each logit is a bf16 value (one ulp of the top
# binade is 2^-8 to 2^-7 of max|logits|) from bf16 activations summed in
# another order: 4 ulps. Over the 3-bit cache a bf16 latent on a code's
# rounding edge takes the neighbouring code: each bf16 engine parts from its
# own f32 run by ~13 % of max|logits| at a prefill of this checkpoint (the
# f32 engines agree to 1e-6), so two of them may part by twice that.
GREEDY_PARITY = {"bf16_cache": 2.0**-5, "3bit_cache": 0.25}


def _margin_at_divergence(jeng, eng, prompt, jax_toks, port_toks):
    """(step, margin, gap) at the first step the two token runs part, each
    engine prefilling the common prefix: the larger of the two engines'
    margins between their two tokens and the largest gap between their
    logits, both as shares of max|logits|. None when the runs agree."""
    n = min(len(jax_toks), len(port_toks))
    diff = np.nonzero(jax_toks[:n] != port_toks[:n])[0]
    if len(diff) == 0:
        assert len(jax_toks) == len(port_toks)
        return None
    step = int(diff[0])
    ids = np.concatenate([prompt, port_toks[None, :step]], axis=1)
    tl = eng.prefill_auto(ids)[0][0, -1].float().numpy()
    jl = np.asarray(jeng.prefill_auto(ids)[0][0, -1], np.float32)
    a, b = int(port_toks[step]), int(jax_toks[step])
    scale = np.abs(jl).max()
    margin = max(abs(tl[a] - tl[b]), abs(jl[a] - jl[b])) / scale
    return step, float(margin), float(np.abs(tl - jl).max() / scale)


@pytest.mark.parametrize("extra", [[], ["--lt_bits", "3", "--lt_sym", "--lt_container", "4"]],
                         ids=["bf16_cache", "3bit_cache"])
def test_run_long_bench_matches_jax(ckpt, extra, tmp_path, monkeypatch, capsys):
    """Both CLIs' greedy tokens, sample by sample: equal, or parted first at
    a step where the margin between the two tokens and the engines' gap
    there both lie within GREEDY_PARITY (then the step and margin are
    reported and the scores may differ); equal tokens give equal predictions,
    and all-equal runs equal scores."""
    cache = "3bit_cache" if extra else "bf16_cache"
    from palu_tpu.runtime.engine import Engine as JEngine
    from palu_tpu_torch.runtime.engine import Engine

    out, _, fixtures = ckpt
    argv = ["--model_name_or_path", out, "--datasets", "qasper,trec", "--fixture_dir",
            fixtures, "--max_prompt_len", "96", "--s_max", "256", *extra]
    jruns, truns = [], []
    _recorded_generate(monkeypatch, JEngine, jruns)
    _recorded_generate(monkeypatch, Engine, truns)
    want = _jax_main(jlb, [*argv, "--output_path", str(tmp_path / "j.jsonl"), "--use_cpu"],
                     monkeypatch, capsys)
    got = _port_main(run_long_bench, [*argv, "--output_path", str(tmp_path / "t.jsonl")],
                     capsys)
    scores = re.findall(r"^(qasper|trec): ([0-9.]+)$", got, re.M)
    assert [s[0] for s in scores] == ["qasper", "trec"]
    assert all(0.0 <= float(s) <= 100.0 for _, s in scores)
    rows = [[json.loads(l) for l in open(tmp_path / f)] for f in ("j.jsonl", "t.jsonl")]
    assert len(jruns) == len(truns) == len(rows[1]) == 4
    parted = []
    for (jeng, jprompt, jtoks), (eng, prompt, toks), jrow, row in zip(jruns, truns, *rows):
        np.testing.assert_array_equal(prompt, jprompt)
        at = _margin_at_divergence(jeng, eng, prompt, jtoks[0], toks[0])
        if at is None:
            assert row["pred"] == jrow["pred"]
            continue
        step, margin, gap = at
        # a near tie: both the margin and the engines' gap within parity
        assert max(margin, gap) <= GREEDY_PARITY[cache], (row["dataset"], at)
        parted.append((row["dataset"], *at))
    if parted:
        warnings.warn(f"run_long_bench: greedy near-ties parted the engines at "
                      f"(dataset, step, margin, gap as shares of max|logits|) {parted}")
    else:
        assert scores == re.findall(r"^(qasper|trec): ([0-9.]+)$", want, re.M)
