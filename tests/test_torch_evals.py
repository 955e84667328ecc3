"""The port's accuracy track (palu_tpu_torch.evals, the forward's latent
fake-quant hook, QuantConfig.hadamard) against the JAX package on the CPU,
in f32, on tiny models from a numpy seed carried across with
params_from_numpy: the hooked forward at rtol 1e-5 of max|logits|,
quantize_latent_grouped bit-exact on identical latents, eval_ppl_on_tokens
within 1e-5 relative, loglikelihood_batch within 1e-4 per request with equal
greedy flags, run_zero_shot's and run_longbench's results equal, the metrics
and scorers identical, and the lm-eval adapter's contract (a stubbed
lm_eval) through all three entry points."""

import abc
import ast
import dataclasses
import importlib
import sys
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palu_tpu.core import quant as jquant
from palu_tpu.evals import longbench as jlongbench
from palu_tpu.evals import metrics as jmetrics
from palu_tpu.evals import ppl as jppl
from palu_tpu.evals import zero_shot as jzs
from palu_tpu.models import llama as jllama
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from chip_smoke import zero_shot_docs as _fixture_docs
from palu_tpu_torch import evals
from palu_tpu_torch.convert import config_from_dict, params_from_numpy, quant_config_from_dict
from palu_tpu_torch.core import quant as tquant
from palu_tpu_torch.evals import longbench, metrics, ppl, zero_shot
from palu_tpu_torch.models import llama as tllama
from palu_tpu_torch.runtime.engine import Engine, EngineConfig

# the packages export a function `scorer` that hides the module's name
jscorer = importlib.import_module("palu_tpu.evals.scorer")
scorer = importlib.import_module("palu_tpu_torch.evals.scorer")

ROOT = Path(__file__).resolve().parent.parent
VOCAB = 64
RK, RV = 16, 24  # uniform group ranks; the ragged model keeps (8, 16) / (16, 24)
RAGGED = {"k_proj": (8, 16), "v_proj": (16, 24)}


# ---------------------------------------------------------------------------
# QuantConfig.hadamard and convert.quant_config_from_dict
# ---------------------------------------------------------------------------


def _literal_kwargs(call: ast.Call):
    try:
        return {k.arg: ast.literal_eval(k.value) for k in call.keywords}
    except ValueError:
        return None


def _test_quant_configs():
    """Every QuantConfig the tests build from literal keywords: calls to a
    name ending in QuantConfig, and dict(bits=...) literals they unpack."""
    found = set()
    for path in sorted((ROOT / "tests").glob("test_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and node.keywords) or any(
                    k.arg is None for k in node.keywords):
                continue
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            kw = _literal_kwargs(node)
            if kw and (name.endswith("QuantConfig") or (name == "dict" and "bits" in kw)):
                found.add(tuple(sorted(kw.items())))
    return [dict(k) for k in sorted(found)]


def test_quant_config_fields_in_jax_order():
    names = [f.name for f in dataclasses.fields(tquant.QuantConfig)]
    assert names == [f.name for f in dataclasses.fields(jquant.QuantConfig)]
    assert names.index("hadamard") == names.index("clip_ratio") + 1
    assert tquant.QuantConfig().hadamard is False


def test_every_test_quant_config_converts():
    """dataclasses.asdict of every JAX QuantConfig the tests build converts
    into the port's and compares equal field by field."""
    configs = _test_quant_configs()
    assert len(configs) >= 10, configs
    for kw in configs:
        try:
            jq = jquant.QuantConfig(**kw)
        except (TypeError, ValueError):  # a test's refused config
            continue
        got = quant_config_from_dict(dataclasses.asdict(jq))
        assert isinstance(got, tquant.QuantConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(jq), kw
        assert (got.enabled, got.pack_bits) == (jq.enabled, jq.pack_bits)


@pytest.mark.parametrize("kw", [
    dict(), dict(bits=3, sym=True, container=4), dict(bits=3, sym=True, hadamard=True),
    dict(bits=4, group_size=8, clip_ratio=0.9, hadamard=True), dict(bits=2, container=8),
], ids=["default", "flagship", "hadamard", "chunked_clip", "container8"])
def test_quant_config_from_dict_round_trips(kw):
    jq = jquant.QuantConfig(**kw)
    got = quant_config_from_dict(dataclasses.asdict(jq))
    assert dataclasses.asdict(got) == dataclasses.asdict(jq)
    assert got == tquant.QuantConfig(**kw)


# ---------------------------------------------------------------------------
# tiny models
# ---------------------------------------------------------------------------


def jax_config(layers=2):
    ranks = {}
    for i in range(layers):
        ranks[f"model.layers.{i}.self_attn.k_proj"] = [RK, RK]
        ranks[f"model.layers.{i}.self_attn.v_proj"] = [RV, RV]
    return JModelConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                        num_hidden_layers=layers, num_attention_heads=4,
                        num_key_value_heads=4, head_group_size=2, head_wise_ranks=ranks,
                        max_position_embeddings=256)


def _raggedize(np_params):
    """Cut each low-rank side's group g to RAGGED[side][g] ranks: VT (in,
    sum r_g), U a tuple of (r_g, d); the fused o_proj is then unused."""
    layers = []
    for layer in np_params["layers"]:
        attn = dict(layer["attn"])
        for which, ranks in RAGGED.items():
            p = attn[which]
            full = p["U"].shape[1]
            cols = np.concatenate([np.arange(g * full, g * full + r)
                                   for g, r in enumerate(ranks)])
            attn[which] = {"VT": p["VT"][:, cols],
                           "U": tuple(p["U"][g, :r] for g, r in enumerate(ranks))}
        layers.append({**layer, "attn": attn})
    return {**np_params, "layers": layers}


def model(ragged=False, seed=0):
    """(JAX params, JAX cfg, port params on the CPU, port cfg), f32."""
    jcfg = jax_config()
    np_params = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.key(seed), dtype=jnp.float32, scale=0.1))
    if ragged:
        np_params = _raggedize(np_params)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return (jparams, jcfg, params_from_numpy(np_params, device="cpu"),
            config_from_dict(dataclasses.asdict(jcfg)))


# ---------------------------------------------------------------------------
# the hooked forward
# ---------------------------------------------------------------------------

QKWS = [dict(bits=b, sym=s, group_size=gs) for b in (2, 3, 4) for s in (True, False)
        for gs in (0, 8)]
QIDS = [f"{q['bits']}bit_{'sym' if q['sym'] else 'asym'}_gs{q['group_size']}" for q in QKWS]


def _recording_hooks(qkw):
    """(JAX hook, port hook, records): each hook fake-quantizes in its own
    package and appends (latents in, latents out) as numpy."""
    jq, tq = jquant.QuantConfig(**qkw), tquant.QuantConfig(**qkw)
    rec = {"jax": [], "torch": []}

    def jhook(lat):
        out = jquant.fake_quantize(lat, jq)
        rec["jax"].append((np.asarray(lat), np.asarray(out)))
        return out

    def thook(lat):
        out = tquant.fake_quantize(lat, tq)
        rec["torch"].append((lat.numpy().copy(), out.numpy().copy()))
        return out

    return jhook, thook, rec


def _replay_hook(qkw, jax_calls):
    """A port hook that fake-quantizes, with the port's fake_quantize, the
    latents JAX's hook was given at the same call (and checks that its own
    latents agree with them at the f32 class): the rest of the forward is
    then held on identical quantization decisions."""
    tq = tquant.QuantConfig(**qkw)
    calls = iter(jax_calls)

    def hook(lat):
        jin, jout = next(calls)
        assert np.abs(lat.numpy() - jin).max() <= 1e-5 * np.abs(jin).max()
        out = tquant.fake_quantize(torch.as_tensor(jin), tq)
        np.testing.assert_array_equal(out.numpy(), jout)  # bit-exact on identical latents
        return out

    return hook


def _first_flip(rec, qkw):
    """The first hook call at which the two packages' fake-quantized latents
    part, with the element that moved most; it must be a code on a rounding
    edge: the latents given agree at the f32 class and the port's
    fake_quantize of JAX's latents gives JAX's bits. None when none part."""
    tq = tquant.QuantConfig(**qkw)
    for i, ((jin, jout), (tin, tout)) in enumerate(zip(rec["jax"], rec["torch"])):
        moved = np.abs(tout - jout)
        # f32 noise in the latents moves a fake-quantized value by ~1e-7 of
        # max|latent|; another code moves it by a whole step (>= 1/127 of it)
        if moved.max() <= 1e-3 * np.abs(jout).max():
            continue
        idx = np.unravel_index(int(np.argmax(moved)), jout.shape)
        where = (f"hook call {i} (in forward order), element {tuple(map(int, idx))}: latent "
                 f"{jin[idx]!r} (JAX) / {tin[idx]!r} (port), fake-quantized {jout[idx]!r} / "
                 f"{tout[idx]!r}")
        assert np.abs(tin - jin).max() <= 1e-5 * np.abs(jin).max(), where
        np.testing.assert_array_equal(
            tquant.fake_quantize(torch.as_tensor(jin), tq).numpy(), jout, err_msg=where)
        return where
    return None


@pytest.mark.parametrize("value_mode", ["reconstruct", "fused"])
@pytest.mark.parametrize("qkw", QKWS, ids=QIDS)
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_hooked_forward_matches_jax(ragged, qkw, value_mode):
    """The port's hooked forward against JAX's at 1e-5 of max|logits|.

    XLA and PyTorch sum x @ VT in different orders, so a latent on a code's
    rounding edge can take the neighbouring code in one package
    (ROADMAP.md, section C item 5). The forward is therefore held twice at
    the same tolerance: with a hook that replays JAX's latents through the
    port's fake_quantize (identical decisions; always held), and with the
    port's own hook, which is held unless the first place the two parted is
    such a flip; then the flip is named in a warning, never hidden."""
    jparams, jcfg, tparams, tcfg = model(ragged, seed=1)
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 24))
    tids = torch.as_tensor(ids)
    jhook, thook, rec = _recording_hooks(qkw)
    want = np.asarray(jllama.forward(jparams, jnp.asarray(ids), jcfg, jhook, value_mode))
    got = tllama.forward(tparams, tids, tcfg, thook, value_mode).numpy()
    # the hook runs on both low-rank sides of each layer, once per group
    # slice when ranks are ragged: 2 layers x 2 sides (x 2 groups)
    assert len(rec["torch"]) == len(rec["jax"]) == (8 if ragged else 4)
    assert [a.shape for a, _ in rec["torch"]] == [a.shape for a, _ in rec["jax"]]
    plain = tllama.forward(tparams, tids, tcfg, value_mode=value_mode).numpy()
    assert np.abs(got - plain).max() > 1e-3 * np.abs(plain).max()  # the hook acts
    tol = 1e-5 * np.abs(want).max()
    replayed = tllama.forward(tparams, tids, tcfg, _replay_hook(qkw, rec["jax"]),
                              value_mode).numpy()
    assert np.abs(replayed - want).max() <= tol
    err = np.abs(got - want).max()
    flip = _first_flip(rec, qkw)
    if err > tol:
        assert flip is not None, err
        warnings.warn(f"hooked forward: a code on a rounding edge moved the logits by "
                      f"{err:.3g} (tol {tol:.3g}) at {flip}")


def test_hook_skips_dense_sides():
    """A dense k/v projection is not fake-quantized: only low-rank sides
    reach the hook."""
    jparams, jcfg, tparams, tcfg = model()
    layer = dict(tparams["layers"][0])
    attn = dict(layer["attn"])
    vt, u = attn["k_proj"]["VT"], attn["k_proj"]["U"]
    attn["k_proj"] = {"w": torch.einsum("igr,grd->igd", vt.reshape(64, 2, RK), u).reshape(64, -1)}
    tparams = {**tparams, "layers": [{**layer, "attn": attn}, *tparams["layers"][1:]]}
    calls = []
    tllama.forward(tparams, torch.zeros((1, 8), dtype=torch.long), tcfg,
                   lambda lat: calls.append(lat.shape) or lat)
    assert len(calls) == 3  # layer 0's V, layer 1's K and V


@pytest.mark.parametrize("qkw", QKWS, ids=QIDS)
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_quantize_latent_grouped_bit_exact(ragged, qkw):
    """The same latents through both packages' quantize_latent_grouped give
    identical bits: per group slice for ragged ranks, whole for uniform."""
    rng = np.random.default_rng(3)
    if ragged:
        proj_j = {"VT": None, "U": tuple(np.zeros((r, 8), np.float32) for r in (8, 24))}
        lat = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    else:
        proj_j = {"VT": None, "U": np.zeros((2, 16, 8), np.float32)}
        lat = rng.standard_normal((2, 5, 2, 16)).astype(np.float32) * 3
    proj_t = {"VT": None, "U": tuple(torch.as_tensor(u) for u in proj_j["U"])
              if ragged else torch.as_tensor(proj_j["U"])}
    jq, tq = jquant.QuantConfig(**qkw), tquant.QuantConfig(**qkw)
    want = np.asarray(jllama.quantize_latent_grouped(
        jnp.asarray(lat), proj_j, lambda x: jquant.fake_quantize(x, jq)))
    got = tllama.quantize_latent_grouped(torch.as_tensor(lat), proj_t,
                                         lambda x: tquant.fake_quantize(x, tq)).numpy()
    np.testing.assert_array_equal(got, want)
    if ragged and not qkw["group_size"]:  # per group: each slice keeps its own scale
        whole = tquant.fake_quantize(torch.as_tensor(lat), tq).numpy()
        assert not np.array_equal(got, whole)


# ---------------------------------------------------------------------------
# perplexity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qkw", [None, dict(bits=3, sym=True), dict(bits=4, group_size=8)],
                         ids=["fp", "3bit_sym", "4bit_asym_gs8"])
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_eval_ppl_on_tokens_matches_jax(ragged, qkw):
    jparams, jcfg, tparams, tcfg = model(ragged, seed=4)
    tokens = np.random.default_rng(5).integers(0, VOCAB, (1, 3 * 32 + 7))
    jq = qkw and jquant.QuantConfig(**qkw)
    tq = qkw and tquant.QuantConfig(**qkw)
    want = jppl.eval_ppl_on_tokens(jparams, jcfg, tokens, seqlen=32, qcfg=jq,
                                   batch_size=2, progress=False)
    got = ppl.eval_ppl_on_tokens(tparams, tcfg, tokens, seqlen=32, qcfg=tq, batch_size=2,
                                 progress=False)
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) <= 1e-5 * want, (got, want)


def test_window_nll_keeps_the_reference_scaling():
    """Each window's NLL is the mean over seqlen - 1 positions times seqlen
    (the reference's quirk), from the port's own forward."""
    _, _, tparams, tcfg = model(seed=6)
    ids = torch.as_tensor(np.random.default_rng(7).integers(0, VOCAB, (2, 16)))
    got = ppl.window_nlls(tparams, tcfg, ids, 16)
    logp = torch.log_softmax(tllama.forward(tparams, ids, tcfg)[:, :-1], -1)
    nll = -logp.gather(-1, ids[:, 1:, None])[..., 0]
    torch.testing.assert_close(got, nll.sum(1) / 15 * 16, rtol=1e-6, atol=0)
    assert ppl.latent_hook(None) is None
    assert ppl.latent_hook(tquant.QuantConfig(bits=16)) is None


def test_get_ppl_test_tokens_local_text(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("some local text for the offline path")
    tok = _Tok()
    got = ppl.get_ppl_test_tokens("wikitext2", tok, 32, str(path))
    want = jppl.get_ppl_test_tokens("wikitext2", tok, 32, str(path))
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == 1 and got.shape[1] > 10


# ---------------------------------------------------------------------------
# zero-shot
# ---------------------------------------------------------------------------


class _Tok:
    """Character tokenizer with a BOS: ids = [1] + (ord(c) % 60) + 3, the
    HF surface the harnesses touch (chip_smoke.ByteTokenizer's ids run to
    258, past the tiny models' vocabulary of 64)."""

    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, text, return_tensors=None, add_special_tokens=True):
        ids = ([self.bos_token_id] if add_special_tokens else []) + [
            (ord(c) % 60) + 3 for c in text[:200]]
        if return_tensors == "np":
            return {"input_ids": np.asarray([ids], np.int64)}
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


def _requests(seed, lengths, cont=1):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(2, VOCAB, n)],
             [int(t) for t in rng.integers(2, VOCAB, cont)]) for n in lengths]


@pytest.mark.parametrize("qkw", [None, dict(bits=3, sym=True)], ids=["fp", "3bit_sym"])
def test_loglikelihood_batch_matches_jax(qkw):
    """37 distinct lengths: the scores within 1e-4 of JAX's, the greedy
    flags equal, the bucketed shapes at most 2 (test_evals.py's count), one
    scorer per (cfg, qcfg)."""
    jparams, jcfg, tparams, tcfg = model(seed=8)
    reqs = _requests(9, range(3, 40))
    jq = qkw and jquant.QuantConfig(**qkw)
    tq = qkw and tquant.QuantConfig(**qkw)
    want = jzs.loglikelihood_batch(jparams, jcfg, reqs, jq)
    before = set(zero_shot._LL_SHAPES)
    got = zero_shot.loglikelihood_batch(tparams, tcfg, reqs, tq)
    new_shapes = set(zero_shot._LL_SHAPES) - before
    assert len(new_shapes) <= 2, new_shapes
    assert len(got) == len(reqs)
    for (s1, e1), (s2, e2) in zip(got, want):
        assert isinstance(s1, float) and isinstance(e1, bool)
        assert abs(s1 - s2) <= 1e-4, (s1, s2)
        assert e1 == e2
    assert zero_shot._ll_fn(tcfg, tq) is zero_shot._ll_fn(tcfg, tq)


def test_loglikelihood_batch_bucketed_matches_unpadded():
    """Padding to a bucket and batching moves no score past 1e-4 of the
    request scored alone at its own length (test_evals.py:226's bound)."""
    _, _, tparams, tcfg = model(seed=10)
    reqs = _requests(11, (5, 9, 17, 33), cont=3)
    batched = zero_shot.loglikelihood_batch(tparams, tcfg, reqs, batch_size=8)
    ll = zero_shot._ll_fn(tcfg, None)
    for (ctx, cont), (s, e) in zip(reqs, batched):
        ids = torch.as_tensor([ctx + cont])
        mask = torch.zeros(ids.shape)
        mask[0, len(ctx):] = 1.0
        s1, e1 = ll(tparams, ids, mask)
        assert abs(s - float(s1[0])) <= 1e-4 and e == bool(e1[0])


@pytest.mark.parametrize("qkw", [None, dict(bits=3, sym=True)], ids=["fp", "3bit_sym"])
def test_run_zero_shot_matches_jax(qkw):
    jparams, jcfg, tparams, tcfg = model(seed=12)
    tok = _Tok()
    jq = qkw and jquant.QuantConfig(**qkw)
    tq = qkw and tquant.QuantConfig(**qkw)
    want = jzs.run_zero_shot(jparams, jcfg, tok, qcfg=jq, data_loader=_fixture_docs)
    got = zero_shot.run_zero_shot(tparams, tcfg, tok, qcfg=tq, data_loader=_fixture_docs)
    assert list(got) == zero_shot.DEFAULT_TASKS == jzs.DEFAULT_TASKS
    assert got == want
    for task in zero_shot.DEFAULT_TASKS:
        for doc in _fixture_docs(task):
            assert zero_shot.make_mc_requests(task, doc, tok) == jzs.make_mc_requests(
                task, doc, tok)


def test_run_zero_shot_max_samples_and_errors():
    _, _, tparams, tcfg = model(seed=13)
    res = zero_shot.run_zero_shot(tparams, tcfg, _Tok(), tasks=["piqa"], max_samples=1,
                                  data_loader=_fixture_docs)
    assert set(res) == {"piqa"} and res["piqa"]["acc"] in (0.0, 1.0)
    with pytest.raises(NotImplementedError):
        zero_shot.make_mc_requests("boolq", {}, _Tok())


# ---------------------------------------------------------------------------
# LongBench
# ---------------------------------------------------------------------------


def _longbench_loader(name):
    rng = np.random.default_rng(len(name))
    words = ["alpha", "beta", "gamma", "delta", "omega", "kappa"]
    return [{"context": " ".join(rng.choice(words, 20)), "input": f"question {i}?",
             "answers": [f"{3 + i} {4 + i}", "alpha"], "all_classes": ["alpha", "beta"],
             "length": 100 + i} for i in range(2)]


@pytest.mark.parametrize("qkw", [None, dict(bits=3, sym=True, container=4)],
                         ids=["bf16_cache", "3bit_cache"])
def test_run_longbench_matches_jax(qkw, tmp_path):
    """Both engines (f32, the JAX one on its XLA paths) give equal
    predictions and scores over qasper, trec and lcc fixtures."""
    jparams, jcfg, tparams, tcfg = model(seed=14)
    tok = _Tok()
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        s_max=128, dtype=jnp.float32, decode_chunk=16, use_pallas=False,
        qcfg=qkw and jquant.QuantConfig(**qkw)))
    teng = Engine(tparams, tcfg, EngineConfig(
        s_max=128, dtype=torch.float32, decode_chunk=16, device="cpu",
        qcfg=qkw and tquant.QuantConfig(**qkw)))
    datasets = ["qasper", "trec", "lcc"]
    kw = dict(datasets=datasets, max_prompt_len=48, data_loader=_longbench_loader)
    want = jlongbench.run_longbench(jeng, tok, out_path=str(tmp_path / "j.jsonl"), **kw)
    got = longbench.run_longbench(teng, tok, out_path=str(tmp_path / "t.jsonl"), **kw)
    assert got == want and list(got) == datasets
    assert all(0.0 <= v <= 100.0 for v in got.values())
    import json

    preds = [[json.loads(l)["pred"] for l in open(tmp_path / f)] for f in ("j.jsonl", "t.jsonl")]
    assert len(preds[1]) == 6 and preds[0] == preds[1]


def test_longbench_prompt_helpers_match_jax():
    tok = _Tok()
    t = np.arange(100)[None, :]
    np.testing.assert_array_equal(longbench.truncate_middle(t, 10),
                                  jlongbench.truncate_middle(t, 10))
    assert longbench.DATASET2PROMPT == jlongbench.DATASET2PROMPT
    assert longbench.DATASET2MAXLEN == jlongbench.DATASET2MAXLEN
    assert longbench.DEFAULT_DATASETS == jlongbench.DEFAULT_DATASETS
    sample = {"context": "ctx " * 40, "input": "q?"}
    for ds in ("qasper", "trec", "qmsum"):
        for chat in (False, True):
            np.testing.assert_array_equal(
                longbench.build_prompt(ds, sample, tok, 64, chat, "llama-2-7b"),
                jlongbench.build_prompt(ds, sample, tok, 64, chat, "llama-2-7b"))
    for name in ("llama-2-7b-chat", "vicuna-13b", "xgen-7b", "internlm-7b", "plain"):
        assert longbench.build_chat(tok, "hi", name) == jlongbench.build_chat(tok, "hi", name)
    for resp, name in ((" Assistant: yes", "xgen-7b"), ("foo<eoa>bar", "internlm"),
                       ("keep", "plain")):
        assert longbench.post_process(resp, name) == jlongbench.post_process(resp, name)


# ---------------------------------------------------------------------------
# metrics and scorers
# ---------------------------------------------------------------------------

METRIC_CASES = [
    ("The answer is Paris", "Paris"), ("Paris", "Paris"), ("London", "Paris"),
    ("there are 7 passages", "7"), ("maybe 3 or 7", "7"), ("Paragraph 12", "Paragraph 12"),
    ("Paragraph 3 and Paragraph 12", "Paragraph 12"), ("段落4", "段落4"),
    ("This is about Location", "Location"), ("Location or Person", "Person"),
    ("totally unrelated", "Person"), ("the cat sat on the mat", "the cat sat on the mat"),
    ("return x + 1", "return x + 1"), ("# comment\nreturn x + 1", "return x + 1"),
    ("```\nfoo(bar)", "foo(baz)"), ("", ""), ("北京是中国的首都", "中国的首都是北京"),
    ("A, an; the!", "a an the"),
]


@pytest.mark.parametrize("dataset", sorted(jmetrics.dataset2metric))
def test_metrics_match_jax(dataset):
    assert sorted(metrics.dataset2metric) == sorted(jmetrics.dataset2metric)
    classes = ["Location", "Person", "Number"]
    for pred, gt in METRIC_CASES:
        marker = {"passage_retrieval_en": "Paragraph ", "passage_retrieval_zh": "段落"}
        if dataset in marker and marker[dataset] not in gt:
            continue  # the metric reads a paragraph number from the ground truth
        got = metrics.dataset2metric[dataset](pred, gt, all_classes=classes)
        want = jmetrics.dataset2metric[dataset](pred, gt, all_classes=classes)
        assert got == want, (dataset, pred, gt, got, want)


def test_normalizers_match_jax():
    for s in ("The, Quick! brown fox", "  a  An the ", "中文，标点。和 空格"):
        assert metrics.normalize_answer(s) == jmetrics.normalize_answer(s)
        assert metrics.normalize_zh_answer(s) == jmetrics.normalize_zh_answer(s)


SCORER_CASES = [
    ("triviaqa", ["\nParis\nextra junk", "London"], [["Paris"], ["Paris", "London"]], None),
    ("trec", ["Location\nPerson", "Number"], [["Location"], ["Person"]],
     ["Location", "Person", "Number"]),
    ("qasper", ["yes", "no", "unanswerable"], [["yes"], ["yes"], ["unanswerable"]], None),
    ("samsum", ["\nthey met at noon\nbye", "nothing"], [["they met at noon"], ["a b"]], None),
    ("lcc", ["x = 1\n# c", "// y\nz()"], [["x = 1"], ["z()"]], None),
]


@pytest.mark.parametrize("case", SCORER_CASES, ids=[c[0] for c in SCORER_CASES])
def test_scorers_match_jax(case):
    dataset, preds, answers, classes = case
    assert scorer.scorer(dataset, preds, answers, classes) == jscorer.scorer(
        dataset, preds, answers, classes)
    for lengths in ([1000] * len(preds), [9000, 5000, 100][:len(preds)]):
        assert scorer.scorer_e(dataset, preds, answers, lengths, classes) == \
            jscorer.scorer_e(dataset, preds, answers, lengths, classes)
    assert scorer.scorer("triviaqa", ["\nParis\nextra"], [["Paris"]], None) == 100.0
    buckets = scorer.scorer_e("qasper", ["yes", "no"], [["yes"], ["yes"]], [1000, 9000], None)
    assert buckets == {"0-4k": 100.0, "4-8k": 0.0, "8k+": 0.0}


def test_evals_package_exports_match_jax():
    import palu_tpu.evals as jevals

    names = {n for n in dir(jevals) if not n.startswith("_") and not isinstance(
        getattr(jevals, n), types.ModuleType)}
    for n in names:
        assert hasattr(evals, n), n
    assert evals.DEFAULT_TASKS == jevals.DEFAULT_TASKS


# ---------------------------------------------------------------------------
# the lm-eval adapter (tests/test_lm_eval_contract.py for TorchLM)
# ---------------------------------------------------------------------------


class _StubLM(abc.ABC):
    """Mirror of lm_eval.api.model.LM (0.4.x): abstract request methods plus
    the rank / world_size attributes the harness reads."""

    def __init__(self) -> None:
        self._rank = 0
        self._world_size = 1
        self.cache_hook = None

    @abc.abstractmethod
    def loglikelihood(self, requests):
        ...

    @abc.abstractmethod
    def loglikelihood_rolling(self, requests):
        ...

    @abc.abstractmethod
    def generate_until(self, requests):
        ...

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size


class _Instance:
    def __init__(self, args):
        self.args = args


class _WordTok:
    """Whitespace tokenizer exposing the HF surface the adapters touch
    (a stable hash, so both packages see the same ids)."""

    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, text, add_special_tokens=True):
        ids = [self.bos_token_id] if add_special_tokens else []
        ids += [3 + sum(map(ord, w)) % 60 for w in text.split()]
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{int(i)}" for i in np.asarray(ids).reshape(-1))


@pytest.fixture()
def adapters_with_stub(monkeypatch):
    lm_eval_mod = types.ModuleType("lm_eval")
    api_mod = types.ModuleType("lm_eval.api")
    model_mod = types.ModuleType("lm_eval.api.model")
    model_mod.LM = _StubLM
    lm_eval_mod.api = api_mod
    api_mod.model = model_mod
    calls = []

    def fake_simple_evaluate(model=None, tasks=None, **kw):
        calls.append((model, tasks, kw))
        return {"results": {t: {"acc,none": 0.25, "acc_norm,none": 0.5} for t in tasks}}

    lm_eval_mod.simple_evaluate = fake_simple_evaluate
    monkeypatch.setitem(sys.modules, "lm_eval", lm_eval_mod)
    monkeypatch.setitem(sys.modules, "lm_eval.api", api_mod)
    monkeypatch.setitem(sys.modules, "lm_eval.api.model", model_mod)
    import palu_tpu.evals.lm_eval_adapter as jadapter
    import palu_tpu_torch.evals.lm_eval_adapter as tadapter

    jadapter, tadapter = importlib.reload(jadapter), importlib.reload(tadapter)
    assert jadapter._HAVE_LM_EVAL and tadapter._HAVE_LM_EVAL
    yield jadapter, tadapter, calls
    monkeypatch.undo()
    importlib.reload(jadapter)
    importlib.reload(tadapter)


def test_torchlm_satisfies_lm_contract_and_matches_jaxlm(adapters_with_stub):
    jadapter, tadapter, _ = adapters_with_stub
    jparams, jcfg, tparams, tcfg = model(seed=15)
    tok = _WordTok()
    lm = tadapter.TorchLM(tparams, tcfg, tok, max_length=32, max_gen_toks=4)
    jlm = jadapter.JaxLM(jparams, jcfg, tok, max_length=32, max_gen_toks=4)
    assert isinstance(lm, _StubLM) and lm.rank == 0 and lm.world_size == 1

    reqs = [_Instance(("the quick brown", " fox")), _Instance(("", " hello")),
            _Instance((" ".join(["w"] * 40), " end of it"))]  # cut to max_length
    lls = lm.loglikelihood(reqs)
    assert len(lls) == 3
    for (ll, greedy), (jll, jgreedy) in zip(lls, jlm.loglikelihood(reqs)):
        assert isinstance(ll, float) and np.isfinite(ll) and ll <= 0.0
        assert isinstance(greedy, bool) and greedy == jgreedy
        assert abs(ll - jll) <= 1e-4

    rolls = lm.loglikelihood_rolling([_Instance(("a b c d",))])
    assert len(rolls) == 1 and isinstance(rolls[0], float)
    assert abs(rolls[0] - jlm.loglikelihood_rolling([_Instance(("a b c d",))])[0]) <= 1e-4

    gen = [_Instance(("a b", {"until": ["t999"], "max_gen_toks": 3}))]
    outs = lm.generate_until(gen)
    assert len(outs) == 1 and isinstance(outs[0], str) and len(outs[0].split()) == 3
    eng = lm._get_engine()
    assert eng.ecfg.s_max == 32 and eng.device == torch.device("cpu")


def test_torchlm_generate_until_matches_jaxlm_in_f32(adapters_with_stub):
    """Greedy generation with a stop string through both adapters over f32
    engines: the same text, cut at the stop string."""
    jadapter, tadapter, _ = adapters_with_stub
    jparams, jcfg, tparams, tcfg = model(seed=16)
    tok = _WordTok()
    lm = tadapter.TorchLM(tparams, tcfg, tok, max_length=64)
    jlm = jadapter.JaxLM(jparams, jcfg, tok, max_length=64)
    lm._engine = Engine(tparams, tcfg, EngineConfig(s_max=64, dtype=torch.float32,
                                                    decode_chunk=16, device="cpu"))
    jlm._engine = JEngine(jparams, jcfg, JEngineConfig(s_max=64, dtype=jnp.float32,
                                                       decode_chunk=16, use_pallas=False))
    full = lm.generate_until([_Instance(("a b c", {"until": [], "max_gen_toks": 8}))])[0]
    stop = full.split()[3]
    req = [_Instance(("a b c", {"until": [stop], "max_gen_toks": 8}))]
    got = lm.generate_until(req)
    assert got == jlm.generate_until(req)
    assert got[0] == full[:full.find(stop)] and stop not in got[0]


def test_simple_evaluate_wires_torchlm(adapters_with_stub):
    _, tadapter, calls = adapters_with_stub
    _, _, tparams, tcfg = model(seed=17)
    res = tadapter.simple_evaluate(tparams, tcfg, _WordTok(), ["arc_easy"])
    model_arg, tasks, _ = calls[-1]
    assert isinstance(model_arg, tadapter.TorchLM) and tasks == ["arc_easy"]
    assert "results" in res
    # run_zero_shot prefers lm-eval when it is installed and no loader is given
    out = zero_shot.run_zero_shot(tparams, tcfg, _WordTok(), tasks=["piqa"], max_samples=3)
    assert out == {"piqa": {"acc": 0.25, "acc_norm": 0.5}}
    assert calls[-1][2] == {"limit": 3}


def test_adapter_gates_cleanly_without_lm_eval():
    from palu_tpu_torch.evals import lm_eval_adapter

    _, _, tparams, tcfg = model(seed=18)
    lm = lm_eval_adapter.TorchLM(tparams, tcfg, _Tok())
    assert lm.max_length == 2048 and lm.max_gen_toks == 256
    if not lm_eval_adapter._HAVE_LM_EVAL:
        with pytest.raises(ImportError):
            lm_eval_adapter.simple_evaluate(tparams, tcfg, _Tok(), ["piqa"])
