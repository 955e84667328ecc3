"""Zero-shot multiple-choice evaluation (port of
palu_tpu/evals/zero_shot.py).

The reference wraps lm-eval 0.4.2 (run_lm_eval.py:15-40) for the paper suite
openbookqa / hellaswag / piqa / arc_easy / arc_challenge / winogrande. This
module provides the built-in harness that implements the standard
loglikelihood protocol for those six tasks directly (length-normalized
accuracy where lm-eval uses acc_norm); `lm_eval_adapter.TorchLM` plugs the
same scorer into lm-eval when that package is installed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.quant import QuantConfig
from ..models import llama
from ..models.config import ModelConfig
from .ppl import latent_hook, params_device

__all__ = ["loglikelihood_batch", "run_zero_shot", "DEFAULT_TASKS", "make_mc_requests"]

DEFAULT_TASKS = [
    "openbookqa", "hellaswag", "piqa", "arc_easy", "arc_challenge", "winogrande",
]


# scorer cache: one entry per (cfg, qcfg). With the bucketed padding below,
# evaluating N documents feeds the scorer O(#length-buckets) shapes instead
# of one per sequence length, so a captured or compiled scorer would build
# that many times.
_LL_CACHE: Dict[tuple, tuple] = {}
# distinct (bucket_len, batch) shapes fed to the scorer, which tests assert on
_LL_SHAPES: set = set()


def _ll_fn(cfg: ModelConfig, qcfg: Optional[QuantConfig]):
    key = (id(cfg), qcfg)
    hit = _LL_CACHE.get(key)
    if hit is not None and hit[0] is cfg:  # strong ref guards id() reuse
        return hit[1]

    quantize_latent = latent_hook(qcfg)

    @torch.no_grad()
    def ll(params, ids, cont_mask):
        """ids (B, S); cont_mask (B, S) 1.0 where the token is part of the
        scored continuation. Returns (sum logprob, greedy-match) per row."""
        logits = llama.forward(params, ids, cfg, quantize_latent=quantize_latent)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        labels = ids[:, 1:]
        tok_lp = logp.gather(-1, labels[..., None])[..., 0]
        mask = cont_mask[:, 1:]
        ll_sum = (tok_lp * mask).sum(dim=-1)
        greedy = logp.argmax(dim=-1) == labels
        exact = torch.where(mask > 0, greedy, True).all(dim=-1)
        return ll_sum, exact

    _LL_CACHE[key] = (cfg, ll)
    return ll


def _bucket_len(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def loglikelihood_batch(
    params, cfg, requests: List[Tuple[List[int], List[int]]],
    qcfg: Optional[QuantConfig] = None, batch_size: int = 8,
) -> List[Tuple[float, bool]]:
    """requests: list of (context_tokens, continuation_tokens). Returns
    (loglikelihood, is_greedy) per request (lm-eval's loglikelihood API).

    Requests are right-padded to power-of-two length buckets and stacked
    into fixed-size batches, so the scorer sees O(#buckets) distinct shapes
    across an entire task (padding is causally invisible and masked out of
    the score). Runs on the params' device.
    """
    ll = _ll_fn(cfg, qcfg)
    dev = params_device(params)
    out: List[Optional[Tuple[float, bool]]] = [None] * len(requests)

    # group request indices by bucketed length
    buckets: Dict[int, List[int]] = {}
    for i, (ctx, cont) in enumerate(requests):
        buckets.setdefault(_bucket_len(len(ctx) + len(cont)), []).append(i)

    for blen, idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), batch_size):
            group = idxs[start : start + batch_size]
            ids = np.zeros((batch_size, blen), np.int64)
            mask = np.zeros((batch_size, blen), np.float32)
            for row, i in enumerate(group):
                ctx, cont = requests[i]
                seq = (ctx + cont)[-blen:]
                ids[row, : len(seq)] = seq
                mask[row, len(seq) - len(cont) : len(seq)] = 1.0
            _LL_SHAPES.add((blen, batch_size))
            s, e = ll(params, torch.as_tensor(ids, device=dev),
                      torch.as_tensor(mask, device=dev))
            s, e = s.cpu().numpy(), e.cpu().numpy()
            for row, i in enumerate(group):
                out[i] = (float(s[row]), bool(e[row]))
    return out  # type: ignore[return-value]


def make_mc_requests(task: str, doc: dict, tokenizer):
    """Build (context, choices, gold, context_varies) for one document of a
    supported task, following the lm-eval task formats."""
    if task == "openbookqa":
        ctx = doc["question_stem"]
        choices = doc["choices"]["text"]
        gold = doc["choices"]["label"].index(doc["answerKey"])
    elif task in ("arc_easy", "arc_challenge"):
        ctx = "Question: " + doc["question"] + "\nAnswer:"
        choices = [" " + t for t in doc["choices"]["text"]]
        gold = doc["choices"]["label"].index(doc["answerKey"])
    elif task == "piqa":
        ctx = "Question: " + doc["goal"] + "\nAnswer:"
        choices = [" " + doc["sol1"], " " + doc["sol2"]]
        gold = int(doc["label"])
    elif task == "hellaswag":
        ctx = doc["ctx"]
        choices = [" " + e for e in doc["endings"]]
        gold = int(doc["label"])
    elif task == "winogrande":
        # sentence with blank: context is sentence up to _, choices fill it
        idx = doc["sentence"].index("_")
        opts = [doc["option1"], doc["option2"]]
        ctx_parts = [doc["sentence"][:idx] + o for o in opts]
        cont = doc["sentence"][idx + 1 :]
        gold = int(doc["answer"]) - 1
        return ctx_parts, [cont, cont], gold, True
    else:
        raise NotImplementedError(task)
    return ctx, choices, gold, False


def _ids(tokenizer, text: str) -> List[int]:
    return tokenizer(text, return_tensors="np")["input_ids"][0].tolist()


def run_zero_shot(
    params,
    cfg: ModelConfig,
    tokenizer,
    tasks: Optional[List[str]] = None,
    qcfg: Optional[QuantConfig] = None,
    max_samples: Optional[int] = None,
    data_loader=None,
) -> Dict[str, Dict[str, float]]:
    """Zero-shot accuracy per task. If the lm-eval package is available it
    is preferred (exact protocol, reference run_lm_eval.py:15-40); otherwise
    the built-in harness (length-normalized + raw accuracy) runs.
    `data_loader` forces the built-in path (offline fixtures)."""
    tasks = tasks or DEFAULT_TASKS
    if data_loader is None:
        from . import lm_eval_adapter

        if lm_eval_adapter._HAVE_LM_EVAL:
            res = lm_eval_adapter.simple_evaluate(
                params, cfg, tokenizer, tasks, qcfg=qcfg,
                **({"limit": max_samples} if max_samples else {}),
            )
            out: Dict[str, Dict[str, float]] = {}
            for task, metrics in res.get("results", {}).items():
                out[task] = {
                    "acc": float(metrics.get("acc,none", metrics.get("acc", 0.0))),
                    "acc_norm": float(
                        metrics.get("acc_norm,none", metrics.get("acc_norm", 0.0))
                    ),
                }
            return out
    results: Dict[str, Dict[str, float]] = {}
    for task in tasks:
        if data_loader is not None:
            docs = list(data_loader(task))
        else:
            docs = _load_task_docs(task)
        if max_samples:
            docs = docs[:max_samples]
        n_correct = 0
        n_correct_norm = 0
        for doc in docs:
            ctx, choices, gold, ctx_varies = make_mc_requests(task, doc, tokenizer)
            # each choice's ids drop their first token (the tokenizer's BOS),
            # as the JAX harness does (palu_tpu/evals/zero_shot.py:196-207)
            if ctx_varies:
                reqs = [(_ids(tokenizer, c), _ids(tokenizer, ch)[1:])
                        for c, ch in zip(ctx, choices)]
            else:
                ctx_ids = _ids(tokenizer, ctx)
                reqs = [(ctx_ids, _ids(tokenizer, ch)[1:]) for ch in choices]
            lls = loglikelihood_batch(params, cfg, reqs, qcfg)
            scores = [s for s, _ in lls]
            norm_scores = [s / max(1, len(r[1])) for (s, _), r in zip(lls, reqs)]
            n_correct += int(int(np.argmax(scores)) == gold)
            n_correct_norm += int(int(np.argmax(norm_scores)) == gold)
        n = max(1, len(docs))
        results[task] = {"acc": n_correct / n, "acc_norm": n_correct_norm / n}
    return results


def _load_task_docs(task: str):
    from datasets import load_dataset

    specs = {
        "openbookqa": ("allenai/openbookqa", "main", "test"),
        "hellaswag": ("Rowan/hellaswag", None, "validation"),
        "piqa": ("ybisk/piqa", None, "validation"),
        "arc_easy": ("allenai/ai2_arc", "ARC-Easy", "test"),
        "arc_challenge": ("allenai/ai2_arc", "ARC-Challenge", "test"),
        "winogrande": ("allenai/winogrande", "winogrande_xl", "validation"),
    }
    path, name, split = specs[task]
    ds = load_dataset(path, name, split=split) if name else load_dataset(path, split=split)
    return list(ds)
