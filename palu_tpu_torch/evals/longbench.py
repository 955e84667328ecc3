"""LongBench end-to-end generation eval (a copy of
palu_tpu/evals/longbench.py over the port's Engine; the reference's
run_long_bench.py, adapted from THUDM/LongBench pred.py).

Protocol parity: per-dataset prompt templates, MIDDLE truncation of the
prompt to the model's max length (run_long_bench.py:54-56), greedy decoding
to the dataset's max_gen length, per-dataset metric scoring, JSONL results.

Prompt templates and generation lengths are LongBench's published eval
configs (THUDM/LongBench, as used by the reference's
longbench_utils/config/*.json). The default suite matches the reference's
(run_long_bench.py:173): triviaqa, qasper, trec, samsum, lcc, repobench-p,
qmsum, multi_news.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np

from .scorer import scorer

__all__ = ["DATASET2PROMPT", "DATASET2MAXLEN", "DEFAULT_DATASETS", "run_longbench",
           "build_prompt", "build_chat", "post_process", "truncate_middle"]

DEFAULT_DATASETS = [
    "triviaqa", "qasper", "trec", "samsum", "lcc", "repobench-p", "qmsum",
    "multi_news",
]

DATASET2PROMPT = {
    "triviaqa": "Answer the question based on the given passage. Only give me the answer and do not output any other words. The following are some examples.\n\n{context}\n\n{input}",
    "qasper": 'You are given a scientific article and a question. Answer the question as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write "unanswerable". If the question is a yes/no question, answer "yes", "no", or "unanswerable". Do not provide any explanation.\n\nArticle: {context}\n\n Answer the question based on the above article as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write "unanswerable". If the question is a yes/no question, answer "yes", "no", or "unanswerable". Do not provide any explanation.\n\nQuestion: {input}\n\nAnswer:',
    "trec": "Please determine the type of the question below. Here are some examples of questions.\n\n{context}\n{input}",
    "samsum": "Summarize the dialogue into a few short sentences. The following are some examples.\n\n{context}\n\n{input}",
    "lcc": "Please complete the code given below. \n{context}Next line of code:\n",
    "repobench-p": "Please complete the code given below. \n{context}{input}Next line of code:\n",
    "qmsum": "You are given a meeting transcript and a query containing a question or instruction. Answer the query in one or more sentences.\n\nTranscript:\n{context}\n\nNow, answer the query based on the above meeting transcript in one or more sentences.\n\nQuery: {input}\nAnswer:",
    "multi_news": "You are given several news passages. Write a one-page summary of all news. \n\nNews:\n{context}\n\nNow, write a one-page summary of all the news.\n\nSummary:",
}

DATASET2MAXLEN = {
    "narrativeqa": 128, "qasper": 128, "multifieldqa_en": 64,
    "multifieldqa_zh": 64, "hotpotqa": 32, "2wikimqa": 32, "musique": 32,
    "dureader": 128, "gov_report": 512, "qmsum": 512, "multi_news": 512,
    "vcsum": 512, "trec": 64, "triviaqa": 32, "samsum": 128, "lsht": 64,
    "passage_count": 32, "passage_retrieval_en": 32,
    "passage_retrieval_zh": 32, "lcc": 64, "repobench-p": 64,
}

# datasets where the prompt is NOT wrapped in a chat template (fewshot /
# code completion; run_long_bench.py:32)
NO_CHAT_TEMPLATE = {"trec", "triviaqa", "samsum", "lsht", "lcc", "repobench-p"}


def truncate_middle(tokens: np.ndarray, max_len: int) -> np.ndarray:
    """Middle truncation: keep the first and last half (run_long_bench.py:54-56)."""
    n = tokens.shape[-1]
    if n <= max_len:
        return tokens
    half = max_len // 2
    return np.concatenate([tokens[..., :half], tokens[..., n - half :]], axis=-1)


def build_chat(tokenizer, prompt: str, model_name: str) -> str:
    """Per-model-family chat formatting (reference run_long_bench.py:29-45,
    itself adapted from KIVI/LongBench pred.py). Families without a custom
    template fall through to tokenizer.apply_chat_template when available."""
    name = (model_name or "").lower()
    if "longchat" in name or "vicuna" in name:
        # fastchat vicuna_v1.1 conversation template, inlined (the reference
        # imports fastchat.get_conversation_template)
        system = (
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        )
        return f"{system} USER: {prompt} ASSISTANT:"
    if "llama2" in name or "llama-2" in name:
        return f"[INST]{prompt}[/INST]"
    if "xgen" in name:
        header = (
            "A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions.\n\n"
        )
        return header + f" ### Human: {prompt}\n###"
    if "internlm" in name:
        return f"<|User|>:{prompt}<eoh>\n<|Bot|>:"
    if hasattr(tokenizer, "apply_chat_template") and getattr(
        tokenizer, "chat_template", None
    ):
        return tokenizer.apply_chat_template(
            [{"role": "user", "content": prompt}],
            tokenize=False,
            add_generation_prompt=True,
        )
    return prompt


def post_process(response: str, model_name: str) -> str:
    """Family-specific response cleanup (reference run_long_bench.py:19-26)."""
    name = (model_name or "").lower()
    if "xgen" in name:
        return response.strip().replace("Assistant:", "")
    if "internlm" in name:
        return response.split("<eoa>")[0]
    return response


def build_prompt(dataset: str, sample: dict, tokenizer, max_len: int,
                 chat_template: bool = False, model_name: str = "") -> np.ndarray:
    """Format + tokenize + middle-truncate one LongBench sample -> (1, S)."""
    prompt = DATASET2PROMPT[dataset].format(**sample)
    ids = np.asarray(tokenizer(prompt, return_tensors="np")["input_ids"])
    ids = truncate_middle(ids, max_len)
    if chat_template and dataset not in NO_CHAT_TEMPLATE:
        text = tokenizer.decode(ids[0], skip_special_tokens=True)
        chat = build_chat(tokenizer, text, model_name)
        ids = np.asarray(tokenizer(chat, return_tensors="np")["input_ids"])
    return ids


def run_longbench(
    engine,
    tokenizer,
    datasets: Optional[List[str]] = None,
    max_prompt_len: int = 3500,
    out_path: Optional[str] = None,
    max_samples: Optional[int] = None,
    chat_template: bool = False,
    model_name: str = "",
    data_loader=None,
) -> Dict[str, float]:
    """Run the LongBench suite with the latent-cache engine
    (runtime.engine.Engine: prompts as numpy ids, greedy generate).

    data_loader: optional fn(dataset_name) -> iterable of samples with keys
    context/input/answers/all_classes (for offline fixtures); defaults to
    `load_dataset('THUDM/LongBench', name, split='test')`.
    """
    datasets = datasets or DEFAULT_DATASETS
    results: Dict[str, float] = {}
    for name in datasets:
        if data_loader is not None:
            data = list(data_loader(name))
        else:
            from datasets import load_dataset

            data = list(load_dataset("THUDM/LongBench", name, split="test"))
        if max_samples:
            data = data[:max_samples]
        preds, answers, classes = [], [], None
        for sample in data:
            ids = build_prompt(name, sample, tokenizer, max_prompt_len,
                               chat_template, model_name)
            max_gen = DATASET2MAXLEN.get(name, 64)
            toks = engine.generate(
                ids, max_new_tokens=max_gen,
                eos_token_id=getattr(tokenizer, "eos_token_id", None),
            )
            pred = post_process(
                tokenizer.decode(toks[0], skip_special_tokens=True), model_name
            )
            preds.append(pred)
            answers.append(sample["answers"])
            classes = sample.get("all_classes")
            if out_path:
                with open(out_path, "a") as f:
                    f.write(json.dumps({
                        "dataset": name, "pred": pred,
                        "answers": sample["answers"],
                        "time": time.time(),
                    }) + "\n")
        results[name] = scorer(name, preds, answers, classes)
    return results
