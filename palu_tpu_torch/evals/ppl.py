"""Perplexity evaluation (port of palu_tpu/evals/ppl.py; the reference's
run_ppl_eval.py:11-116): non-overlapping seqlen windows over wikitext2-test
/ c4-val, manual NLL accumulation, ppl = exp(sum(nll) / (n * seqlen)).

Each window runs the accuracy-track forward (project -> fake-quant ->
reconstruct) under `torch.no_grad()` on the params' device. `datasets` is
imported only where a named dataset is read.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core import quant as quant_mod
from ..core.quant import QuantConfig
from ..models import llama
from ..models.config import ModelConfig

__all__ = ["eval_ppl", "eval_ppl_on_tokens", "get_ppl_test_tokens", "latent_hook",
           "params_device"]


def get_ppl_test_tokens(name: str, tokenizer, seqlen: int = 2048,
                        local_text_path: Optional[str] = None) -> np.ndarray:
    """Tokenized eval stream (1, N). wikitext2: test split joined with
    \\n\\n; c4: first 1100 validation docs joined with spaces, truncated to
    256*seqlen tokens (run_ppl_eval.py:40-67)."""
    if local_text_path:
        with open(local_text_path) as f:
            text = f.read()
        return np.asarray(tokenizer(text, return_tensors="np")["input_ids"])
    from datasets import load_dataset

    if "wikitext2" in name:
        data = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
        enc = tokenizer("\n\n".join(data["text"]), return_tensors="np")
        return np.asarray(enc["input_ids"])
    if "c4" in name:
        data = load_dataset(
            "allenai/c4",
            data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
            revision="607bd4c8450a42878aa9ddc051a65a055450ef87",
            split="validation",
        )
        enc = tokenizer(" ".join(data[:1100]["text"]), return_tensors="np")
        return np.asarray(enc["input_ids"])[:, : 256 * seqlen]
    raise NotImplementedError(name)


def latent_hook(qcfg: Optional[QuantConfig]):
    """The forward's `quantize_latent` for qcfg: fake-quant of the latents,
    or None when qcfg quantizes nothing."""
    if qcfg is None or not qcfg.enabled:
        return None
    return lambda lat: quant_mod.fake_quantize(lat, qcfg)


def params_device(params) -> torch.device:
    """The device the params (and so the forward) live on."""
    return params["embed"].device


@torch.no_grad()
def window_nlls(params, cfg: ModelConfig, batch: torch.Tensor, seqlen: int,
                quantize_latent=None) -> torch.Tensor:
    """Per-window NLL (B,) of token windows (B, seqlen). The reference takes
    the mean NLL over the seqlen - 1 predicted positions and multiplies it
    by seqlen (palu_tpu/evals/ppl.py:70-71); so does this."""
    logits = llama.forward(params, batch, cfg, quantize_latent=quantize_latent)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, batch[:, 1:, None])
    return nll.mean(dim=(1, 2)) * seqlen


def eval_ppl_on_tokens(
    params,
    cfg: ModelConfig,
    tokens: np.ndarray,  # (1, N)
    seqlen: int = 2048,
    qcfg: Optional[QuantConfig] = None,
    batch_size: int = 1,
    progress: bool = True,
) -> float:
    """Windowed ppl on a token stream with the accuracy-track forward
    (project -> fake-quant -> reconstruct, run_ppl_eval.py:95-112)."""
    quantize_latent = latent_hook(qcfg)
    dev = params_device(params)
    tokens = np.asarray(tokens).reshape(1, -1)
    nsamples = tokens.shape[1] // seqlen
    nlls = []
    it = range(0, nsamples, batch_size)
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(list(it))
        except ImportError:
            pass
    for i in it:
        nb = min(batch_size, nsamples - i)
        batch = np.stack(
            [tokens[0, (i + j) * seqlen : (i + j + 1) * seqlen] for j in range(nb)]
        )
        ids = torch.as_tensor(batch, dtype=torch.long, device=dev)
        nlls.extend(window_nlls(params, cfg, ids, seqlen, quantize_latent).cpu().tolist())
    return float(np.exp(np.sum(nlls) / (len(nlls) * seqlen)))


def eval_ppl(
    params,
    cfg: ModelConfig,
    tokenizer,
    datasets: str = "wikitext2",
    seqlen: int = 2048,
    qcfg: Optional[QuantConfig] = None,
    local_text_path: Optional[str] = None,
) -> Dict[str, float]:
    results = {}
    for name in datasets.split(","):
        tokens = get_ppl_test_tokens(name, tokenizer, seqlen, local_text_path)
        results[name] = eval_ppl_on_tokens(params, cfg, tokens, seqlen, qcfg)
    return results
