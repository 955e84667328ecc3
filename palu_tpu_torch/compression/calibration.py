"""Calibration data (port of palu_tpu/compression/calibration.py; the
reference's palu/data_utils.py:9-43): random contiguous slices of
wikitext2 / c4 train text, tokenized to a fixed length and cached on disk,
or seeded random tokens.

`synthetic_batches` draws the same numpy stream as the JAX package's, so
both packages calibrate on identical tokens. `get_calib_batches` needs a
corpus: the `datasets` package (imported only when a corpus is loaded) or a
local text file (`local_text_path`). Cache files live under
$PALU_CACHE_DIR (default `cache`), read when each call is made, with the
JAX package's names.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np

__all__ = ["get_calib_batches", "synthetic_batches", "datasets_available"]


def _cache_dir() -> str:
    return os.environ.get("PALU_CACHE_DIR", "cache")


def datasets_available(name: str = "wikitext2") -> bool:
    try:
        _load_text(name, probe=True)
        return True
    except Exception:
        return False


def _load_text(name: str, local_text_path: Optional[str] = None, probe: bool = False) -> str:
    if local_text_path:
        with open(local_text_path) as f:
            return f.read()
    from datasets import load_dataset

    if name == "wikitext2":
        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split="train")
        if probe:
            return ""
        return "\n\n".join(ds["text"])
    if name == "c4":
        ds = load_dataset(
            "allenai/c4",
            data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
            revision="607bd4c8450a42878aa9ddc051a65a055450ef87",
            split="train",
        )
        if probe:
            return ""
        return "\n\n".join(ds["text"])
    raise NotImplementedError(name)


def get_calib_batches(name: str, tokenizer, model_id: str, nsamples: int, seqlen: int = 2048,
                      seed: int = 3, local_text_path: Optional[str] = None,
                      use_cache: bool = True) -> List[np.ndarray]:
    """Random contiguous slices, tokenized; each batch is (1, seqlen) int32.
    Mirrors get_calib_data (data_utils.py:9-43) incl. the 10x-seqlen char
    window heuristic and seed handling."""
    cache_file = os.path.join(
        _cache_dir(), f"{name}_{model_id.replace('/', '_')}_{nsamples}_{seqlen}_{seed}.npz")
    if use_cache and os.path.exists(cache_file):
        data = np.load(cache_file)
        return [data[k] for k in sorted(data.files, key=lambda s: int(s.split("_")[1]))]

    rng = random.Random(seed)
    text = _load_text(name, local_text_path)
    batches = []
    for _ in range(nsamples):
        i = rng.randint(0, len(text) - seqlen - 1)
        j = i + seqlen * 10
        enc = tokenizer(text[i:j], return_tensors="np")
        ids = np.asarray(enc["input_ids"])[:, :seqlen].astype(np.int32)
        batches.append(ids)
    if use_cache:
        os.makedirs(_cache_dir(), exist_ok=True)
        np.savez(cache_file, **{f"b_{i}": b for i, b in enumerate(batches)})
    return batches


def synthetic_batches(vocab_size: int, nsamples: int, seqlen: int, seed: int = 0,
                      batch_size: int = 1) -> List[np.ndarray]:
    """Random-token calibration batches for tests and offline runs."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, vocab_size, size=(batch_size, seqlen)).astype(np.int32)
        for _ in range(nsamples)
    ]
