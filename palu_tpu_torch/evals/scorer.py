"""LongBench scoring (a copy of palu_tpu/evals/scorer.py; the reference's
longbench_utils/scorer.py:39-66)."""

from __future__ import annotations

import numpy as np

from .metrics import dataset2metric

__all__ = ["scorer", "scorer_e"]

_FIRSTLINE_DATASETS = {"trec", "triviaqa", "samsum", "lsht"}


def scorer(dataset, predictions, answers, all_classes):
    total = 0.0
    for prediction, ground_truths in zip(predictions, answers):
        score = 0.0
        if dataset in _FIRSTLINE_DATASETS:
            prediction = prediction.lstrip("\n").split("\n")[0]
        for gt in ground_truths:
            score = max(
                score, dataset2metric[dataset](prediction, gt, all_classes=all_classes)
            )
        total += score
    return round(100 * total / len(predictions), 2)


def scorer_e(dataset, predictions, answers, lengths, all_classes):
    """Length-bucketed variant (0-4k / 4-8k / 8k+)."""
    buckets = {"0-4k": [], "4-8k": [], "8k+": []}
    for prediction, ground_truths, length in zip(predictions, answers, lengths):
        score = 0.0
        if dataset in _FIRSTLINE_DATASETS:
            prediction = prediction.lstrip("\n").split("\n")[0]
        for gt in ground_truths:
            score = max(
                score, dataset2metric[dataset](prediction, gt, all_classes=all_classes)
            )
        if length < 4000:
            buckets["0-4k"].append(score)
        elif length < 8000:
            buckets["4-8k"].append(score)
        else:
            buckets["8k+"].append(score)
    return {k: round(100 * float(np.mean(v)), 2) if v else 0.0 for k, v in buckets.items()}
