"""ANLS (Average Normalized Levenshtein Similarity) for DocVQA-style eval.

The port's own copy of :mod:`pixparse_tpu.utils.metrics`: normalized
Levenshtein distance, tau=0.5 threshold similarity, max over ground-truth
answers, averaged over questions.
"""

from __future__ import annotations

from typing import List, Sequence

try:  # fast C implementation when available
    import Levenshtein as _lev

    def _edit_distance(a: str, b: str) -> int:
        return _lev.distance(a, b)

except ImportError:  # pragma: no cover - fallback path

    def _edit_distance(a: str, b: str) -> int:
        return levenshtein_py(a, b)


def levenshtein_py(a: Sequence, b: Sequence) -> int:
    """Plain-Python Levenshtein distance over any sequence (unit costs)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def normalized_levenshtein(s1: str, s2: str) -> float:
    longest = max(len(s1), len(s2))
    if longest == 0:
        return 0.0  # both empty: zero distance (similarity 1 downstream)
    return _edit_distance(s1, s2) / longest


def similarity_score(a_ij: str, o_q_i: str, tau: float = 0.5) -> float:
    nl = normalized_levenshtein(a_ij, o_q_i)
    return 1 - nl if nl < tau else 0


def average_normalized_levenshtein_similarity(
    ground_truth: List[List[str]], predicted_answers: List[str]
) -> float:
    """ANLS over a dataset: ground_truth[i] is the list of accepted answers."""
    assert len(ground_truth) == len(predicted_answers), (
        "Length of ground_truth and predicted_answers must match."
    )
    total = 0.0
    for answers, pred in zip(ground_truth, predicted_answers):
        total += max(similarity_score(a, pred) for a in answers)
    return total / len(ground_truth)
