"""CER / WER with the reference implementation's exact jiwer call semantics
(the port's own copy of :mod:`pixparse_tpu.utils.text_metrics`).

The reference computes OCR metrics through jiwer with these transform chains:

- CER: ``RemoveSpecificWords("<pad>")`` -> ``Strip`` -> chars
- WER: ``RemoveSpecificWords("<pad>")`` -> ``RemoveMultipleSpaces`` ->
  ``Strip`` -> words

jiwer is not available here, and there is a subtle quirk worth documenting:
the reference passes the *string* ``"<pad>"`` where jiwer expects a list of
words, so jiwer iterates the characters ``< p a d >`` and substitutes each,
as a regex-escaped token wrapped in ``\\b`` word boundaries, with a space.
In practice that deletes stand-alone single-letter words ``p``/``a``/``d``
from both reference and hypothesis. We reproduce that behaviour bit-for-bit
(it changes measured WER/CER on real text, and parity with the reference's
measured numbers is a requirement), behind ``remove_words="<pad>"`` defaults.

Error rates are micro-averaged exactly as jiwer does: the total edit distance
over all sentence pairs divided by the total number of reference tokens.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence

from pixparse_tpu_torch.utils.metrics import levenshtein_py

try:
    import Levenshtein as _lev
except ImportError:  # pragma: no cover
    _lev = None


def _substitute_words(s: str, words: Iterable[str], replacement: str = " ") -> str:
    """jiwer ``SubstituteWords``: whole-word regex substitution.

    Iterating a plain string here (e.g. ``"<pad>"``) substitutes its
    characters — intentionally kept to mirror the reference call.
    """
    for w in words:
        s = re.sub(rf"\b{re.escape(w)}\b", replacement, s)
    return s


def _remove_multiple_spaces(s: str) -> str:
    return re.sub(r"\s\s+", " ", s)


def _to_words(s: str, remove_words: Iterable[str]) -> List[str]:
    s = _substitute_words(s, remove_words)
    s = _remove_multiple_spaces(s)
    s = s.strip()
    return [w for w in s.split(" ") if w]


def _to_chars(s: str, remove_words: Iterable[str]) -> List[str]:
    s = _substitute_words(s, remove_words)
    s = s.strip()
    return list(s)


def _seq_edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    if _lev is not None:
        # Map tokens to single unicode chars so the C Levenshtein runs on strings.
        vocab: Dict[str, str] = {}
        def enc(tokens):
            out = []
            for t in tokens:
                if t not in vocab:
                    vocab[t] = chr(0xE000 + len(vocab))  # private use area
                out.append(vocab[t])
            return "".join(out)
        return _lev.distance(enc(ref), enc(hyp))
    return levenshtein_py(ref, hyp)


def _rate(
    references: List[str],
    hypotheses: List[str],
    tokenize,
    remove_words: Iterable[str],
) -> float:
    total_dist = 0
    total_ref = 0
    for ref, hyp in zip(references, hypotheses):
        ref_t = tokenize(ref, remove_words)
        hyp_t = tokenize(hyp, remove_words)
        total_dist += _seq_edit_distance(ref_t, hyp_t)
        total_ref += len(ref_t)
    if total_ref == 0:
        raise ValueError("empty reference after transforms; cannot compute rate")
    return total_dist / total_ref


def wer_metric(
    references: List[str] | str,
    hypotheses: List[str] | str,
    remove_words: Iterable[str] = "<pad>",
) -> float:
    if isinstance(references, str):
        references = [references]
    if isinstance(hypotheses, str):
        hypotheses = [hypotheses]
    return _rate(references, hypotheses, _to_words, remove_words)


def cer_metric(
    references: List[str] | str,
    hypotheses: List[str] | str,
    remove_words: Iterable[str] = "<pad>",
) -> float:
    if isinstance(references, str):
        references = [references]
    if isinstance(hypotheses, str):
        hypotheses = [hypotheses]
    return _rate(references, hypotheses, _to_chars, remove_words)


def get_cer_wer_metrics(
    metrics: dict,
    predictions: List[str],
    references: List[str],
) -> dict:
    """Populate ``metrics`` with wer/cer; swallow errors like the reference
    (``utils/ocr_utils.py:114-140``) so a degenerate eval batch cannot kill a
    long run — the condition is logged instead."""
    import logging

    try:
        metrics["wer"] = wer_metric(references, predictions)
        metrics["cer"] = cer_metric(references, predictions)
    except Exception as e:  # noqa: BLE001 - parity with reference behaviour
        logging.getLogger("ocr").info(
            "Exception %s computing wer/cer (refs=%d, preds=%d).",
            e, len(references), len(predictions),
        )
    return metrics
