"""ASR quality metrics: token edit distance, WER, CER (port of
utils/metrics.py, pure numpy).

Fine-tuning (training/finetune.py) uses these in its eval loop; they
are also useful standalone for model-selection between checkpoints.

Corpus-level definitions (the standard Kaldi/HF convention):
    WER = total word edits across the corpus / total reference words
    CER = total char edits across the corpus / total reference chars
— NOT a mean of per-utterance rates, which over-weights short
utterances. Held equal to the JAX package's functions in the tests.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over arbitrary token sequences
    (unit-cost substitution/insertion/deletion), O(len(ref)) memory."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    # Vectorised DP over hyp: prev[j] = D[i-1][j]; the recurrence's
    # row-internal dependency (insertions) is a prefix-min scan that
    # numpy can't express directly, so keep the scalar inner loop but
    # hoist the per-row equality vector.
    prev = np.arange(m + 1, dtype=np.int64)
    cur = np.empty(m + 1, dtype=np.int64)
    hyp_arr = list(hyp)
    for i in range(1, n + 1):
        cur[0] = i
        r = ref[i - 1]
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1,                       # deletion
                         cur[j - 1] + 1,                    # insertion
                         prev[j - 1] + (r != hyp_arr[j - 1]))
        prev, cur = cur, prev
    return int(prev[m])


def _corpus_rate(pairs: List[Tuple[Sequence, Sequence]]) -> float:
    edits = sum(edit_distance(r, h) for r, h in pairs)
    total = sum(len(r) for r, _ in pairs)
    if total == 0:
        # Empty references: any hypothesis tokens are pure insertions
        # with no length to normalise by; the convention is 0 when
        # the hypotheses are empty too, else infinity.
        return 0.0 if edits == 0 else float("inf")
    return edits / total


def wer(refs: List[str], hyps: List[str]) -> float:
    """Corpus word error rate; whitespace tokenisation."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references vs {len(hyps)} "
                         "hypotheses")
    return _corpus_rate([(r.split(), h.split())
                         for r, h in zip(refs, hyps)])


def cer(refs: List[str], hyps: List[str]) -> float:
    """Corpus character error rate; whitespace runs collapse to one
    space so tokenisation noise doesn't count as errors."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references vs {len(hyps)} "
                         "hypotheses")
    norm = lambda s: " ".join(s.split())  # noqa: E731
    return _corpus_rate([(norm(r), norm(h))
                         for r, h in zip(refs, hyps)])
