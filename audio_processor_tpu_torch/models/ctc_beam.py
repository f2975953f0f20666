"""CTC prefix beam-search decoding (host side).

The reference decodes greedily only (argmax + collapse,
services/audio_processor.py:275-281). Greedy is the parity path; this
module adds standard prefix beam search over the CTC posteriors for
accuracy-sensitive deployments, summing probabilities over all
alignments of each prefix (Hannun et al., 2014), with an optional
word-insertion bonus.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np

from audio_processor_tpu_torch.models.tokenizer import CTCVocab

NEG_INF = -math.inf


def _logsumexp(*vals: float) -> float:
    m = max(vals)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(v - m) for v in vals))


def ctc_beam_search(log_probs: np.ndarray, vocab: CTCVocab,
                    beam_width: int = 16,
                    word_bonus: float = 0.0,
                    mask: Optional[np.ndarray] = None
                    ) -> List[Tuple[str, float]]:
    """Decode one utterance.

    Args:
      log_probs: [T, V] log posteriors (e.g. torch.log_softmax of the
        CTC logits).
      vocab: CTC vocabulary (blank = pad token).
      beam_width: beams kept per frame.
      word_bonus: additive log bonus per emitted word delimiter.
      mask: optional [T] bool; False frames are skipped.

    Returns [(text, log_score)] sorted best-first.
    """
    log_probs = np.asarray(log_probs)
    T, V = log_probs.shape
    blank = vocab.pad_id

    # beam state: prefix (tuple of ids) -> (log p ending in blank,
    #                                       log p ending in non-blank)
    beams = {(): (0.0, NEG_INF)}
    for t in range(T):
        if mask is not None and not mask[t]:
            continue
        frame = log_probs[t]
        # prune to the locally-plausible symbols for speed
        top = np.argsort(frame)[::-1][:max(beam_width, 8)]
        next_beams: dict = defaultdict(lambda: (NEG_INF, NEG_INF))
        for prefix, (p_b, p_nb) in beams.items():
            p_total = _logsumexp(p_b, p_nb)
            for s in top:
                p_s = float(frame[s])
                if s == blank:
                    nb_b, nb_nb = next_beams[prefix]
                    next_beams[prefix] = (
                        _logsumexp(nb_b, p_total + p_s), nb_nb)
                    continue
                last = prefix[-1] if prefix else None
                new_prefix = prefix + (int(s),)
                bonus = word_bonus if int(s) == vocab.vocab.get(
                    vocab.word_delimiter_token, -1) else 0.0
                if s == last:
                    # same symbol: extends only from the blank state;
                    # from non-blank it merges into the same prefix.
                    nb_b, nb_nb = next_beams[new_prefix]
                    next_beams[new_prefix] = (
                        nb_b, _logsumexp(nb_nb, p_b + p_s + bonus))
                    ob_b, ob_nb = next_beams[prefix]
                    next_beams[prefix] = (
                        ob_b, _logsumexp(ob_nb, p_nb + p_s))
                else:
                    nb_b, nb_nb = next_beams[new_prefix]
                    next_beams[new_prefix] = (
                        nb_b, _logsumexp(nb_nb, p_total + p_s + bonus))
        beams = dict(sorted(
            next_beams.items(),
            key=lambda kv: -_logsumexp(*kv[1]))[:beam_width])

    results = []
    for prefix, (p_b, p_nb) in beams.items():
        parts = []
        for i in prefix:
            tok = vocab.id_to_token.get(i, "")
            parts.append(" " if tok == vocab.word_delimiter_token else tok)
        results.append(("".join(parts).strip(), _logsumexp(p_b, p_nb)))
    results.sort(key=lambda x: -x[1])
    return results


def batch_beam_decode(logits: np.ndarray, vocab: CTCVocab,
                      mask: Optional[np.ndarray] = None,
                      beam_width: int = 16) -> List[str]:
    """[B, T, V] logits -> best-hypothesis texts."""
    logits = np.asarray(logits, np.float64)
    log_probs = logits - np.log(
        np.exp(logits - logits.max(-1, keepdims=True))
        .sum(-1, keepdims=True)) - logits.max(-1, keepdims=True)
    out = []
    for b in range(logits.shape[0]):
        m = None if mask is None else np.asarray(mask[b]).astype(bool)
        hyps = ctc_beam_search(log_probs[b], vocab,
                               beam_width=beam_width, mask=m)
        out.append(hyps[0][0] if hyps else "")
    return out
