"""CTC vocabulary + greedy decoding (host side).

Equivalent to HF ``Wav2Vec2CTCTokenizer.batch_decode`` as used by the
reference (services/audio_processor.py:275-281): collapse repeated
frame ids, drop the pad/blank token, map ids to characters, and turn
the word-delimiter token (``|``) into a space.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

DEFAULT_SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")


class CTCVocab:
    def __init__(self, vocab: Dict[str, int],
                 pad_token: str = "<pad>",
                 word_delimiter_token: str = "|",
                 special_tokens: Sequence[str] = DEFAULT_SPECIALS):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.pad_token = pad_token
        self.pad_id = self.vocab.get(pad_token, 0)
        self.word_delimiter_token = word_delimiter_token
        self.special_ids = {self.vocab[t] for t in special_tokens
                            if t in self.vocab}
        # Vectorized id -> text table (word delimiter already mapped
        # to a space, unknown ids to ""): one fancy-index + join
        # replaces a Python dict lookup per frame in decode_ids.
        n_ids = max(self.vocab.values()) + 1
        table = [""] * n_ids
        for t, i in self.vocab.items():
            table[i] = " " if t == word_delimiter_token else t
        self._token_table = np.asarray(table, dtype=object)

    def __len__(self) -> int:
        return max(self.vocab.values()) + 1

    @classmethod
    def from_json(cls, path: str | Path, **kw) -> "CTCVocab":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f), **kw)

    @classmethod
    def darija_default(cls) -> "CTCVocab":
        """Arabic-script + Latin fallback vocabulary used when no
        checkpoint vocab is available (synthetic/benchmark runs)."""
        chars = list("ابتثجحخدذرزسشصضطظعغفقكلمنهويىءآأؤإئةّ") + \
            list("abcdefghijklmnopqrstuvwxyz0123456789")
        tokens = ["<pad>", "<s>", "</s>", "<unk>", "|"] + chars
        return cls({t: i for i, t in enumerate(tokens)})


def ctc_collapse(ids: np.ndarray, pad_id: int) -> np.ndarray:
    """Collapse consecutive repeats, then drop blanks (CTC rule)."""
    ids = np.asarray(ids)
    if ids.size == 0:
        return ids
    keep = np.ones(ids.shape[0], dtype=bool)
    keep[1:] = ids[1:] != ids[:-1]
    out = ids[keep]
    return out[out != pad_id]


def decode_ids(ids: Iterable[int], vocab: CTCVocab,
               skip_special_tokens: bool = False) -> str:
    arr = np.asarray(ids if isinstance(ids, np.ndarray) else list(ids),
                     dtype=np.int64)
    if skip_special_tokens and vocab.special_ids:
        # HF removes special tokens BEFORE CTC grouping, so repeats
        # separated only by specials merge (Wav2Vec2CTCTokenizer
        # semantics).
        arr = arr[~np.isin(arr, list(vocab.special_ids))]
    collapsed = ctc_collapse(arr, vocab.pad_id)
    table = vocab._token_table
    valid = collapsed[(collapsed >= 0) & (collapsed < table.shape[0])]
    return "".join(table[valid]).strip()


def batch_decode(ids: np.ndarray, vocab: CTCVocab,
                 mask: Optional[np.ndarray] = None,
                 skip_special_tokens: bool = False) -> List[str]:
    """[B, T] frame ids (+ optional valid-frame mask) -> list of texts.
    A vocabulary with a ``batch_decode`` of its own (a piece table,
    models/pieces.py) decodes by its own rule."""
    own = getattr(vocab, "batch_decode", None)
    if own is not None:
        return own(ids, mask)
    ids = np.asarray(ids)
    out = []
    for b in range(ids.shape[0]):
        row = ids[b]
        if mask is not None:
            row = row[np.asarray(mask[b]).astype(bool)]
        out.append(decode_ids(row, vocab,
                              skip_special_tokens=skip_special_tokens))
    return out


def decode_words(ids: Iterable[int], vocab: CTCVocab, frame_sec: float,
                 offset_sec: float = 0.0) -> List[Dict]:
    """Greedy CTC frame ids -> words with start/end times.

    Beyond the reference (which returns plain text only): each word
    carries the time span of its character emissions — a frame emits a
    character on the first frame of a run of equal ids (CTC rule), and
    the run's repeats extend the character's end time. Frames are
    ``frame_sec`` apart (20 ms for the stride-2 stacked fbank
    frontend); ``offset_sec`` shifts spans to call time (chunk start).
    """
    words: List[Dict] = []
    cur: List[str] = []
    cur_start = cur_end = 0.0

    def flush():
        nonlocal cur, cur_start, cur_end
        if cur:
            words.append({"word": "".join(cur),
                          "start": round(offset_sec + cur_start, 3),
                          "end": round(offset_sec + cur_end, 3)})
        cur = []

    prev = None
    prev_emitted = False   # did the previous frame emit a character?
    for f, i in enumerate(int(x) for x in ids):
        if i == prev:
            if prev_emitted and cur:
                cur_end = (f + 1) * frame_sec   # repeat extends the run
            continue
        prev = i
        prev_emitted = False
        if i == vocab.pad_id or i in vocab.special_ids:
            continue
        tok = vocab.id_to_token.get(i)
        if tok is None:
            continue
        if tok == vocab.word_delimiter_token:
            flush()
            continue
        if not cur:
            cur_start = f * frame_sec
        cur.append(tok)
        cur_end = (f + 1) * frame_sec
        prev_emitted = True
    flush()
    return words


def batch_decode_words(ids: np.ndarray, vocab: CTCVocab,
                       frame_sec: float,
                       mask: Optional[np.ndarray] = None,
                       offsets_sec: Optional[Sequence[float]] = None
                       ) -> List[List[Dict]]:
    """[B, T] frame ids -> per-row word/time lists."""
    ids = np.asarray(ids)
    out = []
    for b in range(ids.shape[0]):
        row = ids[b]
        if mask is not None:
            row = row[np.asarray(mask[b]).astype(bool)]
        off = float(offsets_sec[b]) if offsets_sec is not None else 0.0
        out.append(decode_words(row, vocab, frame_sec, off))
    return out
