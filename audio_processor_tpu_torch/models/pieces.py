"""SentencePiece-style piece tables and their detokenization (host side).

A text decoder's ids map to pieces; ``▁`` (U+2581) marks the start of a
word. Detokenization joins the pieces of the ids, turns each ``▁`` into a
space and strips the ends, as SentencePiece's ``decode_pieces`` does.
Special ids (pad, unk, bos, eos, the target-language token) give no text.

Until a real model's ``sentencepiece.bpe.model`` is in the repository, the
speech-to-text path runs on a seeded table (:meth:`PieceVocab.synthetic`).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

WORD_START = "▁"
SPECIAL_PIECES = ("<pad>", "<unk>", "<s>", "</s>")
# Letters of the synthetic pieces: the default Darija CTC vocabulary's.
SYNTHETIC_LETTERS = "ابتثجحخدذرزسشصضطظعغفقكلمنهويىءآأؤإئةّ" \
    "abcdefghijklmnopqrstuvwxyz0123456789"


class PieceVocab:
    """id -> piece, with the ids that give no text."""

    def __init__(self, pieces: Sequence[str], special_ids: Iterable[int]):
        self.pieces = list(pieces)
        self.special_ids = frozenset(int(i) for i in special_ids)
        table = np.asarray(self.pieces, dtype=object)
        for i in self.special_ids:
            if 0 <= i < len(table):
                table[i] = ""
        self._table = table

    def __len__(self) -> int:
        return len(self.pieces)

    def decode(self, ids: Iterable[int]) -> str:
        arr = np.asarray(list(ids) if not isinstance(ids, np.ndarray)
                         else ids, dtype=np.int64)
        arr = arr[(arr >= 0) & (arr < len(self._table))]
        return "".join(self._table[arr]).replace(WORD_START, " ").strip()

    def batch_decode(self, ids: np.ndarray,
                     mask: Optional[np.ndarray] = None) -> List[str]:
        """[B, T] ids (+ the mask of each row's text tokens) -> texts."""
        ids = np.asarray(ids)
        return [self.decode(ids[b] if mask is None
                            else ids[b][np.asarray(mask[b]).astype(bool)])
                for b in range(ids.shape[0])]

    @classmethod
    def synthetic(cls, vocab_size: int, seed: int,
                  lang_id: int) -> "PieceVocab":
        """A seeded table: ids 0-3 ``<pad> <unk> <s> </s>``, ``lang_id`` the
        target-language token ``__arb__``, every other id a piece of 1-6
        letters of :data:`SYNTHETIC_LETTERS`, a third of them starting a
        word."""
        rng = np.random.default_rng(int(seed))
        letters = np.asarray(list(SYNTHETIC_LETTERS), dtype=object)
        lens = rng.integers(1, 7, size=vocab_size)
        starts = rng.random(vocab_size) < 1.0 / 3.0
        codes = letters[rng.integers(0, len(letters), size=int(lens.sum()))]
        ends = np.cumsum(lens)
        pieces = [(WORD_START if s else "") + "".join(codes[e - n:e])
                  for n, e, s in zip(lens, ends, starts)]
        pieces[:len(SPECIAL_PIECES)] = SPECIAL_PIECES
        pieces[lang_id] = "__arb__"
        return cls(pieces, list(range(len(SPECIAL_PIECES))) + [lang_id])
