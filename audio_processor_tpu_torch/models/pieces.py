"""SentencePiece-style piece tables, their detokenization and a greedy
encoder (host side).

A text decoder's ids map to pieces; ``▁`` (U+2581) marks the start of a
word. Detokenization joins the pieces of the ids, turns each ``▁`` into a
space and strips the ends, as SentencePiece's ``decode_pieces`` does.
Special ids (pad, unk, bos, eos, the target-language token) give no text.
A table with byte pieces (``<0x00>`` .. ``<0xFF>``, SentencePiece's byte
fallback) decodes runs of them as UTF-8.

:meth:`PieceVocab.encode` turns text into ids by greedy longest match over
the pieces, after the spaces are written ``▁`` and one ``▁`` is put before
the text; a character that no piece starts falls back to its UTF-8 byte
pieces, so every text encodes.

Until real models' tokenizer files are in the repository, the
speech-to-text path runs on a seeded table (:meth:`PieceVocab.synthetic`)
and the topic LM on another (:meth:`PieceVocab.synthetic_bytes`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

WORD_START = "▁"
SPECIAL_PIECES = ("<pad>", "<unk>", "<s>", "</s>")
# Letters of the synthetic pieces: the default Darija CTC vocabulary's.
SYNTHETIC_LETTERS = "ابتثجحخدذرزسشصضطظعغفقكلمنهويىءآأؤإئةّ" \
    "abcdefghijklmnopqrstuvwxyz0123456789"
# and the topic LM's, which reads French prompts and glossaries too.
SYNTHETIC_TEXT_LETTERS = SYNTHETIC_LETTERS + "éèêëàâçîïôûùœ" \
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ.,:;'’-()•*?!\n"
BYTE_PIECE = "<0x{:02X}>"
# Letter frequencies (%) of French text, with the digits Latin-script
# Darija writes for its own sounds (3, 7, 9): the synthetic LM table's
# letters are drawn mostly by these.
LETTER_FREQ = {
    "e": 14.7, "s": 7.9, "a": 7.6, "i": 7.5, "t": 7.2, "n": 7.1, "r": 6.7,
    "u": 6.3, "o": 5.8, "l": 5.5, "d": 3.7, "c": 3.3, "m": 3.0, "p": 3.0,
    "é": 1.9, "v": 1.8, "q": 1.4, "f": 1.1, "b": 0.9, "g": 0.9, "h": 0.7,
    "j": 0.6, "3": 0.5, "x": 0.4, "y": 0.3, "z": 0.3, "7": 0.3, "9": 0.3,
    "k": 0.2, "w": 0.1}


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
        self._bytes = np.full(len(self.pieces), -1, dtype=np.int16)
        for i, piece in enumerate(self.pieces):
            if len(piece) == 6 and piece.startswith("<0x") \
                    and piece.endswith(">") and i not in self.special_ids:
                self._bytes[i] = int(piece[3:5], 16)
        self._has_bytes = bool((self._bytes >= 0).any())
        self._index: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        return len(self.pieces)

    def decode(self, ids: Iterable[int]) -> str:
        arr = np.asarray(list(ids) if not isinstance(ids, np.ndarray)
                         else ids, dtype=np.int64)
        arr = arr[(arr >= 0) & (arr < len(self._table))]
        if not self._has_bytes:
            return "".join(self._table[arr]).replace(WORD_START, " ").strip()
        out: List[str] = []
        run = bytearray()
        for i in arr.tolist():
            b = int(self._bytes[i])
            if b >= 0:
                run.append(b)
                continue
            if run:
                out.append(run.decode("utf-8", errors="replace"))
                run = bytearray()
            out.append(self._table[i])
        if run:
            out.append(run.decode("utf-8", errors="replace"))
        return "".join(out).replace(WORD_START, " ").strip()

    def encode(self, text: str) -> List[int]:
        """Ids of ``text`` by greedy longest match (see the module's notes);
        raises ValueError on a character the table cannot spell, which a
        table with byte pieces never meets."""
        if self._index is None:
            index: Dict[str, int] = {}
            for i, piece in enumerate(self.pieces):
                if i not in self.special_ids and self._bytes[i] < 0 \
                        and piece:
                    index.setdefault(piece, i)
            self._index = index
            self._longest = max(map(len, index), default=1)
            self._byte_ids = {int(b): i for i, b in enumerate(self._bytes)
                              if b >= 0}
        index, longest = self._index, self._longest
        s = WORD_START + text.replace(" ", WORD_START)
        ids: List[int] = []
        i, n = 0, len(s)
        while i < n:
            for L in range(min(longest, n - i), 0, -1):
                got = index.get(s[i:i + L])
                if got is not None:
                    ids.append(got)
                    i += L
                    break
            else:
                try:
                    ids.extend(self._byte_ids[b] for b in s[i].encode())
                except KeyError:
                    raise ValueError(f"no piece spells {s[i]!r}") from None
                i += 1
        return ids

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

    @classmethod
    def synthetic_bytes(cls, vocab_size: int, seed: int,
                        special: Dict[int, str]) -> "PieceVocab":
        """A seeded table with byte fallback: ids 0-255 the byte pieces,
        then each character of :data:`SYNTHETIC_TEXT_LETTERS` alone, then
        pieces of 2-7 characters, 40% of them starting a word, whose
        letters are drawn 85% by French letter frequency
        (:data:`LETTER_FREQ`) and 15% uniformly from the rest, so common
        n-grams are pieces as in a trained table (≈ 2.5 ids a word of
        Latin-script Darija); ``special`` (id -> name) and every id above
        the smallest of them are reserved (special, no text)."""
        rng = np.random.default_rng(int(seed))
        common = list(LETTER_FREQ)
        alphabet = np.asarray(common + list(SYNTHETIC_TEXT_LETTERS),
                              dtype=object)
        f = np.asarray(list(LETTER_FREQ.values()), dtype=np.float64)
        prob = np.concatenate([0.85 * f / f.sum(), np.full(
            len(SYNTHETIC_TEXT_LETTERS), 0.15 / len(SYNTHETIC_TEXT_LETTERS))])
        lens = rng.integers(2, 8, size=vocab_size)
        starts = rng.random(vocab_size) < 0.4
        codes = alphabet[rng.choice(len(alphabet), size=int(lens.sum()),
                                    p=prob)]
        ends = np.cumsum(lens)
        pieces = [(WORD_START if s else "") + "".join(codes[e - n:e])
                  for n, e, s in zip(lens, ends, starts)]
        pieces[:256] = [BYTE_PIECE.format(b) for b in range(256)]
        pieces[256:256 + len(SYNTHETIC_TEXT_LETTERS)] = \
            list(SYNTHETIC_TEXT_LETTERS)
        first = min(special)
        reserved = range(first, vocab_size)
        for i in reserved:
            pieces[i] = special.get(i, f"<|reserved_{i - first}|>")
        return cls(pieces, reserved)
