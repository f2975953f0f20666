"""Darija→French text conversion and fuzzy number replacement.

Behavior-matched to the reference's DarijaFrenchConverter
(services/speech_segment.py:19-158): xlsx dictionaries (first-party
reader, host/xlsx.py), n-gram (5→1) fuzzy number matching with the
adaptive threshold ``base - 3·max(n-2, 0)``, longest-first
case-insensitive whole-word substitution, and whitespace cleanup.

Fuzzy scoring is rapidfuzz's ``fuzz.ratio`` (normalized Indel
similarity ×100) with a first-party fallback implementation when
rapidfuzz isn't installed.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

try:
    from rapidfuzz import fuzz as _fuzz

    def _ratio(a: str, b: str) -> float:
        return _fuzz.ratio(a, b)
except ImportError:  # first-party Indel ratio
    def _ratio(a: str, b: str) -> float:
        la, lb = len(a), len(b)
        if la + lb == 0:
            return 100.0
        # LCS length via DP (strings here are short n-grams).
        prev = [0] * (lb + 1)
        for i in range(1, la + 1):
            cur = [0] * (lb + 1)
            ai = a[i - 1]
            for j in range(1, lb + 1):
                cur[j] = (prev[j - 1] + 1 if ai == b[j - 1]
                          else max(prev[j], cur[j - 1]))
            prev = cur
        lcs = prev[lb]
        return 100.0 * (2.0 * lcs) / (la + lb)


def _extract_one(query: str, choices: List[str]
                 ) -> Tuple[Optional[str], float]:
    best, best_score = None, -1.0
    for c in choices:
        s = _ratio(query, c)
        if s > best_score:
            best, best_score = c, s
    return best, best_score


class DarijaFrenchConverter:
    def __init__(self, config):
        self.config = config
        self.mapping: Dict[str, str] = {}
        self.sorted_keys: List[str] = []
        self.word_to_number: Dict[str, float] = {}
        self.reference_words: List[str] = []
        self._compiled: List[Tuple[re.Pattern, str]] = []
        self._load_dictionary()
        self._load_number_dictionary()

    # ------------------------------------------------------------------
    def _load_dictionary(self):
        """First column = French; other columns = Darija variants
        (reference: speech_segment.py:31-51)."""
        path = self.config.get("darija_french_dict")
        if not path:
            return
        try:
            from audio_processor_tpu_torch.host.xlsx import read_table

            table = read_table(path)
            headers = list(table.keys())
            if not headers:
                return
            french = table[headers[0]]
            for col in headers[1:]:
                for fr, dar in zip(french, table[col]):
                    if dar is not None and fr is not None \
                            and str(dar).strip():
                        self.mapping[str(dar).strip()] = str(fr).strip()
            self.sorted_keys = sorted(self.mapping, key=len, reverse=True)
            self._compiled = [
                (re.compile(rf"\b{re.escape(k)}\b", flags=re.IGNORECASE),
                 f" {self.mapping[k]} ")
                for k in self.sorted_keys
            ]
            logger.info("Loaded Darija dictionary with %d entries",
                        len(self.mapping))
        except Exception as e:
            logger.error("Error loading Darija dictionary: %s", e)

    def _load_number_dictionary(self):
        """'Nombre' column + variant columns
        (reference: speech_segment.py:53-70)."""
        path = self.config.get("darija_numbers_dict")
        if not path:
            return
        try:
            from audio_processor_tpu_torch.host.xlsx import read_table

            table = read_table(path)
            if "Nombre" not in table:
                logger.error("darija_numbers_dict missing 'Nombre' column")
                return
            numbers = table["Nombre"]
            variant_cols = [h for h in table if h != "Nombre"]
            for i, number in enumerate(numbers):
                if number is None:
                    continue
                for col in variant_cols:
                    word = table[col][i]
                    if word is None:
                        continue
                    word = str(word).strip()
                    if word:
                        self.word_to_number[word] = number
            self.reference_words = list(self.word_to_number)
            logger.info("Loaded Darija number dictionary with %d entries",
                        len(self.word_to_number))
        except Exception as e:
            logger.error("Error loading Darija number dictionary: %s", e)

    # ------------------------------------------------------------------
    def _fuzzy_map_darija_number(self, chunk: str, threshold: float = 90
                                 ) -> Tuple[Optional[float], Optional[str],
                                            float]:
        if not self.reference_words:
            return None, None, 0.0
        match, score = _extract_one(chunk, self.reference_words)
        if score >= threshold:
            return self.word_to_number[match], match, score
        return None, None, score

    def _replace_numbers_in_sentence(self, sentence: str,
                                     base_threshold: int = 90,
                                     max_ngram: int = 5) -> str:
        if not self.word_to_number:
            return sentence
        words = sentence.strip().split()
        replaced: List[Optional[str]] = [None] * len(words)
        used: set = set()
        for n in range(max_ngram, 0, -1):
            for i in range(len(words) - n + 1):
                positions = set(range(i, i + n))
                if positions & used:
                    continue
                chunk = " ".join(words[i:i + n])
                threshold = base_threshold - max(n - 2, 0) * 3
                number, _, _ = self._fuzzy_map_darija_number(chunk, threshold)
                if number is not None:
                    replaced[i] = str(int(number))
                    for j in range(i + 1, i + n):
                        replaced[j] = ""
                    used.update(positions)
        final = [rep if rep is not None else word
                 for word, rep in zip(words, replaced) if rep != ""]
        return " ".join(final)

    def convert_text(self, text: str) -> str:
        text = self._replace_numbers_in_sentence(text)
        if not self.mapping:
            return text
        for pattern, repl in self._compiled:
            text = pattern.sub(repl, text)
        return " ".join(text.split())
