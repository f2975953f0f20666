"""BERT WordPiece tokenizer without ``transformers`` or ``tokenizers``:
the token ids that ``AutoTokenizer.from_pretrained(dir)`` (a
``BertTokenizerFast``) gives the JAX package's text classifiers
(pipeline/sentiment.py), for checkpoints whose tokenizer is BERT's.

Where the directory has ``tokenizer.json``, ``AutoTokenizer`` builds the
fast tokenizer from it, and so does :meth:`BertTokenizer.from_pretrained`:
its added tokens, normalizer (``BertNormalizer``), pre-tokenizer
(``BertPreTokenizer``), model (``WordPiece``) and post-processor
(``[CLS] $A [SEP]``, as ``TemplateProcessing`` or ``BertProcessing``).
Otherwise it reads ``vocab.txt`` and ``tokenizer_config.json``
(``do_lower_case``, ``strip_accents``, ``tokenize_chinese_chars``, the
special tokens). As ``BertTokenizerFast`` does, the three normalizer
settings of ``tokenizer_config.json`` (defaults True, null, True) replace
those of ``tokenizer.json`` where they differ. Any other model,
normalizer, pre-tokenizer or post-processor raises ValueError.

The steps, as in ``tokenizers``:

1. added tokens (the special ones among them) are cut out of the raw
   text, leftmost-longest, before anything else (``normalized: true``
   ones out of the normalized text);
2. BertNormalizer: drop control characters, NUL and U+FFFD and turn
   whitespace into spaces (``clean_text``); put spaces around CJK
   ideographs; NFD and drop nonspacing marks (``strip_accents``, which
   null means "when lowercasing": the Arabic harakat go, tatweel stays);
   lowercase character by character;
3. split on whitespace, and isolate each punctuation character (ASCII
   punctuation, ``$+<=>^`|~`` among it, and Unicode's P* classes: the
   Arabic comma and question mark);
4. WordPiece: greedy longest match from the word's start, later pieces
   with ``##``; a word with no full cover, or longer than
   ``max_input_chars_per_word`` characters, is one ``[UNK]``.

The character classes are those of the ``tokenizers`` library's own
Unicode tables, generated into ``_bert_unicode.py``, not Python's.
"""

from __future__ import annotations

import bisect
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from audio_processor_tpu_torch.models import _bert_unicode as ucls
from audio_processor_tpu_torch.models.hf_files import (
    read_config, read_json, special_token,
)


class _CharClass:
    """Membership in sorted inclusive code point ranges."""

    def __init__(self, ranges: Sequence[Tuple[int, int]]):
        self._starts = [a for a, _ in ranges]
        self._ends = [b for _, b in ranges]

    def __contains__(self, c: str) -> bool:
        cp = ord(c)
        i = bisect.bisect_right(self._starts, cp) - 1
        return i >= 0 and cp <= self._ends[i]


_REMOVED = _CharClass(ucls.REMOVED)
_WHITESPACE = _CharClass(ucls.WHITESPACE)
_CHINESE = _CharClass(ucls.CHINESE)
_MARK_NONSPACING = _CharClass(ucls.MARK_NONSPACING)
_PUNCTUATION = _CharClass(ucls.PUNCTUATION)

SPECIAL_ATTRS = ("unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token")
SPECIAL_DEFAULTS = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                    "pad_token": "[PAD]", "cls_token": "[CLS]",
                    "mask_token": "[MASK]"}


class _AddedToken:
    def __init__(self, content: str, token_id: int, normalized: bool = False,
                 lstrip: bool = False, rstrip: bool = False,
                 single_word: bool = False):
        if single_word:
            raise ValueError(f"added token {content!r}: single_word "
                             "matching is not ported")
        self.content, self.id = content, token_id
        self.normalized, self.lstrip, self.rstrip = normalized, lstrip, rstrip


class BertTokenizer:
    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = True,
                 strip_accents: Optional[bool] = None,
                 clean_text: bool = True, handle_chinese_chars: bool = True,
                 unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = 100,
                 prefix_ids: Sequence[int] = (), suffix_ids: Sequence[int] = (),
                 pad_id: int = 0, added: Sequence[_AddedToken] = ()):
        self.vocab = dict(vocab)
        self.lowercase = lowercase
        # tokenizers: strip_accents null means "as lowercase".
        self.strip_accents = lowercase if strip_accents is None \
            else strip_accents
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.unk_id = self.vocab[unk_token]
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word
        self.prefix_ids, self.suffix_ids = list(prefix_ids), list(suffix_ids)
        self.pad_id = pad_id
        self._raw_added = [t for t in added if not t.normalized]
        self._norm_added = [t for t in added if t.normalized]

    # -------------------------------------------------------------- load
    @classmethod
    def from_pretrained(cls, model_dir: str | Path) -> "BertTokenizer":
        d = Path(model_dir)
        tc = (read_json(d / "tokenizer_config.json")
              if (d / "tokenizer_config.json").exists() else {})
        if (d / "tokenizer.json").exists():
            return cls._from_tokenizer_json(read_json(d / "tokenizer.json"),
                                            tc)
        if not (d / "vocab.txt").exists():
            raise FileNotFoundError(f"{d} holds neither tokenizer.json nor "
                                    "vocab.txt")
        model_type = (read_config(d).get("model_type")
                      if (d / "config.json").exists() else None)
        tok_class = tc.get("tokenizer_class") or model_type
        if tok_class not in ("BertTokenizer", "BertTokenizerFast", "bert"):
            raise ValueError(f"{d}: tokenizer {tok_class!r} is not a BERT "
                             "WordPiece tokenizer")
        vocab: Dict[str, int] = {}
        with open(d / "vocab.txt", "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        specials = {a: special_token(tc.get(a, SPECIAL_DEFAULTS[a]))
                    for a in SPECIAL_ATTRS}
        added = {int(i): t for i, t in
                 tc.get("added_tokens_decoder", {}).items()}
        for attr in SPECIAL_ATTRS:
            tok = specials[attr]
            if tok is not None and tok not in vocab and \
                    tok not in {t["content"] for t in added.values()}:
                added[len(vocab) + len(added)] = {"content": tok}
        for i, t in added.items():
            vocab.setdefault(t["content"], i)
        added_tokens = [_AddedToken(t["content"], i,
                                    normalized=t.get("normalized", False),
                                    lstrip=t.get("lstrip", False),
                                    rstrip=t.get("rstrip", False),
                                    single_word=t.get("single_word", False))
                        for i, t in sorted(added.items())]
        for attr in SPECIAL_ATTRS:          # specials match in raw text
            tok = specials[attr]
            if tok is not None and tok not in {t.content
                                               for t in added_tokens}:
                added_tokens.append(_AddedToken(tok, vocab[tok]))
        return cls(vocab, lowercase=bool(tc.get("do_lower_case", True)),
                   strip_accents=tc.get("strip_accents"),
                   handle_chinese_chars=bool(
                       tc.get("tokenize_chinese_chars", True)),
                   unk_token=specials["unk_token"],
                   prefix_ids=[vocab[specials["cls_token"]]],
                   suffix_ids=[vocab[specials["sep_token"]]],
                   pad_id=vocab.get(specials["pad_token"], 0),
                   added=added_tokens)

    @classmethod
    def _from_tokenizer_json(cls, tj: dict, tc: dict) -> "BertTokenizer":
        model = tj.get("model") or {}
        if model.get("type") != "WordPiece":
            raise ValueError(f"tokenizer model {model.get('type')!r} is not "
                             "WordPiece (not ported)")
        norm = tj.get("normalizer") or {}
        if norm.get("type") != "BertNormalizer":
            raise ValueError(f"normalizer {norm.get('type')!r} is not "
                             "BertNormalizer (not ported)")
        if (tj.get("pre_tokenizer") or {}).get("type") != "BertPreTokenizer":
            raise ValueError("pre-tokenizer is not BertPreTokenizer "
                             "(not ported)")
        vocab = dict(model["vocab"])
        added = [_AddedToken(t["content"], t["id"],
                             normalized=t.get("normalized", False),
                             lstrip=t.get("lstrip", False),
                             rstrip=t.get("rstrip", False),
                             single_word=t.get("single_word", False))
                 for t in tj.get("added_tokens", [])]
        for t in added:
            vocab.setdefault(t.content, t.id)
        prefix, suffix = cls._post_processor(tj.get("post_processor"))
        lowercase = norm.get("lowercase", True)
        strip = norm.get("strip_accents")
        chinese = norm.get("handle_chinese_chars", True)
        if tc.get("tokenizer_class") != "PreTrainedTokenizerFast":
            # BertTokenizerFast rebuilds the normalizer from its own
            # settings where any of the three differs.
            want = (tc.get("do_lower_case", True), tc.get("strip_accents"),
                    tc.get("tokenize_chinese_chars", True))
            if (lowercase, strip, chinese) != want:
                lowercase, strip, chinese = want
        pad = special_token(tc.get("pad_token", "[PAD]"))
        return cls(vocab, lowercase=bool(lowercase), strip_accents=strip,
                   clean_text=norm.get("clean_text", True),
                   handle_chinese_chars=bool(chinese),
                   unk_token=model.get("unk_token", "[UNK]"),
                   continuing_subword_prefix=model.get(
                       "continuing_subword_prefix", "##"),
                   max_input_chars_per_word=model.get(
                       "max_input_chars_per_word", 100),
                   prefix_ids=prefix, suffix_ids=suffix,
                   pad_id=vocab.get(pad, 0), added=added)

    @staticmethod
    def _post_processor(pp: Optional[dict]) -> Tuple[List[int], List[int]]:
        """Special ids before and after a single sequence."""
        kind = (pp or {}).get("type")
        if kind == "BertProcessing":
            return [pp["cls"][1]], [pp["sep"][1]]
        if kind == "TemplateProcessing":
            before, after, seen = [], [], False
            for piece in pp["single"]:
                if "Sequence" in piece:
                    seen = True
                    continue
                ids = pp["special_tokens"][piece["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(ids)
            return before, after
        raise ValueError(f"post-processor {kind!r} is not ported")

    # ------------------------------------------------------------ encode
    def _normalize(self, text: str) -> str:
        if self.clean_text:
            text = "".join(" " if c in _WHITESPACE else c for c in text
                           if c not in _REMOVED)
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if c in _CHINESE else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if c not in _MARK_NONSPACING)
        if self.lowercase:
            text = "".join(c.lower() for c in text)
        return text

    @staticmethod
    def _split_added(text: str, tokens: Sequence[_AddedToken]
                     ) -> List[Tuple[str, Optional[int]]]:
        """Cut the added tokens out of ``text`` (leftmost, then longest
        match; lstrip/rstrip take the whitespace beside a match): pieces
        of text (id None) and matched tokens (their id)."""
        if not tokens:
            return [(text, None)]
        out: List[Tuple[str, Optional[int]]] = []
        pos = start = 0
        while pos < len(text):
            match = None
            for t in tokens:
                if text.startswith(t.content, pos) and (
                        match is None or len(t.content) > len(match.content)):
                    match = t
            if match is None:
                pos += 1
                continue
            lo, hi = pos, pos + len(match.content)
            if match.lstrip:
                while lo > start and text[lo - 1] in _WHITESPACE:
                    lo -= 1
            if match.rstrip:
                while hi < len(text) and text[hi] in _WHITESPACE:
                    hi += 1
            if lo > start:
                out.append((text[start:lo], None))
            out.append((match.content, match.id))
            pos = start = hi
        if start < len(text):
            out.append((text[start:], None))
        return out

    @staticmethod
    def _pre_tokenize(text: str) -> List[str]:
        words, cur = [], []
        for c in text:
            if c in _WHITESPACE:
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif c in _PUNCTUATION:
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.prefix + piece
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            else:
                return [self.unk_id]
            start = end
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        """Token ids of ``text`` without the special tokens around it."""
        ids: List[int] = []
        for raw, tid in self._split_added(text, self._raw_added):
            if tid is not None:
                ids.append(tid)
                continue
            for piece, nid in self._split_added(self._normalize(raw),
                                                self._norm_added):
                if nid is not None:
                    ids.append(nid)
                    continue
                for word in self._pre_tokenize(piece):
                    ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        """[CLS] ids [SEP], the ids cut at the end to fit ``max_length``."""
        keep = max(max_length - len(self.prefix_ids) - len(self.suffix_ids),
                   0)
        return self.prefix_ids + self.tokenize_ids(text)[:keep] \
            + self.suffix_ids

    def __call__(self, texts: Sequence[str], max_length: int = 512
                 ) -> Dict[str, np.ndarray]:
        """``tokenizer(texts, truncation=True, max_length=max_length,
        padding=True, return_tensors="np")``: int64 ``input_ids`` padded
        on the right with the pad id, and ``attention_mask``."""
        seqs = [self.encode(t, max_length) for t in texts]
        width = max((len(s) for s in seqs), default=0)
        ids = np.full((len(seqs), width), self.pad_id, np.int64)
        mask = np.zeros((len(seqs), width), np.int64)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}
