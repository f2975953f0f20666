"""Write audio_processor_tpu_torch/models/_bert_unicode.py: the character
classes that HF ``tokenizers``' BertNormalizer and BertPreTokenizer use,
read off the library itself, code point by code point.

    python tools/gen_bert_unicode_tables.py

``tokenizers`` classifies characters with tables of its own Unicode
version, which is not Python's ``unicodedata``'s (it strips no nonspacing
mark and isolates no punctuation that later versions added). The port's
BERT tokenizer (models/bert_tokenizer.py) must give the token ids that
``AutoTokenizer`` gives, so it reads these classes from the generated
module. Needs the ``tokenizers`` package; the port itself never imports
it.
"""

from __future__ import annotations

import sys
import unicodedata
from pathlib import Path

from tokenizers import normalizers, pre_tokenizers

OUT = (Path(__file__).resolve().parents[1] / "audio_processor_tpu_torch"
       / "models" / "_bert_unicode.py")


def _chars():
    for cp in range(0x110000):
        if not 0xD800 <= cp <= 0xDFFF:       # surrogates are no str chars
            yield cp, chr(cp)


def classes() -> dict:
    clean = normalizers.BertNormalizer(
        clean_text=True, handle_chinese_chars=False, strip_accents=False,
        lowercase=False)
    cjk = normalizers.BertNormalizer(
        clean_text=False, handle_chinese_chars=True, strip_accents=False,
        lowercase=False)
    strip = normalizers.BertNormalizer(
        clean_text=False, handle_chinese_chars=False, strip_accents=True,
        lowercase=False)
    pre = pre_tokenizers.BertPreTokenizer()
    out = {"REMOVED": [], "WHITESPACE": [], "CHINESE": [], "MARK_NONSPACING":
           [], "PUNCTUATION": []}
    for cp, c in _chars():
        s = "a" + c + "b"
        if clean.normalize_str(s) == "ab":
            out["REMOVED"].append(cp)
        pieces = [p for p, _ in pre.pre_tokenize_str(s)]
        if pieces == ["a", "b"]:
            out["WHITESPACE"].append(cp)
        elif pieces == ["a", c, "b"]:
            out["PUNCTUATION"].append(cp)
        if cjk.normalize_str(c) == f" {c} ":
            out["CHINESE"].append(cp)
        # The mark test holds for characters NFD leaves alone: the
        # normalizer only ever asks it of NFD's output.
        if unicodedata.normalize("NFD", c) == c and \
                strip.normalize_str(s) == "ab":
            out["MARK_NONSPACING"].append(cp)
    return out


def ranges(cps):
    out = []
    for cp in cps:
        if out and out[-1][1] == cp - 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return out


def render(tables: dict) -> str:
    lines = [
        '"""Character classes of HF tokenizers\' BertNormalizer and',
        "BertPreTokenizer, as sorted inclusive code point ranges. Generated",
        "by tools/gen_bert_unicode_tables.py from the tokenizers library;",
        'do not edit."""',
        "",
    ]
    for name, cps in tables.items():
        pairs = [f"({a:#x}, {b:#x})" for a, b in ranges(cps)]
        lines.append(f"{name} = (")
        row = "   "
        for p in pairs:
            if len(row) + len(p) + 2 > 79:
                lines.append(row)
                row = "   "
            row += f" {p},"
        lines.append(row)
        lines.append(")")
    return "\n".join(lines) + "\n"


def main() -> int:
    OUT.write_text(render(classes()), encoding="utf-8")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
