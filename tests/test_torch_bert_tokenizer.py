"""The port's BERT WordPiece tokenizer against
``AutoTokenizer.from_pretrained(dir)`` on the same directories: the
``input_ids`` and ``attention_mask`` of ``tok(texts, truncation=True,
max_length=512, padding=True, return_tensors="np")`` must be equal,
exactly. The corpus is Darija as it is written (Arabic script, with and
without harakat, tatweel, Arabic punctuation and digits; Latin Arabizi
with digits) and the edges around it: Latin accents, emoji with skin
tones and joiners, CJK, control and zero-width characters, Unicode
spaces, special tokens inside the text, words over 100 characters and a
text over 512 tokens."""

import json
import shutil

import numpy as np
import pytest

from audio_processor_tpu_torch.models.bert_tokenizer import BertTokenizer

transformers = pytest.importorskip("transformers")

AR_LETTERS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهويىءآأؤإئة")
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + list("abcdefghijklmnopqrstuvwxyz0123456789")
         + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
         + AR_LETTERS + ["##" + c for c in AR_LETTERS]
         + ["salam", "labas", "bikhir", "3la", "##la", "7ta", "wakha",
            "سلام", "##ام", "عليكم", "مرحبا", "ـ", "##ـ", "١", "##٢",
            "،", "؟", ".", ",", "!", "?", "-", ":", "[", "]", "$", "+",
            "é", "##é", "à", "ç", "##ç", "中", "文", "😀", "👍", "##🏽",
            "tres", "très", "ca", "ça", "paris", "eric"])

CORPUS = [
    "Salam, labas? 3la slamtek 7ta ghda!",
    "SALAMTEK a khoya <sep2> bikhir  <sep2>  wakha<sep2>x salamtekk",
    "salam labas bikhir wakha a sidi",
    "ghadi n3ayet lik mn ba3d, wakha?",
    "السلام عليكم، كيف حالك؟",
    "السَّلَامُ عَلَيْكُمْ وَرَحْمَةُ اللهِ",
    "سلاااام ـــ مرحبـــا بيك",
    "عندي ١٢٣ درهم و 45 سنتيم",
    "Très bien, ça va à Paris. Éric!",
    "wa3er 😀😀 bzaf 👍🏽 🥰 👨‍👩‍👧 ok",
    "中文测试 mixed中文 text",
    "a\x00b\x07c\td\ne\r\x0bf​g﻿h�i\x85j",
    "a b　c d e",
    "hello [MASK] world[CLS]x [mask] [UNK]",
    "ΟΔΟΣ İstanbul ﬁn Ⓐ",
    "2024-05-17 12:30 $5+3=8 ^_^ |x| ~y~ `z`",
    "a" * 150 + " " + "بزاف" * 30 + " " + "b" * 100,
    "",
    "   ",
    " ".join(["salam"] * 300 + ["سلام"] * 300),
]


def _hf(d, texts):
    tok = transformers.AutoTokenizer.from_pretrained(d)
    return tok(texts, truncation=True, max_length=512, padding=True,
               return_tensors="np")


def _vocab_txt_dir(d, lower):
    """vocab.txt + tokenizer_config.json (+ config.json): AutoTokenizer
    converts the slow tokenizer."""
    d.mkdir()
    (d / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": lower, "tokenizer_class": "BertTokenizer"}))
    transformers.BertConfig(vocab_size=len(VOCAB)).save_pretrained(d)
    return d


def _tokenizer_json_dir(tmp, name, lower, keep_config):
    """tokenizer.json (+ tokenizer_config.json or not), no vocab.txt."""
    src = _vocab_txt_dir(tmp / (name + "_src"), lower)
    d = tmp / name
    transformers.BertTokenizerFast(str(src / "vocab.txt"),
                                   do_lower_case=lower).save_pretrained(d)
    (d / "vocab.txt").unlink()
    if not keep_config:
        for f in ("tokenizer_config.json", "special_tokens_map.json"):
            (d / f).unlink()
    shutil.copy(src / "config.json", d / "config.json")
    return d


def _added_tokens_dir(tmp):
    """tokenizer.json with added tokens beyond the specials: a normalized
    word (cut out of the normalized text) and an unnormalized marker
    that takes the spaces beside it (lstrip, rstrip)."""
    src = _vocab_txt_dir(tmp / "a_src", True)
    tok = transformers.BertTokenizerFast(str(src / "vocab.txt"))
    tok.add_tokens(["salamtek"])
    tok.add_tokens([transformers.AddedToken("<sep2>", lstrip=True,
                                            rstrip=True, normalized=False)])
    d = tmp / "a"
    tok.save_pretrained(d)
    shutil.copy(src / "config.json", d / "config.json")
    return d


DIRS = {
    "tokenizer_json_added_tokens": _added_tokens_dir,
    "vocab_txt_lowercase": lambda t: _vocab_txt_dir(t / "v_low", True),
    "vocab_txt_cased": lambda t: _vocab_txt_dir(t / "v_cased", False),
    "tokenizer_json_lowercase": lambda t: _tokenizer_json_dir(
        t, "j_low", True, False),
    # BertTokenizerFast's own default (do_lower_case=True) overrides the
    # file's lowercase=false when no tokenizer_config.json says otherwise.
    "tokenizer_json_cased_no_config": lambda t: _tokenizer_json_dir(
        t, "j_cased", False, False),
    "tokenizer_json_cased_with_config": lambda t: _tokenizer_json_dir(
        t, "j_cased_cfg", False, True),
}


@pytest.mark.parametrize("kind", sorted(DIRS))
def test_ids_and_mask_equal_autotokenizer(tmp_path, kind):
    d = DIRS[kind](tmp_path)
    want = _hf(d, CORPUS)
    got = BertTokenizer.from_pretrained(d)(CORPUS, max_length=512)
    assert got["input_ids"].dtype == want["input_ids"].dtype == np.int64
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"],
                                  want["attention_mask"])
    # Each text alone (no padding) as well.
    tok = BertTokenizer.from_pretrained(d)
    for text in CORPUS[:-1]:
        one = _hf(d, [text])
        np.testing.assert_array_equal(tok([text])["input_ids"],
                                      one["input_ids"], err_msg=repr(text))


def test_truncation_at_512_and_the_covered_edges(tmp_path):
    d = _vocab_txt_dir(tmp_path / "v", True)
    tok = BertTokenizer.from_pretrained(d)
    long = tok([CORPUS[-1]])["input_ids"][0]
    assert long.shape == (512,)
    assert long[0] == VOCAB.index("[CLS]") and long[-1] == VOCAB.index("[SEP]")
    # harakat are stripped with lowercasing; tatweel is a letter
    assert tok.tokenize_ids("سَلَام") == tok.tokenize_ids("سلام")
    assert tok.tokenize_ids("ـ") == [VOCAB.index("ـ")]
    # the Arabic comma and question mark stand alone
    assert tok.tokenize_ids("a،b؟") == [VOCAB.index(c) for c in "a،b؟"]
    # over 100 characters: one [UNK]
    assert tok.tokenize_ids("a" * 101) == [VOCAB.index("[UNK]")]
    assert tok(CORPUS)["input_ids"].tolist() == tok(CORPUS)[
        "input_ids"].tolist()


def test_other_tokenizer_models_raise(tmp_path):
    d = _tokenizer_json_dir(tmp_path, "j", True, True)
    tj = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
    tj["model"] = {"type": "BPE", "vocab": {}, "merges": []}
    (d / "tokenizer.json").write_text(json.dumps(tj), encoding="utf-8")
    with pytest.raises(ValueError, match="WordPiece"):
        BertTokenizer.from_pretrained(d)
