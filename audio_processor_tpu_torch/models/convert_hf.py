"""HF checkpoints -> the port's models (port of models/convert_hf.py).

The port's modules are named as HF's (``ffn1.intermediate_dense``,
``self_attn.linear_q``, ``attention.self.query`` ...), so a conversion
picks the keys the model has, renames the few that differ and checks
every shape; it needs neither ``transformers`` nor ``safetensors``
(models/hf_files.py reads the files).

- :func:`convert_w2v_bert_ctc`: ``Wav2Vec2BertForCTC`` -> ``Wav2Vec2Bert``;
- :func:`load_w2v_bert_from_pretrained`: a checkpoint directory ->
  (config, state dict, CTC vocab);
- :func:`convert_bert_classifier`: ``BertForSequenceClassification`` ->
  ``bert.BertForSequenceClassification`` (the same keys).

Keys the port's models lack (``masked_spec_embed``, an adapter's) are
dropped, as the reference's converter drops them; a key they need and the
checkpoint lacks raises KeyError, as there.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from audio_processor_tpu_torch.models.hf_files import (
    read_config, read_json, read_state_dict, special_token,
)
from audio_processor_tpu_torch.models.wav2vec2bert import (
    W2VBertConfig, Wav2Vec2Bert,
)

StateDict = Dict[str, torch.Tensor]


def _hf_w2v_key(key: str) -> str:
    """The HF ``Wav2Vec2BertForCTC`` key of a ``Wav2Vec2Bert`` key."""
    if key.startswith("layers."):
        key = "encoder." + key
    if key.endswith("distance_embedding"):
        key += ".weight"
    return key if key.startswith("lm_head.") else "wav2vec2_bert." + key


def convert_w2v_bert_ctc(sd: StateDict, cfg: W2VBertConfig) -> StateDict:
    """HF ``Wav2Vec2BertForCTC`` state dict -> :class:`Wav2Vec2Bert`'s:
    ``wav2vec2_bert.(encoder.)`` stripped, the relative-position table's
    ``.weight`` dropped, the 1x1 pointwise convs ``[out, in, 1]`` ->
    linear ``[out, in]``; the depthwise conv stays ``[H, 1, K]``."""
    with torch.device("meta"):
        want = Wav2Vec2Bert(cfg).state_dict()
    out = {}
    for key, like in want.items():
        t = sd[_hf_w2v_key(key)]
        if ".pointwise_conv" in key and t.dim() == 3:
            t = t.squeeze(-1)
        if t.shape != like.shape:
            raise ValueError(f"{_hf_w2v_key(key)}: shape {tuple(t.shape)}, "
                             f"the model needs {tuple(like.shape)}")
        out[key] = t
    return out


def read_ctc_vocab(model_dir: str | Path) -> Optional[Dict[str, int]]:
    """What ``Wav2Vec2CTCTokenizer.from_pretrained(dir).get_vocab()``
    gives, or None where the directory has no ``vocab.json``: its dict
    (the ``target_lang`` entry of a nested one), then the added tokens of
    ``tokenizer_config.json``'s ``added_tokens_decoder`` and
    ``added_tokens.json``, then each special token (bos, eos, unk, pad, in
    that order) that is still missing, at the next id."""
    d = Path(model_dir)
    if not (d / "vocab.json").exists():
        return None
    tc = (read_json(d / "tokenizer_config.json")
          if (d / "tokenizer_config.json").exists() else {})
    stm = (read_json(d / "special_tokens_map.json")
           if (d / "special_tokens_map.json").exists() else {})
    vocab = read_json(d / "vocab.json")
    if tc.get("target_lang"):
        vocab = vocab[tc["target_lang"]]
    vocab = dict(vocab)
    added = {tok["content"]: int(i)
             for i, tok in tc.get("added_tokens_decoder", {}).items()}
    if (d / "added_tokens.json").exists():
        for tok, i in read_json(d / "added_tokens.json").items():
            added.setdefault(tok, int(i))
    vocab.update(added)
    defaults = {"bos_token": "<s>", "eos_token": "</s>",
                "unk_token": "<unk>", "pad_token": "<pad>"}
    for attr, default in defaults.items():
        tok = special_token(tc[attr] if attr in tc else stm.get(attr, default))
        if tok is not None and tok not in vocab:
            vocab[tok] = len(vocab)
    return vocab


def load_w2v_bert_from_pretrained(model_dir: str | Path
                                  ) -> Tuple[W2VBertConfig, StateDict,
                                             Optional[Dict[str, int]]]:
    """An HF ``Wav2Vec2BertForCTC`` directory -> (config, the port's
    state dict as fp32 CPU tensors, CTC vocab or None)."""
    cfg = W2VBertConfig.from_hf(read_config(model_dir))
    sd = convert_w2v_bert_ctc(read_state_dict(model_dir), cfg)
    return cfg, sd, read_ctc_vocab(model_dir)


def _bert_classifier_keys(num_layers: int):
    """Every key of ``BertForSequenceClassification`` that the forward
    uses, in HF's names."""
    keys = [f"bert.embeddings.{e}_embeddings.weight"
            for e in ("word", "position", "token_type")]
    keys += [f"bert.embeddings.LayerNorm.{w}" for w in ("weight", "bias")]
    for i in range(num_layers):
        p = f"bert.encoder.layer.{i}"
        for lin in ("attention.self.query", "attention.self.key",
                    "attention.self.value", "attention.output.dense",
                    "attention.output.LayerNorm", "intermediate.dense",
                    "output.dense", "output.LayerNorm"):
            keys += [f"{p}.{lin}.weight", f"{p}.{lin}.bias"]
    keys += ["bert.pooler.dense.weight", "bert.pooler.dense.bias",
             "classifier.weight", "classifier.bias"]
    return keys


def convert_bert_classifier(sd: StateDict, num_layers: int) -> StateDict:
    """HF ``BertForSequenceClassification`` state dict -> the port's (the
    same names; unused keys dropped, fp32)."""
    return {k: sd[k].float() for k in _bert_classifier_keys(num_layers)}
