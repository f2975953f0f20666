"""The port's BERT classifier (models/bert.py) against the JAX one
(``bert.forward``) on the same weights: a tiny HF
``BertForSequenceClassification`` converted by both packages'
``convert_bert_classifier`` (and by the port's ``params_from_jax`` from
the JAX tree), fp32, with and without padding, held to the tolerance of
tests/test_bert.py (atol 2e-5, rtol 1e-4). The int8 classifier is held
against JAX's ``quantize_params`` path: the same int8 weights bit for
bit, and softmax probabilities within 1e-4 (a per-token activation scale
may round one int8 value the other way)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from audio_processor_tpu.models import bert as jbert
from audio_processor_tpu.models import convert_hf as jconvert
from audio_processor_tpu_torch.models import bert as tbert
from audio_processor_tpu_torch.models import convert_hf as tconvert
from audio_processor_tpu_torch.models import quant

transformers = pytest.importorskip("transformers")

ATOL, RTOL = 2e-5, 1e-4
INT8_PROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    hf_cfg = transformers.BertConfig(
        vocab_size=100, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, num_labels=4,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        classifier_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.BertForSequenceClassification(hf_cfg).eval()
    d = tmp_path_factory.mktemp("bert")
    hf.save_pretrained(d)
    jcfg = jbert.BertConfig.from_hf(hf_cfg)
    jparams = jconvert.convert_bert_classifier(hf.state_dict(), 3)
    tcfg = tbert.BertConfig.from_hf(json.loads((d / "config.json")
                                               .read_text()))
    model = tbert.BertForSequenceClassification(tcfg)
    model.load_state_dict(tbert.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg))
    return hf, jcfg, jparams, tcfg, model.eval()


def _inputs(rng, padded):
    B, L = 3, 24
    ids = rng.integers(5, 100, (B, L))
    mask = np.ones((B, L), np.float32)
    if padded:
        mask[1, 10:] = 0
        mask[2, 4:] = 0
        ids[mask == 0] = 0
    return ids, mask


def test_config_from_hf_equals_jax(models):
    _, jcfg, _, tcfg, _ = models
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tbert.BertConfig.from_hf({}) == tbert.BertConfig(num_labels=2)
    assert tbert.BertConfig.from_hf({"num_labels": 3}).num_labels == 3


def test_params_from_jax_equals_the_port_conversion(models):
    hf, _, _, _, model = models
    want = tconvert.convert_bert_classifier(hf.state_dict(), 3)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key


@pytest.mark.parametrize("padded", [False, True])
def test_logits_match_jax(models, padded):
    _, jcfg, jparams, _, model = models
    ids, mask = _inputs(np.random.default_rng(int(padded)), padded)
    ref = np.asarray(jbert.forward(jparams, jcfg, ids, mask))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_int8_matches_jax_quantize_params(models):
    _, jcfg, jparams, tcfg, model = models
    jq = jbert.quantize_params(jparams)
    q = tbert.quantize_model(model)
    want = tbert.params_from_jax(jax.tree.map(np.asarray, jq), tcfg)
    got = q.state_dict()
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype and torch.equal(got[key], t), key
    layer = q.bert["encoder"]["layer"][0]
    for name in tbert.QUANTIZED:
        assert isinstance(layer.get_submodule(name), quant.QuantLinear)
    assert isinstance(q.classifier, torch.nn.Linear)
    assert isinstance(q.bert["pooler"]["dense"], torch.nn.Linear)
    ids, mask = _inputs(np.random.default_rng(2), True)
    ref = np.asarray(jax.nn.softmax(jbert.forward(jq, jcfg, ids, mask), -1))
    with torch.inference_mode():
        got = torch.softmax(q(torch.from_numpy(ids), torch.from_numpy(mask)),
                            -1).numpy()
    np.testing.assert_allclose(got, ref, atol=INT8_PROB_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
