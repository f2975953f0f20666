"""Loading HF checkpoints without ``transformers`` (models/hf_files.py,
models/convert_hf.py, models/checkpoint.py, the engine's checkpoint
branch) against the libraries and the JAX package's loaders:

- the safetensors reader equals ``safetensors``' own loaders, dtype and
  value, for F32, F16, BF16, I64 and I32 (and F64, I16, I8, U8, BOOL);
- single, sharded and ``.bin`` directories written by ``save_pretrained``
  read back as the model's state dict (fp16 upcast to fp32);
- ``W2VBertConfig.from_hf`` and the CTC vocab equal the JAX loader's;
- logits of a saved tiny ``Wav2Vec2BertForCTC`` through the port equal
  JAX's ``load_or_convert_w2v_bert`` + ``forward`` within 1e-4 (fp32, the
  tolerance of tests/test_torch_wav2vec2bert.py);
- the ``torch_converted/`` cache restores bit for bit, a corrupt cache is
  reconverted, and a cache that cannot be written is a warning."""

import dataclasses
import json
import logging
import shutil

import numpy as np
import pytest
import torch

from audio_processor_tpu.models import checkpoint as jckpt
from audio_processor_tpu.models import wav2vec2bert as jw
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.models import checkpoint as tckpt
from audio_processor_tpu_torch.models import convert_hf as tconvert
from audio_processor_tpu_torch.models import hf_files
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

from tests.test_asr_engine import VOCAB
from tests.test_wav2vec2bert import tiny_hf_model

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")
FP32_ATOL = 1e-4


def _save_w2v(d, with_vocab=True, **save_kw):
    model, hf_cfg = tiny_hf_model(vocab_size=32, seed=1)
    model.save_pretrained(d, **save_kw)
    if with_vocab:
        (d / "vocab.json").write_text(json.dumps(VOCAB))
        transformers.Wav2Vec2CTCTokenizer(
            str(d / "vocab.json"), pad_token="<pad>",
            word_delimiter_token="|").save_pretrained(d)
    return model, hf_cfg


@pytest.fixture(scope="module")
def w2v_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("w2v_hf")
    model, hf_cfg = _save_w2v(d)
    return d, model, hf_cfg


def test_safetensors_reader_matches_the_library(tmp_path):
    import safetensors.numpy

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i64": torch.arange(-5, 5).reshape(2, 5),
        "i32": torch.arange(6, dtype=torch.int32),
        "f64": torch.randn(4, generator=g, dtype=torch.float64),
        "i16": torch.arange(-3, 3, dtype=torch.int16),
        "i8": torch.arange(-4, 4, dtype=torch.int8),
        "u8": torch.arange(8, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
    }
    path = tmp_path / "t.safetensors"
    safetensors_torch.save_file(tensors, str(path), metadata={"format": "pt"})
    got = hf_files.read_safetensors(path)
    want = safetensors_torch.load_file(str(path))
    assert set(got) == set(want) == set(tensors)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    for k, arr in safetensors.numpy.load_file(str(path)).items():
        if got[k].dtype == torch.bfloat16:     # numpy has no bfloat16
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          arr.view(np.int16))
        else:
            np.testing.assert_array_equal(got[k].numpy(), arr)


@pytest.mark.parametrize("layout", ["single", "sharded", "bin", "sharded_bin",
                                    "fp16"])
def test_read_state_dict_of_save_pretrained(tmp_path, layout):
    model, _ = tiny_hf_model(vocab_size=32, seed=2)
    if layout == "fp16":
        model = model.half()
    kw = {"single": {}, "sharded": {"max_shard_size": "200KB"},
          "bin": {"safe_serialization": False},
          "sharded_bin": {"safe_serialization": False,
                          "max_shard_size": "200KB"},
          "fp16": {}}[layout]
    model.save_pretrained(tmp_path, **kw)
    files = sorted(p.name for p in tmp_path.iterdir())
    if layout.startswith("sharded"):
        assert any(f.endswith(".index.json") for f in files), files
    got = hf_files.read_state_dict(tmp_path)
    want = model.state_dict()
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], t.float()), k


def test_legacy_layernorm_keys_and_position_ids(tmp_path):
    hf = transformers.BertForSequenceClassification(transformers.BertConfig(
        vocab_size=50, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32))
    sd = hf.state_dict()
    legacy = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
              .replace("LayerNorm.bias", "LayerNorm.beta"): v
              for k, v in sd.items()}
    legacy["bert.embeddings.position_ids"] = torch.arange(32)[None]
    torch.save(legacy, tmp_path / "pytorch_model.bin")
    got = hf_files.read_state_dict(tmp_path)
    assert "bert.embeddings.position_ids" not in got
    want = tconvert.convert_bert_classifier(sd, 1)
    conv = tconvert.convert_bert_classifier(got, 1)
    assert set(conv) == set(want)
    assert all(torch.equal(conv[k], want[k]) for k in want)


def test_config_and_vocab_equal_the_jax_loader(w2v_dir, tmp_path):
    from audio_processor_tpu.models.convert_hf import (
        load_w2v_bert_from_pretrained,
    )

    d, _, hf_cfg = w2v_dir
    jparams, jcfg, jvocab = load_w2v_bert_from_pretrained(str(d))
    cfg, sd, vocab = tconvert.load_w2v_bert_from_pretrained(d)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tw.W2VBertConfig.from_hf(
        hf_cfg.to_dict())) == dataclasses.asdict(jw.W2VBertConfig.from_hf(
            hf_cfg))
    assert vocab == jvocab and len(vocab) > len(VOCAB) - 1
    # No tokenizer files: no vocab, on both sides.
    bare = tmp_path / "bare"
    _save_w2v(bare, with_vocab=False)
    assert tconvert.load_w2v_bert_from_pretrained(bare)[2] is None
    assert load_w2v_bert_from_pretrained(str(bare))[2] is None
    # The converted dict holds exactly the port's model's tensors.
    assert set(sd) == set(tw.Wav2Vec2Bert(cfg).state_dict())
    assert sd["layers.0.conv_module.pointwise_conv1.weight"].shape == (128, 64)


def test_ctc_vocab_equals_the_tokenizer_library(tmp_path):
    """``read_ctc_vocab`` against ``Wav2Vec2CTCTokenizer.get_vocab()``:
    a bare vocab.json, one saved with its tokenizer files, specials
    missing from the vocab (appended at the next id), added tokens, and
    specials of other names."""
    from audio_processor_tpu_torch.models.tokenizer import CTCVocab

    darija = CTCVocab.darija_default().vocab
    small = {"<pad>": 0, "a": 1, "b": 2}
    cases = [(darija, None), (darija, {}), (small, None),
             (small, {"pad_token": "<pad>"}), (small, {"added": ["xyz", "q"]}),
             ({"[PAD]": 0, "a": 1}, {"pad_token": "[PAD]",
                                     "unk_token": "[UNK]", "bos_token": None,
                                     "eos_token": None})]
    for i, (vocab, save) in enumerate(cases):
        d = tmp_path / f"v{i}"
        d.mkdir()
        (d / "vocab.json").write_text(json.dumps(vocab))
        if save is not None:
            added = save.pop("added", None)
            tok = transformers.Wav2Vec2CTCTokenizer(str(d / "vocab.json"),
                                                    **save)
            if added:
                tok.add_tokens(added)
            tok.save_pretrained(d)
        want = transformers.Wav2Vec2CTCTokenizer.from_pretrained(
            d).get_vocab()
        assert tconvert.read_ctc_vocab(d) == want, (i, sorted(
            p.name for p in d.iterdir()))


def test_logits_equal_jax_load_or_convert(w2v_dir, tmp_path):
    import jax.numpy as jnp

    d, _, _ = w2v_dir
    jdir = tmp_path / "jax_copy"
    shutil.copytree(d, jdir)
    jparams, jcfg, _ = jckpt.load_or_convert_w2v_bert(jdir)
    cfg, sd, _ = tckpt.load_or_convert_w2v_bert(d)
    model = tw.Wav2Vec2Bert(cfg)
    model.load_state_dict(sd)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 200, 160)).astype(np.float32)
    mask = np.ones((2, 200), bool)
    mask[1, 150:] = False
    ref = np.asarray(jw.forward(jparams, jcfg, jnp.asarray(feats),
                                jnp.asarray(mask)))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(mask),
                    attention_impl="xla").numpy()
    np.testing.assert_allclose(got[mask], ref[mask], atol=FP32_ATOL, rtol=0)


def test_cache_round_trip_and_corrupt_cache(tmp_path, monkeypatch, caplog):
    d = tmp_path / "hf"
    _save_w2v(d)
    cfg1, sd1, vocab1 = tckpt.load_or_convert_w2v_bert(d)
    cache = tckpt.cache_dir_for(d)
    assert cache.name == "torch_converted"
    assert (cache / tckpt.PARAMS_FILE).exists()

    def boom(*a, **k):
        raise AssertionError("should restore from the cache")

    with monkeypatch.context() as m:
        m.setattr(tckpt, "load_w2v_bert_from_pretrained", boom)
        cfg2, sd2, vocab2 = tckpt.load_or_convert_w2v_bert(d)
    assert (cfg2, vocab2) == (cfg1, vocab1)
    assert set(sd2) == set(sd1)
    for k in sd1:
        assert sd2[k].dtype == sd1[k].dtype and torch.equal(sd2[k], sd1[k]), k

    # A corrupt cache is reconverted, with a warning, and rewritten.
    (cache / tckpt.PARAMS_FILE).write_bytes(b"not a checkpoint")
    with caplog.at_level(logging.WARNING):
        cfg3, sd3, _ = tckpt.load_or_convert_w2v_bert(d)
    assert "reconverting" in caplog.text
    assert cfg3 == cfg1 and all(torch.equal(sd3[k], sd1[k]) for k in sd1)
    assert set(tckpt.load_params(cache)[0]) == set(sd1)

    # A cache that cannot be written is a warning, not an error.
    shutil.rmtree(cache)

    def no_write(*a, **k):
        raise OSError("read-only")

    monkeypatch.setattr(tckpt, "save_params", no_write)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        cfg4, _, _ = tckpt.load_or_convert_w2v_bert(d)
    assert cfg4 == cfg1 and "Could not write param cache" in caplog.text


def test_engine_loads_the_checkpoint(w2v_dir):
    d, _, _ = w2v_dir
    cfg = PipelineConfig(transcription_model=str(d),
                         enable_mixed_precision=False, chunk_batch_size=2,
                         length_buckets_sec=(2.0, 4.0))
    engine = ASREngine(cfg, device="cpu")
    _, sd, _ = tckpt.load_or_convert_w2v_bert(d)
    got = engine.model.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert engine.vocab.vocab == tconvert.read_ctc_vocab(d)
    assert engine.model_cfg.num_hidden_layers == 3
