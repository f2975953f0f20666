"""The port's int8 W8A8 mode (models/quant.py and the int8 layers of
models/wav2vec2bert.py) against the JAX package's (models/quant.py,
``wav2vec2bert.quantize_params``), on the same numpy weights and inputs.

Tolerances: ``quantize_kernel`` is bit-equal (the same fp32 absmax,
division and round-half-even); ``dense_int8`` agrees within 1e-6 (one
int32 product, then the same fp32 rescale). Over a whole forward the
two frameworks' fp32 activations differ in their last bits (4e-7 on the
logits without int8), which can move an activation across an int8
rounding edge; so each sequence's int8 logits (all its valid frames as
one vector) are held to a cosine of at least 0.99999 with the JAX ones,
and the greedy ids to equality off near-ties (top-2 margin > 1e-3)."""

import jax
import numpy as np
import pytest
import torch

from audio_processor_tpu.models import quant as jquant
from audio_processor_tpu.models import wav2vec2bert as jw
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.models import quant
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.models.tokenizer import CTCVocab
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
from audio_processor_tpu_torch.pipeline.chunker import split_audio

KW = dict(vocab_size=40, hidden_size=128, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=256,
          conv_depthwise_kernel_size=7)
MARGIN = 1e-3
MIN_COSINE = 0.99999


@pytest.fixture(scope="module")
def weights():
    jcfg = jw.W2VBertConfig(**KW)
    params = jw.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, jw.quantize_params(params)


@pytest.mark.parametrize("shape", [(32, 48), (3, 64, 24), (16, 8)])
def test_quantize_kernel_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    k = rng.standard_normal(shape).astype(np.float32)
    k[..., 3] = 0.0                            # a zero channel: the 1e-12 floor
    k.flat[::7] *= 40.0
    jq, js = (np.asarray(a) for a in jquant.quantize_kernel(k))
    tq, ts = quant.quantize_kernel(torch.from_numpy(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("bias", [True, False])
def test_dense_int8_within_1e6(bias):
    rng = np.random.default_rng(5)
    k = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    x[0, 0] = 0.0                                   # an all-zero token
    lin = torch.nn.Linear(64, 48, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(k.T))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    jp = jquant.quantize_dense({"kernel": k, **({"bias": b} if bias else {})})
    want = np.asarray(jquant.dense_int8(jp, x))
    got = quant.dense_int8(quant.QuantLinear.from_linear(lin),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_quantize_model_is_the_reference_set_on_a_shared_copy(weights):
    jcfg, params, qparams = weights
    cfg = tw.W2VBertConfig(**KW)
    model = tw.Wav2Vec2Bert(cfg)
    model.load_state_dict(tw.params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    q = tw.quantize_model(model)
    assert tw.quantize_model(q) is q
    # The int8 model equals the reference's quantize_params, converted.
    want = tw.params_from_jax(jax.tree.map(np.asarray, qparams), cfg)
    got = q.state_dict()
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype and torch.equal(got[key], t), key
    layer = q.layers[0]
    for name in tw.QUANTIZED:
        assert isinstance(layer.get_submodule(name), quant.QuantLinear)
    for kept in (q.feature_projection.projection, q.lm_head):
        assert isinstance(kept, torch.nn.Linear)
    # The float model is untouched and shares what stays float.
    assert isinstance(model.layers[0].ffn1.intermediate_dense,
                      torch.nn.Linear)
    assert q.lm_head.weight.data_ptr() == model.lm_head.weight.data_ptr()


def test_int8_forward_matches_jax_int8(weights):
    import jax.numpy as jnp

    jcfg, _, qparams = weights
    cfg = tw.W2VBertConfig(**KW)
    with torch.device("meta"):
        model = tw.quantize_model(tw.Wav2Vec2Bert(cfg))
    model.load_state_dict(tw.params_from_jax(
        jax.tree.map(np.asarray, qparams), cfg), assign=True)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 256, 160)).astype(np.float32)
    mask = np.ones((2, 256), bool)
    mask[1, 181:] = False
    ref = np.asarray(jw.forward(qparams, jcfg, jnp.asarray(feats),
                                jnp.asarray(mask)))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    for row in range(2):
        a, b = got[row][mask[row]].ravel(), ref[row][mask[row]].ravel()
        cos = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())
        assert cos >= MIN_COSINE, (row, cos)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = ((top2[..., 1] - top2[..., 0]) > MARGIN) & mask
    assert clear.mean() > 0.4
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


def test_engine_int8_quantizes_a_given_model_and_runs(weights):
    cfg = PipelineConfig(quantization="int8", chunk_duration_sec=1.0,
                         overlap_sec=0.25, length_buckets_sec=(1.0,),
                         chunk_batch_size=2, enable_mixed_precision=False)
    vocab = CTCVocab.darija_default()
    tiny = tw.build_synthetic(tw.W2VBertConfig(**{**KW, "vocab_size":
                                                  len(vocab)}),
                              torch.device("cpu"))
    engine = ASREngine(cfg, device="cpu", model=tiny, vocab=vocab)
    assert engine.quantization == "int8"
    assert isinstance(engine.model.layers[0].self_attn.linear_q,
                      quant.QuantLinear)
    assert isinstance(tiny.layers[0].self_attn.linear_q, torch.nn.Linear)
    wave = (0.1 * np.random.default_rng(0)
            .standard_normal((2, 16000 * 2))).astype(np.float32)
    rows = engine.transcribe_chunks(split_audio(wave, 16000, "q.wav", 1.0,
                                                0.25))
    assert rows and all(r["error"] == "" for r in rows)
    with pytest.raises(ValueError, match="quantization"):
        ASREngine(PipelineConfig(quantization="fp4"), device="cpu",
                  model=tiny, vocab=vocab)
