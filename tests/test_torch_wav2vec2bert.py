"""The port's Wav2Vec2Bert (PyTorch) against the JAX reference on one set
of weights: JAX ``init_params`` converted with ``params_from_jax``, a
tiny config (hidden 128, 2 heads of 64, 2 layers), features from a
numpy seed with a ragged mask."""

import numpy as np
import pytest
import torch

from audio_processor_tpu.models import wav2vec2bert as jw
from audio_processor_tpu_torch.models import wav2vec2bert as tw

KW = dict(vocab_size=40, hidden_size=128, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=256)
# fp32 logits: same weights and math, another summation order; the
# logits are O(1), so 1e-4 absolute is ~1e-4 relative.
FP32_ATOL = 1e-4
# bf16: each side rounds activations to bf16 at its own places; allow
# 8 bf16 ulps (2^-8 relative each) of the logits' scale.
BF16_SCALE_ULPS = 8 * 2 ** -8
# Greedy ids are compared only where the JAX top-2 margin exceeds this:
# on random weights near-tied logits flip on rounding alone (ROADMAP.md).
MARGIN = 1e-3


@pytest.fixture(scope="module")
def shared():
    import jax

    jcfg = jw.W2VBertConfig(**KW)
    params = jw.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tw.W2VBertConfig(**KW)
    model = tw.Wav2Vec2Bert(tcfg)
    model.load_state_dict(tw.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 256, 160)).astype(np.float32)
    mask = np.ones((2, 256), bool)
    mask[1, 181:] = False
    return jcfg, params, model.eval(), feats, mask


def _jax_logits(shared, dtype):
    import jax.numpy as jnp

    jcfg, params, _, feats, mask = shared
    return np.asarray(jw.forward(params, jcfg, jnp.asarray(feats),
                                 jnp.asarray(mask), dtype=dtype))


def _port_logits(shared, dtype, impl):
    _, _, model, feats, mask = shared
    with torch.inference_mode():
        return model(torch.from_numpy(feats), torch.from_numpy(mask),
                     dtype=dtype, attention_impl=impl).numpy()


def test_params_from_jax_layouts(shared):
    _, params, model, _, _ = shared
    layer1 = params["layers"]
    conv = model.layers[1].conv_module
    np.testing.assert_array_equal(
        conv.depthwise_conv.weight.detach().numpy()[:, 0, :],
        np.asarray(layer1["conv_module"]["depthwise_conv"]["kernel"][1]).T)
    np.testing.assert_array_equal(
        model.layers[1].ffn1.intermediate_dense.weight.detach().numpy(),
        np.asarray(layer1["ffn1"]["intermediate_dense"]["kernel"][1]).T)
    assert conv.pointwise_conv1.bias is None
    assert model.lm_head.weight.shape == (KW["vocab_size"],
                                          KW["hidden_size"])


@pytest.mark.parametrize("impl", ["xla", "flash_rel"])
def test_fp32_logits_match_jax(shared, impl):
    import jax.numpy as jnp

    ref = _jax_logits(shared, jnp.float32)
    got = _port_logits(shared, torch.float32, impl)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash_rel"])
def test_bf16_logits_at_bf16_rounding_scale(shared, impl):
    import jax.numpy as jnp

    ref = _jax_logits(shared, jnp.bfloat16)
    got = _port_logits(shared, torch.bfloat16, impl)
    assert got.dtype == np.float32
    scale = float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= BF16_SCALE_ULPS * scale


def test_greedy_ids_match_off_near_ties(shared):
    import jax.numpy as jnp

    _, _, _, _, mask = shared
    ref = _jax_logits(shared, jnp.float32)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert clear.mean() > 0.5       # the comparison covers most frames
    jids = np.asarray(jw.greedy_ctc_ids(jnp.asarray(ref),
                                        jnp.asarray(mask)))
    tids = tw.greedy_ctc_ids(
        torch.from_numpy(_port_logits(shared, torch.float32, "flash_rel")),
        torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(tids[clear], jids[clear])
    assert (tids[~mask] == 0).all()


def test_unported_options_raise(shared):
    _, _, model, feats, _ = shared
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(torch.from_numpy(feats), attention_impl="flash")
    with pytest.raises(NotImplementedError, match="int8"):
        tw.params_from_jax({"feature_projection": {"projection": {
            "kernel_q": np.zeros((2, 2), np.int8)}}, "lm_head": {},
            "layers": {}}, tw.W2VBertConfig(**KW))


def test_synthetic_init_is_seeded():
    cfg = tw.W2VBertConfig(**{**KW, "num_hidden_layers": 1})
    a = tw.build_synthetic(cfg, torch.device("cpu"), seed=3)
    b = tw.build_synthetic(cfg, torch.device("cpu"), seed=3)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.layers[0].ffn1_layer_norm.weight,
                       torch.ones(KW["hidden_size"]))
    assert float(a.lm_head.weight.detach().std()) == pytest.approx(0.02, rel=0.1)
