"""The port's Wav2Vec2Bert (PyTorch) against the JAX reference on one set
of weights: JAX ``init_params`` converted with ``params_from_jax``, a
tiny config (hidden 128, 2 heads of 64, 2 layers), features from a
numpy seed with a ragged mask. The port's ``flash_rel`` is held against
the JAX ``xla`` path, its ``flash`` against the JAX ``flash`` path with
the stock Pallas kernel in interpret mode."""

import functools

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


# The JAX path each port path is held against.
JAX_IMPL = {"xla": "xla", "flash_rel": "xla", "flash": "flash"}


@pytest.fixture
def stock_flash_interpret(monkeypatch):
    """Runs the stock Pallas flash kernel (JAX ``attention_impl="flash"``)
    in interpret mode on the CPU."""
    import jax.experimental.pallas.ops.tpu.flash_attention as stock_fa

    monkeypatch.setattr(stock_fa.pl, "pallas_call", functools.partial(
        stock_fa.pl.pallas_call, interpret=True))


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


def _jax_logits(shared, dtype, impl="xla", frames=None):
    import jax.numpy as jnp

    jcfg, params, _, feats, mask = shared
    return np.asarray(jw.forward(params, jcfg,
                                 jnp.asarray(feats[:, :frames]),
                                 jnp.asarray(mask[:, :frames]), dtype=dtype,
                                 attention_impl=impl))


def _port_logits(shared, dtype, impl, frames=None):
    _, _, model, feats, mask = shared
    with torch.inference_mode():
        return model(torch.from_numpy(feats[:, :frames]),
                     torch.from_numpy(mask[:, :frames]),
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


@pytest.mark.parametrize("impl", ["xla", "flash_rel", "flash"])
def test_fp32_logits_match_jax(shared, stock_flash_interpret, impl):
    import jax.numpy as jnp

    ref = _jax_logits(shared, jnp.float32, JAX_IMPL[impl])
    got = _port_logits(shared, torch.float32, impl)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash_rel", "flash"])
def test_bf16_logits_at_bf16_rounding_scale(shared, stock_flash_interpret,
                                            impl):
    import jax.numpy as jnp

    ref = _jax_logits(shared, jnp.bfloat16, JAX_IMPL[impl])
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


@pytest.mark.parametrize("impl", ["flash_rel", "flash"])
def test_kernel_paths_run_plain_off_their_length_multiple(shared, impl):
    """L = 200 is a multiple of neither 256 (flash_rel) nor 128 (flash):
    like the reference, both take the plain path there, so the port
    equals its own ``xla`` path bit for bit and the JAX path (which
    takes its einsum path for the same reason) within FP32_ATOL."""
    import jax.numpy as jnp

    got = _port_logits(shared, torch.float32, impl, frames=200)
    np.testing.assert_array_equal(
        got, _port_logits(shared, torch.float32, "xla", frames=200))
    ref = _jax_logits(shared, jnp.float32, impl, frames=200)
    np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=0)


def test_unported_options_raise(shared):
    """An unknown attention path and an unknown param leaf raise; int8
    params (``kernel_q`` + per-channel ``scale``) now convert to the int8
    layers' ``weight_q`` [out, in] and ``scale``, while a LayerNorm's
    ``scale`` stays its ``weight``."""
    _, _, model, feats, _ = shared
    assert tw.resolve_attention_impl("flash", torch.device("cpu")) == "flash"
    with pytest.raises(ValueError, match="attention_impl"):
        model(torch.from_numpy(feats), attention_impl="flash_xla")
    kq = np.arange(6, dtype=np.int8).reshape(2, 3)
    sd = tw.params_from_jax({"feature_projection": {
        "projection": {"kernel_q": kq, "scale": np.ones(3, np.float32)},
        "layer_norm": {"scale": np.ones(2, np.float32)}},
        "lm_head": {}, "layers": {}}, tw.W2VBertConfig(**KW))
    assert sd["feature_projection.projection.weight_q"].dtype == torch.int8
    np.testing.assert_array_equal(
        sd["feature_projection.projection.weight_q"].numpy(), kq.T)
    assert set(sd) == {"feature_projection.projection.weight_q",
                       "feature_projection.projection.scale",
                       "feature_projection.layer_norm.weight"}
    with pytest.raises(ValueError, match="unexpected param"):
        tw.params_from_jax({"feature_projection": {"projection": {
            "kernel_int4": np.zeros((2, 2))}}, "lm_head": {},
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


def test_cuda_graph_rule_and_key(shared):
    """forward never captures a CUDA graph off the card, with grad on, with
    parallel groups set or with ``remat``: the graph cache stays empty and
    no ``encoder.graph`` span opens. The graph key follows the parameters'
    storage: reassigned tensors make another key, in-place updates do
    not. A copy of the model starts with an empty cache of its own."""
    import copy
    import types

    from audio_processor_tpu_torch.obs import profiler

    _, _, _, feats, mask = shared
    model = tw.build_synthetic(tw.W2VBertConfig(**KW), torch.device("cpu"))
    x, m = torch.from_numpy(feats), torch.from_numpy(mask)
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        for grad, remat in ((False, False), (True, False), (True, True)):
            with torch.set_grad_enabled(grad):
                model(x, m, attention_impl="xla", remat=remat)
        with torch.inference_mode():
            model(x, m)
        new = [s for s in profiler.spans() if s.id not in seen]
    assert not [s for s in new if s.name == "encoder.graph"]
    assert model._graphs.devices == {} and model._graphs.ptrs is None

    on_card = types.SimpleNamespace(is_cuda=True)
    assert not model.graphable(on_card)                 # grad on
    with torch.inference_mode():
        assert model.graphable(on_card) and not model.graphable(x)
        assert not model.graphable(on_card, remat=True)
        for groups in (tw.ParallelGroups(model=object()),
                       tw.ParallelGroups(seq=object())):
            model.parallel = groups
            assert not model.graphable(on_card)
        model.parallel = tw.ParallelGroups()
    with torch.no_grad():
        assert model.graphable(on_card)

    key = model.graph_key(x, m, torch.bfloat16, "flash_rel")
    assert model.graph_key(x, m, torch.float32, "flash_rel") != key
    assert model.graph_key(x, m, torch.bfloat16, "flash") != key
    assert model.graph_key(x[:1], m[:1], torch.bfloat16, "flash_rel") != key
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert model.graph_key(x, m, torch.bfloat16, "flash_rel") == key
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    moved = model.graph_key(x, m, torch.bfloat16, "flash_rel")
    assert moved[:-1] == key[:-1] and moved[-1] != key[-1]
    twin = copy.deepcopy(model)
    assert isinstance(twin._graphs, tw.GraphCache)
    assert twin._graphs is not model._graphs and twin._graphs.ptrs is None
