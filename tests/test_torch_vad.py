"""The port's VAD (models/vad.py, PyTorch on the CPU) against the JAX
package's: the PyanNet forward through ``params_from_jax`` and through
``convert_pyannet`` of one pyannote-layout state dict, the windowed
probabilities on the int16 and the f32 wire, the frame-count helpers,
the energy detector with ragged lengths, and ``binarize``. Tolerances
are the JAX oracle's own (tests/test_vad_parity.py): fp32 forward atol
2e-5 / rtol 1e-4, windowed probabilities atol 3e-5 / rtol 1e-4."""

import jax
import numpy as np
import pytest
import torch

from audio_processor_tpu.models import vad as jv
from audio_processor_tpu_torch.models import vad as tv

from tests.test_vad_parity import _PyanNet

SR = 16000
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
WIN_TOL = dict(atol=3e-5, rtol=1e-4)


def _jax_tree(seed=0, **kw):
    """A JAX PyanNet tree with the affine norms and biases pushed away
    from identity/zero, so a converter that drops one fails loudly."""
    cfg = jv.PyanNetConfig(**kw)
    tree = jax.tree.map(np.asarray, jv.init_pyannet(
        jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("wav_norm", "norm0", "norm1", "norm2"):
        for k in ("scale", "bias"):
            tree[name][k] = tree[name][k] + 0.3 * rng.standard_normal(
                tree[name][k].shape).astype(np.float32)
    for layer in tree["lstm"]:
        for d in layer.values():
            d["b"] = 0.1 * rng.standard_normal(d["b"].shape).astype(
                np.float32)
    tree["classifier"]["bias"] = np.full_like(
        tree["classifier"]["bias"], 0.2)
    return cfg, tree


def _port(tree, **kw) -> tv.PyanNet:
    cfg = tv.PyanNetConfig(**kw)
    model = tv.PyanNet(cfg)
    model.load_state_dict(tv.params_from_jax(tree, cfg))
    return model.eval()


@pytest.fixture(scope="module")
def pyannote_sd():
    """A pyannote-layout PyanNet state dict (num_outputs=3) from the JAX
    parity test's oracle, norms pushed away from identity."""
    torch.manual_seed(0)
    oracle = _PyanNet(num_outputs=3)
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if "norm1d" in name:
                p.add_(0.3 * torch.randn_like(p))
    return oracle.state_dict()


def _speechy(rng, seconds):
    """Noise with a 280 Hz tone over its second quarter."""
    n = int(seconds * SR)
    wav = (0.05 * rng.standard_normal(n)).astype(np.float32)
    wav[n // 4:n // 2] += np.sin(
        2 * np.pi * 280 * np.arange(n // 2 - n // 4) / SR).astype(np.float32)
    return wav


def test_pyannet_matches_jax_forward():
    cfg, tree = _jax_tree(num_outputs=3)
    model = _port(tree, num_outputs=3)
    wav = _speechy(np.random.default_rng(1), 2.0).reshape(2, SR)
    want = np.asarray(jv.pyannet_forward(tree, cfg, wav))
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
        got16 = model(torch.from_numpy(np.round(wav * 32768).clip(
            -32768, 32767).astype(np.int16))).numpy()
    assert got.shape == want.shape == (2, tv.pyannet_num_frames(
        model.cfg, SR))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    want16 = np.asarray(jv.pyannet_forward(tree, cfg, np.round(
        wav * 32768).clip(-32768, 32767).astype(np.int16)))
    np.testing.assert_allclose(got16, want16, **FWD_TOL)


def test_convert_pyannet_matches_jax(pyannote_sd):
    """One pyannote state dict through both converters gives the same
    probabilities; the two LSTM biases sit summed in ``bias_ih``."""
    jcfg = jv.PyanNetConfig(num_outputs=3)
    tcfg = tv.PyanNetConfig(num_outputs=3)
    sd = tv.convert_pyannet(pyannote_sd, tcfg)
    np.testing.assert_array_equal(
        sd["lstm.bias_ih_l1_reverse"].numpy(),
        (pyannote_sd["lstm.bias_ih_l1_reverse"]
         + pyannote_sd["lstm.bias_hh_l1_reverse"]).numpy())
    assert not sd["lstm.bias_hh_l0"].any()
    model = tv.PyanNet(tcfg)
    model.load_state_dict(sd)
    model.eval()
    wav = _speechy(np.random.default_rng(2), 3.0).reshape(3, SR)
    want = np.asarray(jv.pyannet_forward(
        jv.convert_pyannet(pyannote_sd, jcfg), jcfg, wav))
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("wire", ["int16", "f32"])
def test_windowed_probs_match_jax(wire, monkeypatch):
    """13.3 s (4 full steps + an unaligned tail; crosses a sub-batch
    boundary at batch_rows=4), PCM16-exact samples: the int16 wire
    engages unless refused, and gives the f32 wire's probabilities bit
    for bit."""
    cfg, tree = _jax_tree(seed=3, num_outputs=3)
    model = _port(tree, num_outputs=3)
    pcm = np.round(_speechy(np.random.default_rng(3), 13.3) * 16384)
    wav = (pcm.astype(np.int16).astype(np.float32) / 32768.0)
    seen = []
    real = tv.upload
    monkeypatch.setattr(tv, "upload",
                        lambda x, d: seen.append(x.dtype) or real(x, d))
    kw = dict(window_sec=5.0, step_sec=2.5, batch_rows=4,
              int16_wire=None if wire == "int16" else False)
    got = tv.pyannet_probs_windowed(model, wav, **kw)
    want = jv.pyannet_probs_windowed(tree, cfg, wav, **kw)
    assert seen == [np.int16 if wire == "int16" else np.float32]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **WIN_TOL)
    other = tv.pyannet_probs_windowed(           # the other wire
        model, wav, **{**kw, "int16_wire": {"int16": False,
                                            "f32": None}[wire]})
    np.testing.assert_array_equal(got, other)


def test_frame_helpers_match_jax():
    for kw in ({}, {"sample_rate": 8000, "pool": 2, "conv_kernel": 3}):
        jcfg, tcfg = jv.PyanNetConfig(**kw), tv.PyanNetConfig(**kw)
        assert tv.pyannet_frame_hop_sec(tcfg) == jv.pyannet_frame_hop_sec(
            jcfg)
        assert tv.pyannet_frame_hop_samples(tcfg) == \
            jv.pyannet_frame_hop_samples(jcfg)
        for n in (0, 250, 251, 300, 16000, 80000, 80001, 1234567):
            assert tv.pyannet_num_frames(tcfg, n) == jv.pyannet_num_frames(
                jcfg, n)


def test_sinc_filters_match_jax():
    low = np.linspace(30.0, 7000.0, 80).astype(np.float32)
    band = np.linspace(60.0, 500.0, 80).astype(np.float32)
    want = np.asarray(jv.sinc_filters(low, band, 251, SR))
    got = tv.sinc_filters(torch.from_numpy(low), torch.from_numpy(band),
                          251, SR).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_energy_vad_ragged_lengths_match_jax():
    """Three rows of one padded batch with their own valid lengths (one
    shorter than a frame): probabilities and masks equal the JAX
    detector's (the p95 over the masked RMS row, zeros included)."""
    rng = np.random.default_rng(4)
    x = (0.01 * rng.standard_normal((3, 6 * SR))).astype(np.float32)
    t = np.arange(SR) / SR
    x[0, SR:2 * SR] += 0.5 * np.sin(2 * np.pi * 300 * t)
    x[1, 3 * SR:4 * SR] += 0.2 * np.sin(2 * np.pi * 200 * t)
    lengths = np.array([6 * SR, 4 * SR + 123, 300], np.int32)
    x[1, lengths[1]:] = 0.0
    x[2, lengths[2]:] = 0.0
    jp, jm = (np.asarray(a) for a in jv.energy_vad_probs(x, lengths))
    tp, tm = tv.energy_vad_probs(torch.from_numpy(x),
                                 torch.from_numpy(lengths))
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6, rtol=1e-5)
    assert jm[2].sum() == 0 and jm[1].sum() < jm[0].sum()
    # A row shorter than one frame gives empty outputs on both sides.
    ep, em = tv.energy_vad_probs(torch.zeros(1, 100),
                                 torch.tensor([100]))
    assert ep.shape == em.shape == (1, 0)


def test_binarize_matches_jax():
    """Symmetric, hysteresis and inverted (onset < offset) bands, with
    and without the min durations, on random probabilities."""
    rng = np.random.default_rng(5)
    hop = 0.016875
    for trial in range(40):
        probs = rng.uniform(0, 1, int(rng.integers(0, 300)))
        probs[: len(probs) // 3] = np.repeat(rng.uniform(0, 1), len(
            probs) // 3)
        onset = float(rng.uniform(0.1, 0.9))
        offset = float(rng.uniform(0.1, 0.9))     # either order
        kw = dict(onset=onset, offset=offset,
                  min_duration_on=float(rng.choice([0.0, 0.05])),
                  min_duration_off=float(rng.choice([0.0, 0.04])))
        assert tv.binarize(probs, hop, **kw) == jv.binarize(
            probs, hop, **kw), (trial, kw)
    probs = np.array([0.1] * 10 + [0.9] * 10 + [0.1] * 5 + [0.9] * 3
                     + [0.1] * 10)
    assert len(tv.binarize(probs, 0.01, min_duration_off=0.1)) == 1
    assert len(tv.binarize(probs, 0.01, min_duration_on=0.05)) == 1
    assert tv.binarize(np.full(6, 0.5), hop, onset=0.4, offset=0.6) == \
        jv.binarize(np.full(6, 0.5), hop, onset=0.4, offset=0.6)


def test_true_fp32_guard():
    """On a CUDA device the forward turns cuDNN's TF32 off while it runs
    and restores it after, and refuses TF32 matmuls; on the CPU it
    touches nothing."""
    cuda = torch.device("cuda")
    before = torch.backends.cudnn.allow_tf32
    matmul_before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tv._true_fp32(cuda):
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
        with tv._true_fp32(torch.device("cpu")):
            assert torch.backends.cudnn.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            with tv._true_fp32(cuda):
                pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_before
        torch.backends.cudnn.allow_tf32 = before
