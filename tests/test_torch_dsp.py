"""The port's DSP (PyTorch fbank frontend, acoustic features, numpy
resampler) against the JAX package's functions on the same numpy
inputs, on the CPU."""

import numpy as np
import pytest
import torch

from audio_processor_tpu.dsp import acoustic_features as jaf
from audio_processor_tpu.dsp import fbank as jfb
from audio_processor_tpu.dsp.resample import resample_np as jax_resample_np
from audio_processor_tpu_torch.dsp import acoustic_features as taf
from audio_processor_tpu_torch.dsp import fbank as tfb
from audio_processor_tpu_torch.dsp.resample import resample_np

SR = 16000


def _noise_calls(seed, lengths, T):
    """Zero-padded [B, T] rows: a tone over noise, int16-exact."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    out = np.zeros((len(lengths), T), np.float32)
    for i, n in enumerate(lengths):
        x = 0.2 * np.sin(2 * np.pi * (180 + 40 * i) * t[:n]) \
            + 0.05 * rng.standard_normal(n)
        out[i, :n] = np.round(x * 32767) / 32768
    return out


def test_log_mel_frontend_matches_jax_ragged():
    """Normalized features are O(1) (a few reach ~4); fp32 on both
    sides with another summation order: atol 1e-4 plus rtol 1e-4."""
    T = 2 * SR
    lengths = np.array([T, 20000, 5000, 399], np.int32)  # last: no frame
    wave = _noise_calls(0, lengths, T)
    ref_f, ref_m = jfb.log_mel_frontend(wave, lengths)
    got_f, got_m = tfb.log_mel_frontend(torch.from_numpy(wave),
                                        torch.from_numpy(lengths))
    assert got_f.shape == ref_f.shape == (4, 99, 160)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f),
                               atol=1e-4, rtol=1e-4)


def test_acoustic_features_match_jax():
    """Features span many scales (Hz, dB, BPM), so compare relative to
    max(|ref|, 1) at 1e-4. A single frame makes the ddof=1 stds 0/0:
    NaN in the port (torch semantics); XLA's division may give inf or
    NaN there, so those entries are compared as non-finite. Audio
    shorter than a frame must give all-zero rows on both sides."""
    T = 3 * SR
    lengths = np.array([T, 30000, 9000, 400, 300], np.int32)
    waves = list(_noise_calls(1, lengths, T))
    buf, lens = taf.prepare_reflect_padded(
        [w[:n] for w, n in zip(waves, lengths)], T)
    jbuf, jlens = jaf.prepare_reflect_padded(
        [w[:n] for w, n in zip(waves, lengths)], T)
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(lens, jlens)
    ref = np.asarray(jaf.extract_features_batch(buf, lens))
    got = taf.extract_features_batch(torch.from_numpy(buf),
                                     torch.from_numpy(lens)).numpy()
    assert got.shape == (5, taf.NUM_FEATURES)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isnan(got[3, [1, 4]]).all()  # one frame: rms/zcr std NaN
    assert np.isfinite(got[:3]).all()
    np.testing.assert_array_equal(got[4], 0.0)
    ok = np.isfinite(ref)
    scale = np.maximum(np.abs(ref[ok]), 1.0)
    np.testing.assert_allclose(got[ok] / scale, ref[ok] / scale,
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("orig", [8000, 44100])
def test_resample_np_matches_jax(orig):
    """The same float64 numpy algorithm: equal to float32 rounding."""
    rng = np.random.default_rng(orig)
    x = rng.standard_normal((2, orig // 10)).astype(np.float32)
    got = resample_np(x, orig, SR)
    ref = jax_resample_np(x, orig, SR)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
