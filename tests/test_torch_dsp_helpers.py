"""The port's last DSP helpers and names against the JAX package's, on
the CPU: the matmul-DFT spectra, center=False frame counts, reflect
padding, the fbank output frame count, the float64 fbank reference,
the acoustic feature names, and the CLI's config validation."""

import numpy as np
import pytest
import torch

from audio_processor_tpu import cli as jcli
from audio_processor_tpu import config as jconfig
from audio_processor_tpu.dsp import acoustic_features as jaf
from audio_processor_tpu.dsp import fbank as jfb
from audio_processor_tpu.dsp import stft as jstft
from audio_processor_tpu_torch import cli as tcli
from audio_processor_tpu_torch import config as tconfig
from audio_processor_tpu_torch.dsp import acoustic_features as taf
from audio_processor_tpu_torch.dsp import fbank as tfb
from audio_processor_tpu_torch.dsp import stft as tstft


@pytest.mark.parametrize("frame_length,fft_length", [(400, 512),
                                                     (512, 512)])
def test_spectra_match_jax(frame_length, fft_length):
    """fp32 on both sides with other summation orders: within 1e-5 of
    the JAX spectrum's largest value (the bins near 0 carry only the
    rounding of the large ones)."""
    rng = np.random.default_rng(frame_length)
    frames = rng.standard_normal((3, 7, frame_length)).astype(np.float32)
    for ours, theirs in ((tstft.power_spectrum, jstft.power_spectrum),
                         (tstft.magnitude_spectrum,
                          jstft.magnitude_spectrum)):
        got = ours(torch.from_numpy(frames), fft_length).numpy()
        want = np.asarray(theirs(frames, fft_length))
        assert got.shape == want.shape == (3, 7, fft_length // 2 + 1)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_frame_counts_match_jax():
    lengths = np.arange(0, 5000, 37)
    for frame_length, hop in ((400, 160), (512, 160), (2048, 512)):
        for n in lengths:
            got = tstft.num_frames_nocenter(int(n), frame_length, hop)
            assert isinstance(got, int)
            assert got == jstft.num_frames_nocenter(int(n), frame_length,
                                                    hop)
        got = tstft.num_frames_nocenter(torch.from_numpy(lengths),
                                        frame_length, hop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jstft.num_frames_nocenter(lengths, frame_length, hop)))
    for n in range(0, 16000 * 26, 1601):
        assert tfb.num_output_frames(n) == jfb.num_output_frames(n)


def test_reflect_pad_matches_jax():
    rng = np.random.default_rng(1)
    for shape, pad in (((700,), 256), ((2, 3, 900), 256), ((4, 20), 7)):
        x = rng.standard_normal(shape).astype(np.float32)
        got = tstft.reflect_pad(torch.from_numpy(x), pad).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jstft.reflect_pad(x, pad)))


def test_log_mel_frontend_np_matches_jax():
    rng = np.random.default_rng(2)
    wave = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    got = tfb.log_mel_frontend_np(wave)
    assert got.dtype == np.float64 and got.shape == (98, 80)
    np.testing.assert_array_equal(got, jfb.log_mel_frontend_np(wave))


def test_feature_names_match_jax():
    assert taf.FEATURE_NAMES == jaf.FEATURE_NAMES
    assert len(taf.FEATURE_NAMES) == taf.NUM_FEATURES == 38


@pytest.mark.parametrize("bad", [
    {"input_folder": ""},
    {"overlap_sec": 30.0, "chunk_duration_sec": 25.0},
    {"chunk_batch_size": 0, "target_sample_rate": -1},
])
def test_validate_config_raises_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jcli.validate_config(jconfig.PipelineConfig(**bad))
    with pytest.raises(ValueError) as got:
        tcli.validate_config(tconfig.PipelineConfig(**bad))
    assert str(got.value) == str(want.value)
    tcli.validate_config(tconfig.PipelineConfig())
