"""The port's device resampler (dsp/resample.py ``resample``, a strided
convolution) against the JAX package's jitted ``resample`` (HIGHEST
precision) and the host ``resample_np`` (float64 accumulation), on the
CPU: telephone, CD and studio rates to 16 kHz, with leading batch dims.
Tolerance: 1e-5 absolute on unit-scale signals (fp32 sums of ~40 terms in
another order)."""

import numpy as np
import pytest
import torch

from audio_processor_tpu.dsp import resample as jres
from audio_processor_tpu_torch.dsp import resample as tres

ATOL = 1e-5


@pytest.mark.parametrize("orig, new, shape", [
    (8000, 16000, (2, 8000)), (44100, 16000, (3, 2, 44100)),
    (48000, 16000, (48000,)), (16000, 8000, (1, 16001))])
def test_resample_matches_jax_and_numpy(orig, new, shape):
    rng = np.random.default_rng(orig)
    x = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    got = tres.resample(torch.from_numpy(x), orig, new)
    want = np.asarray(jres.resample(x, orig, new))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape[-1] == tres.resampled_length(shape[-1], orig, new)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), tres.resample_np(x, orig, new),
                               rtol=0, atol=ATOL)


def test_equal_rates_are_the_identity():
    x = torch.randn(2, 100)
    assert tres.resample(x, 16000, 16000) is x
