"""The port's own copy of the host I/O and configuration code against the
JAX package's: the same seeded signal decodes to identical arrays and
rates through both ``load_audio``s, and ``PipelineConfig.from_dict``
gives the same fields."""

import dataclasses

import numpy as np
import pytest

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.io import decode as jdecode
from audio_processor_tpu_torch import config as tconfig
from audio_processor_tpu_torch.io import decode as tdecode
from audio_processor_tpu_torch.io import wav as twav


def _signal(sr, dur=1.5, seed=0):
    """A stereo tone over noise, int16-exact."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * dur)) / sr
    x = 0.05 * rng.standard_normal((2, t.size))
    x[0] += 0.3 * np.sin(2 * np.pi * 220 * t)
    x[1] += 0.3 * np.sin(2 * np.pi * 330 * t)
    return np.round(x * 32767).astype(np.int16)


def _write_wav(path, sr):
    twav.write(path, _signal(sr).astype(np.float32) / 32768.0, sr)


def _write_flac(path, sr):
    from tests.flac_encoder import encode_flac

    path.write_bytes(encode_flac(_signal(sr, seed=1).T.astype(np.int32),
                                 sr, 16))


def _write_ogg_flac(path, sr):
    from tests.flac_encoder import encode_ogg_flac

    path.write_bytes(encode_ogg_flac(_signal(sr, seed=2).T.astype(np.int32),
                                     sr, 16))


def _write_vorbis(path, sr):
    from tests.vorbis_encoder import make_stereo_stream

    path.write_bytes(make_stereo_stream(n_packets=24, seed=5))


@pytest.mark.parametrize("name, writer, sr", [
    ("call.wav", _write_wav, 16000),
    ("call8k.wav", _write_wav, 8000),
    ("call.flac", _write_flac, 16000),
    ("call_flac.ogg", _write_ogg_flac, 16000),
    ("call.ogg", _write_vorbis, 44100),
])
def test_load_audio_equals_reference(tmp_path, name, writer, sr):
    path = tmp_path / name
    writer(path, sr)
    want, want_sr = jdecode.load_audio(path)
    got, got_sr = tdecode.load_audio(path)
    assert got_sr == want_sr
    assert got.dtype == want.dtype and got.shape == want.shape
    assert want.shape[-1] > 0
    np.testing.assert_array_equal(got, want)


def test_pipeline_config_from_dict_equals_reference():
    raw = {"chunk_duration_sec": 10.0, "overlap_sec": 0.5,
           "length_buckets_sec": [5.0, 10.0], "chunk_batch_size": 12,
           "attention_impl": "flash", "enable_mixed_precision": False,
           "save_csv_results": True, "input_folder": "/data/in",
           "minio": {"enabled": True, "endpoint": "minio:9000",
                     "bucket_name": "calls", "unknown": 1},
           "a_key_of_no_field": 3}
    for d in ({}, raw):
        got = tconfig.PipelineConfig.from_dict(d)
        want = jconfig.PipelineConfig.from_dict(d)
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names
        for n in names:
            g, w = getattr(got, n), getattr(want, n)
            if dataclasses.is_dataclass(w):
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, n
        assert got.to_dict() == want.to_dict()
