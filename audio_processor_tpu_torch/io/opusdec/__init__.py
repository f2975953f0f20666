"""First-party Opus decoder (RFC 6716): range decoder, SILK and CELT
codec bodies, packet/TOC parsing.

This replaces the last third-party codec dependency in the IO layer:
io/opus.py prefers system libopus (ctypes) as the fast path and falls
back to this package when the library is unavailable; the parity test
suite (tests/test_opusdec.py) holds the two within tolerance
(bit-exact for SILK-only streams, float tolerance for CELT).

Reference mechanism being replaced: the upstream stack shells out to
ffmpeg for Ogg payloads (services/audio_processor.py:76-86).
"""

from audio_processor_tpu_torch.io.opusdec.decoder import (  # noqa: F401
    OpusDecodeError, OpusDecoder)
from audio_processor_tpu_torch.io.opusdec.packet import parse_packet  # noqa: F401
