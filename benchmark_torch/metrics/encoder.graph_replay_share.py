"""encoder.graph_replay_share: share (%) of the program's ``encoder.graph``
spans in the traced sweep whose ``mode`` is ``replay``. The program opens
one such span around each call of ``Wav2Vec2Bert.forward`` that may run as
a CUDA graph (a CUDA input, autograd off, no parallel groups, no remat);
``mode`` is ``capture`` on a key's first call, ``replay`` after, and
``eager`` where the capture failed. A program without the span reads
nothing. Layer: device program. Source: the program's spans (a count)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    graph = [s for s in _ps.spans(run) or () if s.name == "encoder.graph"]
    if not graph:
        return None
    replays = sum(1 for s in graph if s.attrs.get("mode") == "replay")
    return 100.0 * replays / len(graph)
