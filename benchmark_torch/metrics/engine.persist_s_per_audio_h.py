"""engine.persist_s_per_audio_h: host seconds of every write of the
analysis stage (the program's ``engine.persist`` spans: call rows, chunk
rows and call aggregates, markers, CSV rows, intermediate files) in the
traced sweep, per hour of call audio its ``engine.analysis`` spans
analysed (their ``audio_s``). Layer: host stages. Source: the program's
spans, host clock."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    sp = _ps.spans(run)
    if not sp:
        return None
    audio_s = sum(float(s.attrs.get("audio_s", 0.0)) for s in sp
                  if s.name == "engine.analysis")
    persist_s = sum(s.t1 - s.t0 for s in sp
                    if s.name == "engine.persist") / 1e9
    if audio_s <= 0 or persist_s <= 0:
        return None
    return persist_s / (audio_s / 3600.0)
