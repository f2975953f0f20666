"""kda.fused_prefill_share: the hybrid topic LM's KDA layer prefills that
ran through the hand-written prefill kernel, as a share (%) of the traced
sweep's ``topics.kda_prefill`` spans: 100 x the spans whose
``kernel_launches`` (the kernel's launches inside the span) is at least 1
over all of them. A program whose spans carry no ``kernel_launches``
reads nothing. Layer: topic LM. Source: the program's spans (a count)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    pre = [s for s in _ps.spans(run) or () if s.name == "topics.kda_prefill"]
    if not any("kernel_launches" in s.attrs for s in pre):
        return None
    fused = sum(int(s.attrs.get("kernel_launches", 0)) >= 1 for s in pre)
    return 100.0 * fused / len(pre)
