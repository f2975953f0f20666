"""topics.kernels_per_step: kernels the card ran per decode step of the
topic LM: the kernels of the launches (a CUDA graph's launch included:
each node the replay runs is one kernel) that the thread of each of the
program's ``topics.graph`` spans made inside it, over the spans' steps
(attribute ``steps``), in the traced sweep. A replayed step issues one
host launch, so the host's launches cannot show a step's fusion; this
counts what the card runs. A program whose spans carry no ``steps`` reads
nothing. Layer: topic LM. Source: the profiler's trace and the program's
spans."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_topics_counts", Path(__file__).with_name("_topics_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    graphs = _c.spans(run, "topics.graph")
    if not graphs or any("steps" not in s.attrs for s in graphs):
        return None
    steps = sum(int(s.attrs["steps"]) for s in graphs)
    n = _c.kernels(run, "topics.graph")
    if n is None or steps <= 0 or n <= 0:
        return None
    return n / steps
