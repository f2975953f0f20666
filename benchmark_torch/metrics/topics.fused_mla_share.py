"""topics.fused_mla_share: the topic LM's decode-step attention that ran as
the MLA attention kernel, as a share (%) of one attention per layer in
every step, over the traced sweep's ``topics.graph`` spans: 100 x the sum
of their ``mla_launches`` (each step's launches of the kernel; a replayed
step counts its capture's) over ``num_hidden_layers`` x the sum of their
``steps``. A program whose spans carry no ``mla_launches`` reads nothing.
Layer: topic LM. Source: the program's spans (a count)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    graphs = [s for s in _ps.spans(run) or () if s.name == "topics.graph"
              and "mla_launches" in s.attrs]
    steps = sum(int(s.attrs["steps"]) for s in graphs)
    if steps <= 0:
        return None
    layers = int(run.job.config["num_hidden_layers"])
    launches = sum(int(s.attrs["mla_launches"]) for s in graphs)
    return 100.0 * launches / (layers * steps)
