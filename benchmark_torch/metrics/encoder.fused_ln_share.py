"""encoder.fused_ln_share: the conformer's LayerNorms that ran as the fused
add-and-LayerNorm kernel, as a share (%) of the six LayerNorms of every
conformer layer in every encoder forward, over the traced sweep's
``encoder.graph`` spans: 100 x the sum of their ``ln_launches`` (each
forward's launches of the kernel; a replay counts its capture's) over
6 x ``num_hidden_layers`` x the number of spans. A program whose spans
carry no ``ln_launches`` reads nothing. Layer: device program. Source:
the program's spans (a count)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    graphs = [s for s in _ps.spans(run) or () if s.name == "encoder.graph"
              and "ln_launches" in s.attrs]
    if not graphs:
        return None
    layers = int(run.job.config["model"]["num_hidden_layers"])
    launches = sum(int(s.attrs["ln_launches"]) for s in graphs)
    return 100.0 * launches / (6 * layers * len(graphs))
