"""decoder.fused_attention_share: the decode steps' attention that ran as
the decode-attention kernel, as a share (%) of the two attentions (self and
cross) of every decoder layer in every step, over the traced sweep's
``decoder.graph`` spans: 100 x the sum of their ``attn_launches`` (each
step's launches of the kernel; a replayed step counts its capture's) over
2 x ``decoder_layers`` x the sum of their ``steps``. A program whose spans
carry no ``attn_launches`` reads nothing. Layer: text decoder. Source: the
program's spans (a count)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    graphs = [s for s in _ps.spans(run) or () if s.name == "decoder.graph"
              and "attn_launches" in s.attrs]
    steps = sum(int(s.attrs["steps"]) for s in graphs)
    if steps <= 0:
        return None
    layers = int(run.job.config["model"]["decoder_layers"])
    launches = sum(int(s.attrs["attn_launches"]) for s in graphs)
    return 100.0 * launches / (2 * layers * steps)
