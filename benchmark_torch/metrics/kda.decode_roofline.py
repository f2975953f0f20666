"""kda.decode_roofline: the KDA decode kernel (``csrc/kda_decode.cu``) as
a share (%) of its roofline over the traced sweep: the least time of each
launch (``_kimi_counts.kda_launch_bound_s``: the larger of its operations
over 989 TFLOP/s and its bytes over 3.35 TB/s, the bytes being its rows'
fp32 state read and written, their inputs, conv inputs and output), summed
over the launches the traced ``topics.graph`` spans count
(``kda_launches`` at their ``rows``), scaled to the kernel's launches in
the trace, over the trace time of the kernels named ``kda_decode_kernel``.
A program whose spans carry no ``kda_launches`` reads nothing. Layer:
topic LM. Source: the profiler's trace and the program's spans."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_kimi_counts", Path(__file__).with_name("_kimi_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    graphs = [s for s in _c.spans(run, "topics.graph")
              if "kda_launches" in s.attrs]
    counted = sum(int(s.attrs["kda_launches"]) for s in graphs)
    if run.trace is None or counted <= 0:
        return None
    t, n = run.trace.kernel_s("kda_decode_kernel")
    if t <= 0 or n <= 0:
        return None
    m = run.job.config
    bound = sum(int(s.attrs["kda_launches"])
                * _c.kda_launch_bound_s(m, int(s.attrs["rows"]))
                for s in graphs)
    return 100.0 * bound * (n / counted) / t
