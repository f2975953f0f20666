"""Operations and bytes of the speech-to-text decode loop, from shapes,
and its least time on the card (``decoder.hbm_roofline``).

Each position of the loop reads the decoder's per-step weights once (self
q, k, v, out; cross q, out; the FFN; bf16) and, past the prompt's first
token, the tied LM head; each active row reads its own self K/V cache up
to the position and its cross K/V over its valid adaptor frames, writes
its new key and value and, past the first token, its logits (bf16). A row
is active at the prompt's first token and at every step whose token it
emitted (``</s>`` included). Counts follow valid lengths, never padded
shapes; a multiply-add is two operations. Peaks: ``_counts.py``.
"""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_counts", Path(__file__).with_name("_counts.py"))
_counts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counts)

ELEM = 2          # bf16


def adaptor_frames(n_samples, stride):
    return _counts.encoder_frames(n_samples) // stride + 1


def loop_bound_s(m, real, emitted):
    """Least time of one device batch's loop: the sum over its positions of
    max(operations / bf16 peak, bytes / HBM bandwidth). ``real``: each real
    chunk's samples; ``emitted``: tokens each real row emitted (3 rows per
    chunk, in order)."""
    h, f = m["hidden_size"], m["decoder_ffn_dim"]
    layers, vocab = m["decoder_layers"], m["vocab_size"]
    per_layer = 6 * h * h + 2 * h * f
    frames = [adaptor_frames(n, m["adaptor_stride"])
              for n in real for _ in range(3)]
    total = 0.0
    for p in range(max(emitted, default=0) + 1):
        head = p > 0
        ops = 0
        nbytes = ELEM * (layers * per_layer + (vocab * h if head else 0))
        for fa, e in zip(frames, emitted):
            if p > e or (p == 0 and e == 0):
                continue
            ops += 2 * (layers * per_layer + (vocab * h if head else 0))
            ops += layers * 4 * h * ((p + 1) + fa)
            nbytes += ELEM * layers * 2 * h * ((p + 1) + fa + 1)
            nbytes += ELEM * vocab if head else 0
        total += max(ops / _counts.BF16_FLOPS, nbytes / _counts.HBM_BYTES_S)
    return total
