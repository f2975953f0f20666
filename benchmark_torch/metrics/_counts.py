"""Operations and bytes of the work the traffic asks for, from shapes, and
the card's published peaks.

Counts follow the valid length of each row, never the padded launch shape,
so no later change to padding or tiling can make a denominator stale. A
multiply-add is two operations.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 67 TFLOP/s
fp32 outside the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Dict, Iterable

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

FRAME, HOP, NFFT, NMEL, STRIDE = 400, 160, 512, 80, 2


def encoder_frames(n_samples: int) -> int:
    """Valid encoder frames of a row of ``n_samples`` 16 kHz samples."""
    return max(0, 1 + (n_samples - FRAME) // HOP) // STRIDE


def relative_attention(m: Dict, frames: int, elem_bytes: int = 2) -> tuple:
    """(operations, bytes) of one relative-key attention over one row of
    ``frames`` valid frames, all heads: q.k^T and p.v (2 x 2 L^2 d per
    head), q.E^T over the P distance buckets (2 L P d); q, k, v read once
    and the output written once, the distance table read once."""
    h = m["num_attention_heads"]
    d = m["hidden_size"] // h
    P = m["left_max_position_embeddings"] \
        + m["right_max_position_embeddings"] + 1
    ops = h * (4 * frames * frames * d + 2 * frames * P * d)
    nbytes = 4 * h * frames * d * elem_bytes + P * d * elem_bytes
    return ops, nbytes


def attention_bound_s(m: Dict, frames: Iterable[int]) -> float:
    """Least time one launch over rows of these valid frame counts can take
    on the card: the larger of operations over the bf16 peak and bytes over
    HBM bandwidth."""
    ops = nbytes = 0
    for f in frames:
        o, b = relative_attention(m, f)
        ops += o
        nbytes += b
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_S)


def encoder_flops(m: Dict, frames: int) -> int:
    """Operations of the feature projection, every conformer layer and the
    CTC head over one row of ``frames`` valid frames."""
    h, f = m["hidden_size"], m["intermediate_size"]
    K = m["conv_depthwise_kernel_size"]
    per_frame = (2 * 2 * (2 * h * f)        # ffn1, ffn2
                 + 4 * 2 * h * h            # q, k, v, out
                 + 2 * h * 2 * h            # pointwise conv 1 (GLU in)
                 + 2 * K * h                # depthwise conv
                 + 2 * h * h)               # pointwise conv 2
    attn, _ = relative_attention(m, frames)
    total = m["num_hidden_layers"] * (per_frame * frames + attn)
    total += frames * 2 * m["feature_projection_input_dim"] * h
    total += frames * 2 * h * m["vocab_size"]
    return total


def frontend_flops(n_samples: int) -> int:
    """Operations of the log-mel frontend of one row: each 25 ms frame's
    512-point real DFT as two products with the 400-sample frame (cosine
    and sine, 257 bins each) and the 80-bin mel product."""
    frames = max(0, 1 + (n_samples - FRAME) // HOP)
    bins = NFFT // 2 + 1
    return frames * (2 * 2 * FRAME * bins + 2 * bins * NMEL)


def asr_row_flops(m: Dict, n_samples: int) -> int:
    """Frontend + encoder + CTC head of one row (one view of one chunk)."""
    return frontend_flops(n_samples) + encoder_flops(
        m, encoder_frames(n_samples))
