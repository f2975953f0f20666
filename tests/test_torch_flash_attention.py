"""The port's flash attention (plain PyTorch version, the CPU path of
audio_processor_tpu_torch/models/flash_attention.py) against the stock
Pallas TPU flash kernel run in interpret mode, with and without a bias.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against the plain version there. Here the CPU tests check the plain
version's math and that a CUDA request never falls back to the CPU.

Tolerances: fp32 inputs, atol 2e-5 + rtol 1e-4 (both sides fp32 with an
fp32 softmax; summation order differs, and the Pallas kernel
renormalises its accumulator every kv step). bf16 inputs, atol 1e-2 +
rtol 1e-2: both sides round p to bf16 before p.v, but against different
running maxima (the kernel's per step, the plain version's per row), so
an output may differ by about one bf16 rounding.
"""

import functools

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models import flash_attention as fa

D = 64
TOL = {"float32": (2e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
BLOCK = dict(block_q=128, block_k_major=128, block_k=128, block_b=1)


def _inputs(seed, B, H, L, bias):
    """q, k, v ~ N(0, 1) and, when ``bias``, a [B, H, L, L] bias of
    N(0, 0.5) with the model's kv-mask entries (-8e9): the last 77
    columns of the last batch row and, when B > 1, all of head 1 of
    batch row 0."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32)
               for _ in range(3))
    ab = None
    if bias:
        ab = (0.5 * rng.standard_normal((B, H, L, L))).astype(np.float32)
        ab[-1, :, :, L - 77:] = -8e9
        if B > 1:
            ab[0, 1] = -8e9
    return q, k, v, ab


@pytest.fixture
def stock(monkeypatch):
    """The stock Pallas flash kernel, run in interpret mode."""
    import jax.experimental.pallas.ops.tpu.flash_attention as stock_fa

    monkeypatch.setattr(stock_fa.pl, "pallas_call", functools.partial(
        stock_fa.pl.pallas_call, interpret=True))

    def run(q, k, v, ab, dtype, ab_dtype):
        import jax.numpy as jnp

        jd = jnp.dtype(dtype)
        out = stock_fa.flash_attention(
            *(jnp.asarray(a, jd) for a in (q, k, v)),
            ab=None if ab is None else jnp.asarray(ab, jnp.dtype(ab_dtype)),
            sm_scale=0.125, block_sizes=stock_fa.BlockSizes(**BLOCK))
        return np.asarray(out.astype(jnp.float32))

    return run


def _port(q, k, v, ab, dtype, ab_dtype):
    td = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    tab = None if ab is None else torch.from_numpy(ab).to(
        getattr(torch, ab_dtype))
    out = fa.flash_attention(*t, tab, 0.125)
    assert out.dtype == td
    return out.float().numpy()


def _live(ab, B, H):
    """(b, h) slices with at least one unmasked kv column: a wholly
    masked one is finite but arbitrary on both sides (every score sits
    near -1e9, where fp32 steps by 64)."""
    if ab is None:
        return np.ones((B, H), bool)
    return (ab > -1e9).any(axis=(2, 3))


@pytest.mark.parametrize("dtype,ab_dtype,bias", [
    ("float32", "bfloat16", True), ("bfloat16", "bfloat16", True),
    ("float32", "float32", True), ("float32", None, False),
    ("bfloat16", None, False)])
def test_plain_matches_stock_kernel(stock, dtype, ab_dtype, bias):
    B, H, L = 2, 2, 256
    q, k, v, ab = _inputs(L + len(dtype), B, H, L, bias)
    got = _port(q, k, v, ab, dtype, ab_dtype)
    ref = stock(q, k, v, ab, dtype, ab_dtype)
    live = _live(ab, B, H)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got[live], ref[live], atol=atol, rtol=rtol)
    assert np.isfinite(got).all()


def test_plain_matches_stock_kernel_several_kv_steps(stock):
    """L = 512: four 128-column kv steps of the Pallas kernel, eight of
    the CUDA kernel's tiles; bf16 bias as the model gives it."""
    q, k, v, ab = _inputs(11, 1, 2, 512, bias=True)
    got = _port(q, k, v, ab, "float32", "bfloat16")
    ref = stock(q, k, v, ab, "float32", "bfloat16")
    atol, rtol = TOL["float32"]
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def test_plain_takes_any_multiple_of_64():
    """L = 192 is not a multiple of the Pallas kernel's 128-column block
    but is of the CUDA kernel's tile; the plain version equals a dense
    softmax there."""
    q, k, v, ab = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 192, True))
    ref = torch.softmax((q @ k.transpose(-1, -2) + ab) * 0.125, -1) @ v
    torch.testing.assert_close(fa.flash_attention(q, k, v, ab, 0.125), ref,
                               atol=2e-5, rtol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    for bad in ({"d": 32}, {"L": 200}, {"dtype": torch.float16},
                {"ab_shape": (1, 1, 64, 32)}, {"ab_dtype": torch.float16}):
        L, d = bad.get("L", 64), bad.get("d", D)
        q = torch.zeros(1, 1, L, d, dtype=bad.get("dtype", torch.float32))
        ab = torch.zeros(bad.get("ab_shape", (1, 1, L, L)),
                         dtype=bad.get("ab_dtype", torch.bfloat16))
        with pytest.raises(ValueError):
            fa.flash_attention(q, q, q, ab, 0.125)


def test_cuda_request_raises_instead_of_running_on_cpu():
    """Only CPU tensors take the plain version. On a machine without
    CUDA or nvcc, asking for the kernel raises; a tensor on any other
    device raises; nothing is counted as a launch."""
    before = fa.flash_attention.launches
    q, k, v, ab = (torch.from_numpy(a) for a in _inputs(1, 1, 1, 64, True))
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fa._launch(q, k, v, ab, 0.125)
    fa.flash_attention(q, k, v, ab, 0.125)               # plain, CPU
    assert fa.flash_attention.launches == before
