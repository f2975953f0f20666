"""The port's flash-rel attention (plain PyTorch version, the CPU path of
audio_processor_tpu_torch/models/flash_rel_attention.py) against the
JAX package's Pallas kernels run in interpret mode, both variants.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against the plain version there. Here the CPU tests check the plain
version's math and that a CUDA request never falls back to the CPU.

Tolerance atol 2e-5, rtol 1e-4: both sides are fp32 with fp32 softmax;
what differs is summation order (the JAX test file uses the same).
"""

import numpy as np
import pytest
import torch

from audio_processor_tpu.models.flash_rel_attention import (
    flash_rel_attention as jax_flash_rel,
)
from audio_processor_tpu_torch.models import flash_rel_attention as fra

from tests.test_flash_rel_attention import dense_reference

ATOL, RTOL = 2e-5, 1e-4
D = 64


def _inputs(seed, B, H, L, P, valid=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32)
               for _ in range(3))
    E = rng.standard_normal((P, D)).astype(np.float32)
    kv_mask = np.ones((B, L), np.float32)
    if valid is not None:
        kv_mask[-1, valid:] = 0.0          # masked kv tail on the last row
    return q, k, v, E, kv_mask


def _port(q, k, v, E, kv_mask, left, P, variant="auto"):
    t = [torch.from_numpy(a) for a in (q, k, v, E, kv_mask)]
    return fra.flash_rel_attention(*t, 1.0 / np.sqrt(D), left, P,
                                   variant=variant).numpy()


def _jax(q, k, v, E, kv_mask, left, P, variant):
    import jax.numpy as jnp

    return np.asarray(jax_flash_rel(
        *(jnp.asarray(a) for a in (q, k, v, E, kv_mask)),
        1.0 / np.sqrt(D), left, P, interpret=True, variant=variant))


@pytest.mark.parametrize("variant", ["onepass", "stream"])
@pytest.mark.parametrize("L", [256, 512])
def test_plain_matches_jax_kernel_masked_tail(L, variant):
    left, P = 64, 73                        # (left, right) = (64, 8)
    args = _inputs(L, 2, 2, L, P, valid=L - 77)
    np.testing.assert_allclose(_port(*args, left, P, variant),
                               _jax(*args, left, P, variant),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant", ["onepass", "stream"])
def test_plain_matches_jax_kernel_full_bucket_table(variant):
    """P = 128: the largest table the kernels take (left 100, right 27)."""
    left, P = 100, 128
    args = _inputs(7, 1, 2, 512, P, valid=400)
    np.testing.assert_allclose(_port(*args, left, P, variant),
                               _jax(*args, left, P, variant),
                               atol=ATOL, rtol=RTOL)


def test_plain_matches_dense_reference():
    """The JAX test file's own numpy reference (left 64, right 8)."""
    args = _inputs(3, 2, 1, 256, 73, valid=200)
    ref = dense_reference(*args, 1.0 / np.sqrt(D))
    np.testing.assert_allclose(_port(*args, 64, 73), ref,
                               atol=ATOL, rtol=RTOL)


def test_plain_bf16_inputs_give_bf16_output():
    """bf16 in, fp32 math, bf16 out: within bf16 rounding (2^-8
    relative) of the fp32 result on the same bf16-rounded inputs."""
    q, k, v, E, m = (torch.from_numpy(a)
                     for a in _inputs(5, 1, 2, 256, 73, valid=150))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out = fra.flash_rel_attention(qb, kb, vb, E, m, 0.125, 64, 73)
    assert out.dtype == torch.bfloat16
    ref = fra.flash_rel_attention(qb.float(), kb.float(), vb.float(),
                                  E.to(torch.bfloat16).float(), m, 0.125,
                                  64, 73)
    torch.testing.assert_close(out.float(), ref, atol=1e-2, rtol=2 ** -8)


def test_fully_masked_rows_stay_finite():
    """The additive -1e9 mask (not -inf) keeps every row finite."""
    q, k, v, E, m = (torch.from_numpy(a)
                     for a in _inputs(9, 2, 1, 256, 73))
    m[1] = 0.0
    out = fra.flash_rel_attention(q, k, v, E, m, 0.125, 64, 73)
    assert torch.isfinite(out).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    for bad in ({"d": 32}, {"L": 200}, {"P": 129}, {"left": 73},
                {"variant": "fast"}, {"dtype": torch.float16}):
        L, d, P = bad.get("L", 256), bad.get("d", D), bad.get("P", 73)
        q = torch.zeros(1, 1, L, d, dtype=bad.get("dtype", torch.float32))
        with pytest.raises(ValueError):
            fra.flash_rel_attention(q, q, q, torch.zeros(P, d),
                                    torch.ones(1, L), 0.125,
                                    bad.get("left", 64), P,
                                    variant=bad.get("variant", "auto"))


def test_cuda_request_raises_instead_of_running_on_cpu():
    """Only CPU tensors take the plain version. On a machine without
    CUDA or nvcc, asking for the kernel raises; a tensor on any other
    device raises; nothing is counted as a launch."""
    before = fra.flash_rel_attention.launches
    q, k, v, E, m = (torch.from_numpy(a) for a in _inputs(1, 1, 1, 64, 73))
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        fra.flash_rel_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                E, m.to("meta"), 0.125, 64, 73)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fra._launch(q, k, v, E, m, 0.125, 64, 73)
    fra.flash_rel_attention(q, k, v, E, m, 0.125, 64, 73)   # plain, CPU
    assert fra.flash_rel_attention.launches == before
