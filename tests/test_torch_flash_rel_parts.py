"""The port's flash-rel ablation twins (the CPU path of
audio_processor_tpu_torch/models/flash_rel_parts.py) against the Pallas
kernels of tools/profile_kernel_parts.py run in interpret mode, at
B = H = 1: bf16 q, k, v ~ N(0, 1) and fp32 s_rel ~ 4 N(0, 1), so the
softmax is peaked and the modes differ by 0.2-0.3 where their formulas
differ (the tool's own 0.05-scale inputs leave the bias below bf16
resolution of the output).

The tool reads its wrapped-table width W from the flash-rel module,
which is 128 today; its ``full``, ``noselect`` and ``kb640`` kernels
were written for W = 256 and do not trace at 128. The tests set
W = 256 (and B, H, L) on the imported tool module; the port implements
those W = 256 semantics.

Tolerance atol 4e-3 + rtol 1e-2, at an output scale of about 0.5: both
sides compute in fp32 and round p and the output to bf16, with the same
kv steps (so the same running maxima); what differs is summation order,
which can move an output by one bf16 rounding (2^-9 relative) and a
p = bf16(.) across a rounding boundary. The wrong-by-design modes must
give the same non-finite pattern (NaN, and the sign of inf) and agree
where finite.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models import flash_rel_parts as frp

TOOL = (Path(__file__).resolve().parents[1] / "tools"
        / "profile_kernel_parts.py")
ATOL, RTOL = 4e-3, 1e-2


@pytest.fixture(scope="module")
def tool_module():
    spec = importlib.util.spec_from_file_location("profile_kernel_parts",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tool(tool_module, monkeypatch):
    """The tool's kernels at B = H = 1, W = 256, in interpret mode;
    ``tool(L)`` sets the sequence length."""
    monkeypatch.setattr(tool_module.pl, "pallas_call", functools.partial(
        tool_module.pl.pallas_call, interpret=True))
    for name, value in (("W", 256), ("B", 1), ("H", 1)):
        monkeypatch.setattr(tool_module, name, value)

    def at(L):
        monkeypatch.setattr(tool_module, "L", L)
        return tool_module

    return at


def _inputs(seed, L, masked_tail=0, offset=0.0):
    """q, k, v, s_rel, kv_mask at B = H = 1 (plus ``offset`` on q and k,
    and the last ``masked_tail`` kv columns masked)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, 1, L, 64)) for _ in range(3))
    q, k = q + offset, k + offset
    s_rel = (rng.standard_normal((1, 1, L, 128)) * 4.0).astype(np.float32)
    kv_mask = np.ones((1, L), np.float32)
    if masked_tail:
        kv_mask[0, L - masked_tail:] = 0.0
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    return bf + [torch.from_numpy(s_rel), torch.from_numpy(kv_mask)]


def _jax(call, args):
    import jax.numpy as jnp

    q, k, v, s_rel, kv_mask = args
    jargs = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
             for t in (q, k, v)]
    out = call(*jargs, jnp.asarray(s_rel.numpy()),
               jnp.asarray(kv_mask.numpy()))
    return np.asarray(out.astype(jnp.float32))


def _assert_match(got, ref):
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["full", "noselect", "norel", "nomax",
                                  "noexp"])
def test_variant_twin_matches_tool_kernel(tool, mode):
    L = 512
    args = _inputs(len(mode), L, masked_tail=100)
    ref = _jax(tool(L).variant_call(mode), args)
    _assert_match(frp.variant(*args, mode=mode), ref)
    if mode == "noexp":
        assert np.isnan(ref).all()            # NaN everywhere, by design
    else:
        assert np.isfinite(ref).all()


def test_variant_nosoftmax_twin_matches_tool_kernel(tool):
    """With masked kv columns the row sum is hugely negative and every
    output is +-inf; with none and q.k > 0 the row sum is positive and
    the outputs are finite."""
    L = 512
    for args, finite in ((_inputs(1, L, masked_tail=100), False),
                         (_inputs(2, L, offset=1.0), True)):
        ref = _jax(tool(L).variant_call("nosoftmax"), args)
        _assert_match(frp.variant(*args, mode="nosoftmax"), ref)
        assert np.isfinite(ref).all() if finite else np.isinf(ref).all()


def test_kb640_twin_matches_tool_kernel(tool):
    """Two 640-column kv steps need L = 1280; the same function as
    ``full`` up to rounding."""
    L = 1280
    args = _inputs(3, L, masked_tail=300)
    ref = _jax(tool(L).kb640_call(), args)
    got = frp.kb640(*args)
    _assert_match(got, ref)
    torch.testing.assert_close(got.float(),
                               frp.variant(*args, mode="full").float(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rowsum", ["ones", "reduce"])
def test_bare_twin_matches_tool_kernel(tool, rowsum):
    L = 512
    args = _inputs(4, L, masked_tail=100)    # the mask is not an input
    ref = _jax(tool(L).bare_call(rowsum), args)
    _assert_match(frp.bare(*args[:3], rowsum=rowsum), ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, s_rel, kv_mask = _inputs(5, 256)
    with pytest.raises(ValueError, match="mode"):
        frp.variant(q, k, v, s_rel, kv_mask, mode="shipped")
    with pytest.raises(ValueError, match="rowsum"):
        frp.bare(q, k, v, rowsum="sum")
    with pytest.raises(ValueError, match="640"):
        frp.kb640(q, k, v, s_rel, kv_mask)                 # L = 256
    with pytest.raises(ValueError, match="bfloat16"):
        frp.variant(q.float(), k.float(), v.float(), s_rel, kv_mask)
    with pytest.raises(ValueError, match="s_rel"):
        frp.variant(q, k, v, s_rel[..., :73], kv_mask)
    with pytest.raises(ValueError, match="num_buckets"):
        frp.variant(q, k, v, s_rel, kv_mask, num_buckets=129)


def test_cuda_request_raises_instead_of_running_on_cpu():
    """Only CPU tensors take the twins. On a machine without CUDA or
    nvcc, asking for a kernel raises; a tensor on any other device
    raises; nothing is counted as a launch."""
    counters = (frp.variant, frp.kb640, frp.bare)
    before = [f.launches for f in counters]
    args = _inputs(6, 256)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        frp.bare(*(t.to("meta") for t in args[:3]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            frp._launch("full", frp.variant, *args, frp.SCALE, frp.LEFT,
                        frp.NUM_BUCKETS)
    frp.variant(*args)                                     # twin, CPU
    assert [f.launches for f in counters] == before


def test_ablation_tool_maps_every_variant(capsys):
    """tools/profile_kernel_parts_torch.py: every variant name it takes
    reaches the port's function for that kernel (CPU tensors here, which
    take the plain versions); Pallas block sizes are reported and
    ignored."""
    spec = importlib.util.spec_from_file_location(
        "profile_kernel_parts_torch",
        TOOL.with_name("profile_kernel_parts_torch.py"))
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    args = _inputs(7, 1280, masked_tail=100)
    E = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (ablation.NUM_BUCKETS, 64))).to(torch.bfloat16)
    outs = {name: ablation.call_for(name, E)(*args)
            for name in ("full", "noselect", "norel", "nomax", "nosoftmax",
                         "noexp", "kb640", "bare", "bare:reduce", "shipped",
                         "stock", "stock:1280:256")}
    assert all(o.shape == args[0].shape for o in outs.values())
    assert "ignored" in capsys.readouterr().out
    torch.testing.assert_close(outs["stock"], outs["stock:1280:256"])
    torch.testing.assert_close(outs["bare"], frp.bare(*args[:3]))
    with pytest.raises(ValueError, match="variant"):
        ablation.call_for("fast", E)
