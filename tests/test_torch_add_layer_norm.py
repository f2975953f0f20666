"""The conformer's fused add-and-LayerNorm (models/layer_norm.py): its
plain version, which the CPU runs, against the composition the conformer
ran before the kernel (kept below verbatim as ``_old`` and
``_old_layer``), what the kernel's wrapper refuses, and the conformer's
rule that only a bf16 CUDA input with autograd recording no gradient of
the layer reaches the kernel.

The CUDA kernel runs only on the card. The tests marked ``cuda`` hold it
against the plain version there and skip without a card; this file
imports no JAX, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_add_layer_norm.py

Tolerances. The plain version against the old composition: bit for bit
(the same ops in the same order). The kernel against the plain version:
r bit for bit; y within one bf16 step before the epilogue (the row's
fp32 sums run in another order; near 0, where that order's ~1e-6 exceeds
a step, one step of 2^-6), and the mask and SiLU epilogues equal to the
same ops applied to the kernel's own y.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_processor_tpu_torch.models import layer_norm as lnm
from audio_processor_tpu_torch.models import wav2vec2bert as tw

C = 64
SMALL = dict(vocab_size=40, hidden_size=C, num_hidden_layers=2,
             num_attention_heads=1, intermediate_size=128,
             conv_depthwise_kernel_size=5)


def _ln(width, seed):
    """A LayerNorm with drawn (not identity) fp32 gamma and beta."""
    g = torch.Generator().manual_seed(seed)
    ln = nn.LayerNorm(width)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.3 * torch.randn(width, generator=g))
        ln.bias.copy_(0.2 * torch.randn(width, generator=g))
    return ln


def _rows(seed, dtype, shape=(3, 17, C)):
    """x, a branch and a 0/1 row mask with some rows masked."""
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(shape, generator=g) + 0.5).to(dtype)
    a = torch.randn(shape, generator=g).to(dtype)
    mask = (torch.rand(shape[:-1], generator=g) > 0.3).float()
    return x, a, mask


def _old(ln, x, a, alpha, mask, silu):
    """The conformer's ops before the fused kernel: the residual add as
    written (``ffn(..) * 0.5 + x``, ``attn(..) + x``), ``layer_norm``
    (upcast, fp32 norm, cast back), then the mask product or SiLU."""
    r = x if a is None else a * 0.5 + x if alpha == 0.5 else a + x
    y = F.layer_norm(r.float(), ln.normalized_shape, ln.weight, ln.bias,
                     ln.eps).to(x.dtype)
    if mask is not None:
        y = y * mask[..., None].to(y.dtype)
    if silu:
        y = F.silu(y)
    return r, y


@pytest.mark.parametrize("alpha", [0.5, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_old_composition_bit_for_bit(dtype, alpha):
    """The twin, and the wrapper on CPU tensors, which runs the twin."""
    ln = _ln(C, 1)
    x, a, mask = _rows(2, dtype)
    for branch in (None, a):
        for m, silu in ((None, False), (mask, False), (None, True)):
            want_r, want_y = _old(ln, x, branch, alpha, m, silu)
            for residual in (True, False):
                for fn in (lnm.add_layer_norm_plain, lnm.add_layer_norm):
                    with torch.no_grad():
                        r, y = fn(ln, x, branch, alpha, mask=m, silu=silu,
                                  residual=residual)
                    assert torch.equal(y, want_y)
                    assert (torch.equal(r, want_r) if residual
                            else r is None)
    assert lnm.add_layer_norm_plain(ln, x)[0] is x


def _old_layer(layer, x, attn_bias, pad_mask, impl):
    """ConformerLayer.forward and ConvModule.forward before the fused
    kernel, verbatim but for the module lookups."""
    ln = tw.layer_norm

    def conv(cm, x):
        x = ln(cm.layer_norm, x)
        x = x * pad_mask[..., None].to(x.dtype)
        a, g = tw.dense(cm.pointwise_conv1, x).chunk(2, dim=-1)
        x = a * torch.sigmoid(g)
        K = cm.depthwise_conv.kernel_size[0]
        xt = F.pad(x.transpose(1, 2), (K - 1, 0))
        y = F.conv1d(xt, cm.depthwise_conv.weight.to(x.dtype),
                     groups=x.shape[-1])
        x = y.to(x.dtype).transpose(1, 2)
        x = F.silu(ln(cm.depthwise_layer_norm, x))
        return tw.dense(cm.pointwise_conv2, x)

    x = layer.ffn1(ln(layer.ffn1_layer_norm, x)) * 0.5 + x
    h = ln(layer.self_attn_layer_norm, x)
    x = layer.self_attn(h, attn_bias, pad_mask, impl) + x
    x = conv(layer.conv_module, x) + x
    x = layer.ffn2(ln(layer.ffn2_layer_norm, x)) * 0.5 + x
    return ln(layer.final_layer_norm, x)


def _layer_inputs(dtype):
    model = tw.build_synthetic(tw.W2VBertConfig(**SMALL),
                               torch.device("cpu"), seed=3)
    layer = model.layers[0]
    for i, ln in enumerate(m for m in layer.modules()
                           if isinstance(m, nn.LayerNorm)):
        ln.load_state_dict(_ln(C, 10 + i).state_dict())
    x, _, pad = _rows(4, dtype, (2, 24, C))
    pad[:, :8] = 1.0                     # every row has valid frames
    attn_bias = ((1.0 - pad) * -1e9)[:, None, None, :]
    return layer, x, attn_bias, pad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_conformer_layer_equals_the_old_layer_bit_for_bit(dtype):
    layer, x, attn_bias, pad = _layer_inputs(dtype)
    with torch.no_grad():
        want = _old_layer(layer, x, attn_bias, pad, "xla")
        got = layer(x, attn_bias, pad, "xla")
    assert got.dtype == dtype and torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ln = _ln(C, 5)
    x, a, mask = _rows(6, torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="differ"):    # mixed dtypes
            lnm.add_layer_norm(ln, x, a.float())
        with pytest.raises(ValueError, match="not both"):
            lnm.add_layer_norm(ln, x, mask=mask, silu=True)
    bad = [
        dict(x=x[..., :60], branch=None),                       # 60 % 8
        dict(x=x[..., :4].contiguous(), branch=None),           # < 8
        dict(x=torch.zeros(2, 4104, dtype=torch.bfloat16),
             branch=None),                                      # > 4096
        dict(x=x.float(), branch=None),                         # fp32
        dict(branch=a[:, :16]),                                 # shape
        dict(mask=mask.bfloat16()),                             # mask dtype
        dict(mask=mask[:, :16]),                                # mask shape
        dict(x=x.transpose(0, 1).contiguous().transpose(0, 1)),  # strided
        dict(branch=torch.zeros(x.numel() + 8,
                                dtype=x.dtype)[1:x.numel() + 1]
             .view(x.shape)),                                   # aligned
    ]
    for case in bad:
        args = dict(x=x, branch=a, mask=None)
        args.update(case)
        with pytest.raises(ValueError, match="width|bfloat16|branch|mask|"
                                             "contiguous|aligned"):
            lnm._launch(ln, args["x"], args["branch"], 0.5, args["mask"],
                        False, True)
    cols = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert lnm.columns(cols) and not lnm.columns(x)
    lnm._check(ln, cols, None, mask, False)     # read as it lies
    with pytest.raises(ValueError, match="branch needs x in rows"):
        lnm._check(ln, cols, a, None, False)
    ln.bias = None
    with pytest.raises(ValueError, match="bias"):
        lnm._check(ln, x, None, None, False)


def _spy_kernel(monkeypatch):
    """Force the card's predicate true and replace the kernel by a spy
    that runs the wrapper's checks, records the call and then runs the
    plain version; returns the list of calls."""
    calls = []

    def spy(ln, x, branch, alpha, mask, silu, residual):
        lnm._check(ln, x, branch, mask, silu)
        calls.append(x.shape)
        return lnm.add_layer_norm_plain(ln, x, branch, alpha, mask=mask,
                                        silu=silu, residual=residual)

    monkeypatch.setattr(lnm, "_on_card", lambda x: True)
    monkeypatch.setattr(lnm, "_launch", spy)
    return calls


def test_only_bf16_with_autograd_off_reaches_the_kernel(monkeypatch):
    """With the kernel replaced by a spy (:func:`_spy_kernel`), a bf16
    layer under no_grad launches six times and a bf16 model's forward six
    per layer; training under autograd (remat too) and fp32 compute
    launch nothing."""
    calls = _spy_kernel(monkeypatch)
    layer, x, attn_bias, pad = _layer_inputs(torch.bfloat16)
    with torch.no_grad():
        layer(x, attn_bias, pad, "xla")
    assert len(calls) == 6
    model = tw.build_synthetic(tw.W2VBertConfig(**SMALL),
                               torch.device("cpu"), seed=3)
    feats = torch.randn(2, 24, 160)
    calls.clear()
    with torch.inference_mode():
        model(feats, dtype=torch.bfloat16)
        assert len(calls) == 6 * SMALL["num_hidden_layers"]
        calls.clear()
        model(feats, dtype=torch.float32)
    assert not calls
    model.train()
    for remat in (False, True):
        model(feats, dtype=torch.bfloat16, remat=remat).sum().backward()
    layer(x.requires_grad_(), attn_bias, pad, "xla")
    assert not calls


def test_the_wrapper_launches_or_raises_on_the_card(monkeypatch):
    """On the card (the spy of :func:`_spy_kernel`) the wrapper launches
    or raises and never falls back: an fp32 row raises, an operand that
    requires grad raises while autograd records. A layer whose parameters
    need no gradient takes the kernel with autograd on too."""
    calls = _spy_kernel(monkeypatch)
    ln = _ln(C, 5)
    x, a, _ = _rows(6, torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="bfloat16"):
        lnm.add_layer_norm(ln, x.float(), a.float())
    with pytest.raises(RuntimeError, match="no backward"):
        lnm.add_layer_norm(ln, x, a)             # ln.weight requires grad
    assert not calls
    layer, x, attn_bias, pad = _layer_inputs(torch.bfloat16)
    layer.requires_grad_(False)
    assert torch.is_grad_enabled() and lnm.fused(x, layer)
    layer(x, attn_bias, pad, "xla")
    assert len(calls) == 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _steps(y, want):
    """|y - want| in bf16 steps of ``want``, a step below 2^-6 counted as
    2^-6's: near 0 the fp32 statistics' own rounding (~1e-6 at these
    scales) exceeds a bf16 step."""
    mag = want.float().abs().clamp_min(2.0 ** -6)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (y.float() - want.float()).abs() / step


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1024, 4096, 72])
def test_kernel_matches_plain_on_the_card(card, width):
    """r bit for bit and y within one bf16 step of the plain version, at a
    ragged row count, with and without a branch, alpha 0.5 and 1; the mask
    and SiLU epilogues equal those ops on the kernel's own y; columns
    ([B, C, L] transposed) give the rows' y bit for bit."""
    ln = _ln(width, 7).to(card)
    x, a, mask = (t.to(card) for t in _rows(8, torch.bfloat16,
                                             (24, 97, width)))
    before = lnm.add_layer_norm.launches
    with torch.inference_mode():
        for branch, alpha in ((None, 1.0), (a, 0.5), (a, 1.0)):
            r, y = lnm.add_layer_norm(ln, x, branch, alpha)
            pr, py = lnm.add_layer_norm_plain(ln, x, branch, alpha)
            assert torch.equal(r, pr)
            assert float(_steps(y, py).max()) <= 1
            _, ym = lnm.add_layer_norm(ln, x, branch, alpha, mask=mask,
                                       residual=False)
            assert torch.equal(ym, y * mask[..., None].bfloat16())
            _, ys = lnm.add_layer_norm(ln, x, branch, alpha, silu=True)
            assert torch.equal(ys, F.silu(y))
        # [B, C, L] columns read as they lie (L not and L a multiple of 8):
        # the rows' y bit for bit
        for frames in (97, 104):
            xr, _, m = (t.to(card) for t in _rows(9, torch.bfloat16,
                                                  (5, frames, width)))
            cols = xr.transpose(1, 2).contiguous().transpose(1, 2)
            _, y = lnm.add_layer_norm(ln, xr)
            for kw in ({}, dict(silu=True), dict(mask=m)):
                _, yc = lnm.add_layer_norm(ln, cols, **kw)
                _, yr = lnm.add_layer_norm(ln, xr, **kw)
                assert yc.is_contiguous() and torch.equal(yc, yr)
    assert lnm.add_layer_norm.launches - before == 9 + 2 * 7


@pytest.mark.cuda
def test_encoder_graph_spans_count_six_launches_per_layer(card):
    """A bf16 encoder's capture and replays: each ``encoder.graph`` span's
    ``ln_launches`` is 6 x layers, and the wrapper's count grows by as
    much; an fp32 forward launches none."""
    from audio_processor_tpu_torch.obs import profiler

    cfg = tw.W2VBertConfig(vocab_size=40, hidden_size=128,
                           num_hidden_layers=3, num_attention_heads=2,
                           intermediate_size=256)
    model = tw.build_synthetic(cfg, card, seed=1)
    x = torch.randn(4, 256, 160, device=card)
    before = lnm.add_layer_norm.launches
    with torch.inference_mode(), profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        for dtype in (torch.bfloat16,) * 3 + (torch.float32,):
            model(x, dtype=dtype)
        spans = [s for s in profiler.spans() if s.id not in seen
                 and s.name == "encoder.graph"]
    assert [s.attrs["mode"] for s in spans][:3] == ["capture", "replay",
                                                    "replay"]
    assert [s.attrs["ln_launches"] for s in spans] == [18, 18, 18, 0]
    assert lnm.add_layer_norm.launches - before == 3 * 18
