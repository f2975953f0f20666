"""The KDA prefill between its projections (``models/kda.py::kda_prefill``,
``csrc/kda_prefill.cu``): on the CPU the wrapper runs the plain twin, which
equals the layer's prefill as it was composed before the kernel bit for
bit; the kernel's operand checks; the ``topics.kda_prefill`` span's
``kernel_launches``. The card-only test (marker ``cuda``, skips here)
holds the kernel against the twin at Kimi-Linear's widths over 8 ragged
rows; on the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kda_prefill.py
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from audio_processor_tpu_torch.models import _cuda_call, kda
from audio_processor_tpu_torch.obs import profiler

LENGTHS = [1, 3, 63, 64, 65, 150]      # shorter than the conv and a chunk


def _layer(dtype, H=2, D=16, hidden=32, seed=0):
    cfg = SimpleNamespace(kda_num_heads=H, kda_head_dim=D, kda_conv_size=4,
                          hidden_size=hidden, rms_norm_eps=1e-5)
    m = kda.KimiDeltaAttention(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            kda.stand_in(name, p, g)
        m.fg_b.normal_(0.0, 0.3, generator=g)      # gates far from 0 and 1
        m.o_norm.uniform_(0.5, 1.5, generator=g)
        m.g_bias.normal_(0.0, 0.5, generator=g)
    m = m.to(dtype).requires_grad_(False)
    for name in ("A_log", "dt_bias"):
        getattr(m, name).data = getattr(m, name).data.float()
    return m


def _rows(lengths):
    out, at = [], 0
    for n in lengths:
        out.append((at, n))
        at += n
    return out


def _old_prefill(m, x, rows, state, conv_state):
    """The layer's prefill as it was composed before the kernel."""
    N = x.shape[0]
    H, D, K, W = m.H, m.D, m.K, m.W
    raw, fg, b = m._split(F.linear(x, m.in_proj.weight))
    starts = torch.tensor([s for s, _ in rows])
    lens = torch.tensor([n for _, n in rows])
    t_in = torch.arange(N) - torch.repeat_interleave(starts, lens)

    def conv(i):
        r32 = raw[:, i * W:(i + 1) * W].float()
        w = m.conv_weight[i * W:(i + 1) * W].float()
        y = r32 * w[:, K - 1]
        for back_by in range(1, K):
            back = torch.zeros_like(r32)
            back[back_by:] = r32[:-back_by]
            y += back.masked_fill_((t_in < back_by)[:, None], 0.0) \
                * w[:, K - 1 - back_by]
        return F.silu(y)

    q, k, v = (conv(i).view(N, H, D) for i in range(3))
    q = kda._l2(q) * D ** -0.5
    k = kda._l2(k)
    g = -m.A_log.float().exp()[:, None] * F.softplus(
        fg[0].float() + m.dt_bias.float()).unflatten(-1, (H, D))
    o, final = kda.chunk_kda(q, k, v, g, torch.sigmoid(b.float()),
                             [n for _, n in rows])
    state.copy_(final)
    j = torch.arange(K - 1) - (K - 1)
    at = (starts + lens)[:, None] + j[None]
    ok = (lens[:, None] + j[None]) >= 0
    conv_state.copy_(raw[at.clamp(min=0)].masked_fill_(~ok[..., None], 0))
    y = F.rms_norm(o, (D,), m.o_norm.float(), m.eps) * torch.sigmoid(
        fg[1].float() + m.g_bias.float()).unflatten(-1, (H, D))
    return F.linear(y.flatten(1).to(x.dtype), m.o_proj.weight)


def _states(m, R, device="cpu"):
    return (torch.full((R, m.H, m.D, m.D), 7.0, device=device),
            torch.full((R, m.K - 1, 3 * m.W), 7.0, device=device,
                       dtype=m.conv_weight.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_runs_the_twin_equal_to_the_old_prefill(dtype):
    m = _layer(dtype)
    rows = _rows(LENGTHS)
    x = torch.randn(sum(LENGTHS), 32, generator=torch.Generator()
                    .manual_seed(1)).to(dtype)
    st, cv = _states(m, len(rows))
    st2, cv2 = _states(m, len(rows))
    before = kda.kda_prefill.launches
    with torch.inference_mode():
        got = m.prefill(x, rows, st, cv)
        want = _old_prefill(m, x, rows, st2, cv2)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(st, st2) and torch.equal(cv, cv2)
    assert kda.kda_prefill.launches == before


def _operands(R=2, N=5, H=2):
    D, W = kda.HEAD_DIM, 2 * kda.HEAD_DIM
    bf = dict(dtype=torch.bfloat16)
    return dict(p=torch.randn(N, 3 * W + 2 * D + H, **bf),
                fg=torch.randn(2, N, W, **bf),
                conv_weight=torch.randn(3 * W, 4, **bf),
                A_log=torch.zeros(H), dt_bias=torch.zeros(W),
                g_bias=torch.zeros(W, **bf), o_norm=torch.ones(D, **bf),
                state=torch.zeros(R, H, D, D),
                conv_state=torch.zeros(R, 3, 3 * W, **bf))


@pytest.mark.parametrize("what", ["dtype", "shape", "head size",
                                  "conv width", "device"])
def test_the_kernel_check_refuses_what_it_does_not_take(what):
    ok = _operands()
    kda._check(**ok, rows=2)
    D, W, bf = kda.HEAD_DIM, 2 * kda.HEAD_DIM, torch.bfloat16
    changes = {
        "dtype": [dict(p=ok["p"].float()), dict(fg=ok["fg"].float()),
                  dict(state=ok["state"].to(bf))],
        "shape": [dict(state=torch.zeros(3, 2, D, D)),
                  dict(conv_state=torch.zeros(2, 2, 3 * W, dtype=bf)),
                  dict(p=torch.randn(ok["p"].shape[1], 5, dtype=bf).t())],
        "head size": [dict(o_norm=torch.ones(64, dtype=bf))],
        "conv width": [dict(conv_weight=torch.randn(3 * W, 3, dtype=bf))],
        "device": [dict(state=torch.zeros(2, 2, D, D, device="meta"))],
    }[what]
    for change in changes:
        with pytest.raises(ValueError):
            kda._check(**dict(ok, **change), rows=2)


def test_rows_must_pack_the_tokens_in_order():
    kda._check_rows([(0, 2), (2, 3)], 5)
    for rows in ([(0, 2), (3, 3)], [(0, 2), (2, 2)], [(0, 6), (6, -1)], []):
        with pytest.raises(ValueError, match="pack"):
            kda._check_rows(rows, 5)


def test_autograd_and_other_devices_are_refused():
    ops = _operands()
    args = [ops[k] for k in ("p", "fg", "conv_weight", "A_log", "dt_bias",
                             "g_bias", "o_norm")]
    rows = [(0, 2), (2, 3)]
    with pytest.raises(RuntimeError, match="no backward"):
        kda.kda_prefill(args[0].float().requires_grad_(), *args[1:], 1e-5,
                        rows, ops["state"], ops["conv_state"])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cpu .plain. or cuda"):
        kda.kda_prefill(*meta, 1e-5, rows, ops["state"].to("meta"),
                        ops["conv_state"].to("meta"))


def test_the_span_counts_the_kernels_launches(monkeypatch):
    """``topics.kda_prefill`` carries ``kernel_launches``: 0 where the twin
    ran, the wrapper's launches inside the span where the kernel ran (here
    a stand-in that counts one launch and runs the twin)."""
    m = _layer(torch.float32)
    rows = _rows([5, 70])
    x = torch.randn(75, 32)

    def launching(*args):
        _cuda_call.count_launch(launching)
        return kda.kda_prefill_plain(*args)

    launching.launches = 0
    with profiler.recording_spans(), torch.inference_mode():
        seen = {s.id for s in profiler.spans()}
        m.prefill(x, rows, *_states(m, 2), layer=4)
        monkeypatch.setattr(kda, "kda_prefill", launching)
        m.prefill(x, rows, *_states(m, 2), layer=5)
        got = [s.attrs for s in profiler.spans() if s.id not in seen
               and s.name == "topics.kda_prefill"]
    assert got == [{"layer": i, "rows": 2, "tokens": 75, "chunks": 3,
                    "kernel_launches": n} for i, n in ((4, 0), (5, 1))]
    assert launching.launches == 1


def _rel_mse(a, b):
    return float((a.double() - b.double()).pow(2).sum()
                 / b.double().pow(2).sum())


@pytest.mark.cuda
def test_kernel_matches_the_twin_on_the_card():
    """On the card, at 32 heads of 128 over 8 ragged rows (lengths 1 to
    3,960, across the conv's width and the chunk's edges): the output
    within one bf16 step of the twin's, the final states within 1e-7
    relative MSE, the conv states bit for bit; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    H, D = 32, kda.HEAD_DIM
    W = H * D
    lengths = [1, 3, 63, 64, 65, 1270, 3960, 700]
    rows, N = _rows(lengths), sum(lengths)
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale
                ).to(dtype)

    args = (rnd(N, 3 * W + 2 * D + H), rnd(2, N, W, scale=0.3),
            rnd(3 * W, 4, scale=0.5),
            torch.rand(H, device=dev, generator=g) * 2.7,
            rnd(W, dtype=torch.float32) - 4, rnd(W, scale=0.1),
            1 + rnd(D, scale=0.1), 1e-5)
    st, cv = (torch.full((8, H, D, D), 7.0, device=dev),
              torch.full((8, 3, 3 * W), 7.0, device=dev,
                         dtype=torch.bfloat16))
    st2, cv2 = st.clone(), cv.clone()
    before = kda.kda_prefill.launches
    with torch.inference_mode():
        o = kda.kda_prefill(*args, rows, st, cv)
        o2 = kda.kda_prefill_plain(*args, rows, st2, cv2)
    torch.cuda.synchronize()
    assert kda.kda_prefill.launches == before + 1
    torch.testing.assert_close(o.float(), o2.float(), atol=2e-2, rtol=1e-2)
    for r in range(8):
        assert _rel_mse(st[r], st2[r]) <= 1e-7, (lengths[r],
                                                 _rel_mse(st[r], st2[r]))
    assert torch.equal(cv, cv2)
