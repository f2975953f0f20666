"""The text decoder's decode attention (models/decode_attention.py): its
plain version, which the CPU runs, against the chain of PyTorch ops the
decoder's steps ran before the kernel (kept below as ``_chain``), the
self mode's cache write, masking, and what the wrapper refuses.

The CUDA kernel runs only on the card. The tests marked ``cuda`` hold it
against the plain version there and skip without a card; this file
imports no JAX, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_attention.py

Tolerances. fp32: bit for bit against the chain (the plain version runs
the same ops on the same layouts). bf16: the chain rounds the scores and
the probabilities to bf16 before the products, the plain version keeps
them in fp32. With scores of about one unit (q, k ~ N(0, 1)) the two
differed by at most 7.8e-3 over 120 cases, one bf16 step at outputs of
1 to 2 against outputs up to 4: atol 1.6e-2, a step at 2 to 4. Scores
of several units round to bf16 steps of 1e-2 and more (0.13 apart at
q, k ~ N(0, 9)), which is the chain's own error. The kernel against the
plain version on the card differs only in the order of fp32 sums: fp32
atol 1e-5, bf16 one rounding of the output (rtol 1e-2 > 2^-7).
"""

import pytest
import torch

from audio_processor_tpu_torch.models import decode_attention as da
from audio_processor_tpu_torch.models import seamless_s2t as s2t

NEG = torch.finfo(torch.float32).min
R, H, D = 3, 4, 64
C = 96                 # cache positions: three windows of 32
SCALE = D ** -0.5


def _chain(q, k, v, bias):
    """The decoder's attention before the kernel, verbatim: scaled q [B,
    nh, 1, d] over k, v [B, nh, Lk, d] with an additive fp32 bias."""
    s = (q @ k.transpose(-1, -2)).float() + bias
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = p @ v
    B, nh, Lq, d = out.shape
    return out.transpose(1, 2).reshape(B, Lq, nh * d)


def _heads(x):
    """[R, H*d] -> [R, H, 1, d], as the decoder split its projections."""
    return x.view(R, 1, H, -1).transpose(1, 2)


def _inputs(seed, dtype, Lk=C, scale=3.0):
    """q, k_new, v_new [R, H*d] and caches [R, H, Lk, d]; q and keys
    scaled so that the softmax is far from uniform."""
    g = torch.Generator().manual_seed(seed)
    q, k_new, v_new = (torch.randn(R, H * D, generator=g) for _ in range(3))
    k, v = (torch.randn(R, H, Lk, D, generator=g) for _ in range(2))
    return (scale * q).to(dtype), (scale * k_new).to(dtype), \
        v_new.to(dtype), (scale * k).to(dtype), v.to(dtype)


def _old_self(q, k_new, v_new, k, v, pos, window):
    """The old self-attention: cache writes, then the chain over the
    window with the positions past ``pos`` masked."""
    k.index_copy_(2, pos, _heads(k_new))
    v.index_copy_(2, pos, _heads(v_new))
    bias = torch.where(torch.arange(C)[:window] <= pos, 0.0, NEG)
    return _chain(_heads(q) * SCALE, k[:, :, :window], v[:, :, :window],
                  bias)[:, 0]


def _cross_bias(valid, Lk):
    """[R, Lk] fp32: 0 on each row's first ``valid`` frames, NEG after."""
    mask = torch.arange(Lk)[None] < torch.tensor(valid)[:, None]
    return torch.where(mask, 0.0, NEG)


def _window(p):
    return min(-(-(p + 1) // s2t.WINDOW) * s2t.WINDOW, C)


def test_plain_is_the_old_chain_bit_for_bit_in_fp32():
    """Self mode at positions up to and across the window edges 31/32 and
    63/64, and cross mode over ragged frames with a row of none: equal to
    the old chain bit for bit, caches included."""
    for pos in (0, 5, 30, 31, 32, 33, 63, 64, 95):
        q, kn, vn, k, v = _inputs(pos, torch.float32)
        k2, v2 = k.clone(), v.clone()
        p = torch.tensor([pos])
        want = _old_self(q, kn, vn, k, v, p, _window(pos))
        got = da.decode_attention(q, k2, v2, SCALE, pos=p, k_new=kn,
                                  v_new=vn, window=_window(pos))
        assert torch.equal(got, want), pos
        assert torch.equal(k2, k) and torch.equal(v2, v), pos
    q, _, _, k, v = _inputs(7, torch.float32, Lk=41)
    bias = _cross_bias([41, 17, 0], 41)
    want = _chain(_heads(q) * SCALE, k, v, bias[:, None, None, :])[:, 0]
    assert torch.equal(da.decode_attention(q, k, v, SCALE, bias=bias), want)


def test_plain_agrees_with_the_old_chain_in_bf16():
    """Within the tolerance, and nearer than the chain to the fp32 result
    of the same bf16 inputs."""
    err_plain = err_chain = 0.0
    for pos in (0, 31, 32, 70, None):
        q, kn, vn, k, v = _inputs(11 + (pos or 0), torch.bfloat16,
                                  Lk=41 if pos is None else C, scale=1.0)
        f32 = [t.float() for t in (q, k, v)]
        if pos is None:
            bias = _cross_bias([41, 17, 0], 41)
            want = _chain(_heads(q) * SCALE, k, v,
                          bias[:, None, None, :])[:, 0]
            got = da.decode_attention(q, k, v, SCALE, bias=bias)
            exact = da.decode_attention(*f32, SCALE, bias=bias)
        else:
            k2, v2, k3, v3 = k.clone(), v.clone(), f32[1], f32[2]
            p = torch.tensor([pos])
            want = _old_self(q, kn, vn, k, v, p, _window(pos))
            got = da.decode_attention(q, k2, v2, SCALE, pos=p, k_new=kn,
                                      v_new=vn, window=_window(pos))
            assert torch.equal(k2, k) and torch.equal(v2, v)
            exact = da.decode_attention(f32[0], k3, v3, SCALE, pos=p,
                                        k_new=kn.float(), v_new=vn.float())
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2,
                                   rtol=0)
        err_plain += float((got.float() - exact).norm())
        err_chain += float((want.float() - exact).norm())
    assert err_plain < err_chain


def test_self_mode_writes_the_cache_at_pos_and_nowhere_else():
    q, kn, vn, k, v = _inputs(1, torch.float32)
    k0, v0 = k.clone(), v.clone()
    da.decode_attention(q, k, v, SCALE, pos=torch.tensor([40]), k_new=kn,
                        v_new=vn)
    for cache, before, new in ((k, k0, kn), (v, v0, vn)):
        assert torch.equal(cache[:, :, 40], new.view(R, H, D))
        keep = torch.ones(C, dtype=torch.bool)
        keep[40] = False
        assert torch.equal(cache[:, :, keep], before[:, :, keep])


def test_self_mode_attends_over_positions_up_to_pos_only():
    """Against a dense softmax over cache positions 0 .. pos, whatever
    the later positions hold, with and without a window."""
    q, kn, vn, k, v = _inputs(2, torch.float32)
    pos = 44
    k[:, :, pos + 1:] = 1e4            # would dominate if read
    want = None
    for window in (None, 64, 96):
        got = da.decode_attention(q, k, v, SCALE, pos=torch.tensor([pos]),
                                  k_new=kn, v_new=vn, window=window)
        if want is None:
            s = (_heads(q) * SCALE) @ k[:, :, :pos + 1].transpose(-1, -2)
            o = torch.softmax(s, dim=-1) @ v[:, :, :pos + 1]
            want = o.transpose(1, 2).reshape(R, H * D)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_a_row_with_no_valid_frame_weighs_every_frame_alike():
    """finfo.min swallows every score of a row with no valid frame, so the
    row's output is the mean of its values, as the old chain gave."""
    q, _, _, k, v = _inputs(3, torch.float32, Lk=20)
    bias = _cross_bias([20, 0, 5], 20)
    got = da.decode_attention(q, k, v, SCALE, bias=bias)
    mean = v[1].mean(dim=1).reshape(H * D)
    torch.testing.assert_close(got[1], mean, atol=1e-6, rtol=1e-5)


def test_wrapper_refuses_what_it_does_not_take():
    q, kn, vn, k, v = _inputs(4, torch.float32)
    pos = torch.tensor([3])
    bad = [
        dict(q=q.half(), k=k.half(), v=v.half()),                # dtype
        dict(q=q.bfloat16()),                                    # mixed
        dict(q=q[:2]),                                           # rows
        dict(v=v[:, :, :50]),                                    # k != v
        dict(q=q.view(R, H, D)),                                 # q rank
        dict(pos=pos.int()),                                     # pos dtype
        dict(pos=torch.tensor([[3]])),                           # pos shape
        dict(pos=pos, k_new=None),                               # no k_new
        dict(pos=pos, v_new=vn.bfloat16()),                      # v_new dtype
        dict(pos=None, bias=None),                               # no pos
        dict(pos=pos, bias=torch.zeros(R, C)),                   # self + bias
        dict(pos=None, k_new=None, v_new=None,
             bias=torch.zeros(R, C - 1)),                        # bias shape
        dict(pos=None, k_new=None, v_new=None,
             bias=torch.zeros(R, C, dtype=torch.float64)),       # bias dtype
    ]
    for case in bad:
        args = dict(q=q, k=k, v=v, pos=pos, k_new=kn, v_new=vn, bias=None)
        args.update(case)
        with pytest.raises(ValueError):
            da.decode_attention(args.pop("q"), args.pop("k"), args.pop("v"),
                                SCALE, **args)
    # the kernel's own limit: head size 64 (the plain version takes any)
    small = torch.zeros(R, H, 5, 32)
    with pytest.raises(ValueError, match="head dim"):
        da._check(torch.zeros(R, H * 32), small, small, None, None, None,
                  None, kernel=True)
    # what every kernel of csrc/ assumes: contiguous, 16-byte aligned
    k_strided = k.transpose(2, 3).contiguous().transpose(2, 3)
    q_off = torch.zeros(R * H * D + 1)[1:].view(R, H * D)
    for qq, kk in ((q, k_strided), (q_off, k)):
        with pytest.raises(ValueError, match="contiguous|aligned"):
            da._launch(qq, kk, v, SCALE, None, None, None, None)


def test_wrapper_refuses_autograd_and_other_devices():
    q, _, _, k, v = _inputs(5, torch.float32, Lk=8)
    before = da.decode_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q.requires_grad_(), k, v, SCALE)
    q = q.detach()
    with torch.no_grad():
        da.decode_attention(q.requires_grad_(), k, v, SCALE)   # plain
    q = q.detach()
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        da.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), SCALE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):      # no nvcc, no card: no build
            da._launch(q, k, v, SCALE, None, None, None, None)
    assert da.decode_attention.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(card, dtype):
    """Self mode at 0/31/32/95 (caches and pos on the card, NaN for a pos
    past the cache), cross mode over ragged frames with a row of none."""
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=1e-3, rtol=1e-2)
    for p in (0, 31, 32, 95):
        q, kn, vn, k, v = (t.to(card) for t in _inputs(p, dtype))
        kp, vp = k.clone(), v.clone()
        pos = torch.tensor([p], device=card)
        got = da.decode_attention(q, k, v, SCALE, pos=pos, k_new=kn,
                                  v_new=vn)
        want = da.decode_attention_plain(q, kp, vp, SCALE, pos=pos,
                                         k_new=kn, v_new=vn)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(k, kp) and torch.equal(v, vp)
    past = torch.tensor([C], device=card)
    got = da.decode_attention(q, k, v, SCALE, pos=past, k_new=kn, v_new=vn)
    assert bool(got.float().isnan().all())
    q, _, _, k, v = (t.to(card) for t in _inputs(9, dtype, Lk=161))
    bias = _cross_bias([157, 94, 0], 161).to(card)
    torch.testing.assert_close(
        da.decode_attention(q, k, v, SCALE, bias=bias).float(),
        da.decode_attention_plain(q, k, v, SCALE, bias=bias).float(), **tol)


@pytest.mark.cuda
def test_decoder_graph_spans_count_two_launches_per_layer_and_step(card):
    """A small decoder's loop on the card: every ``decoder.graph`` span's
    ``attn_launches`` is 2 x layers x its steps, and the wrapper's count
    grows by as much."""
    from audio_processor_tpu_torch.obs import profiler

    cfg = s2t.S2TConfig(hidden_size=128, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=256,
                        decoder_layers=3, decoder_attention_heads=2,
                        decoder_ffn_dim=256, vocab_size=300)
    model = s2t.build_synthetic(cfg, card, seed=2,
                                rule=s2t.DecodeRule(40, 0.6, 8))
    dec = model.text_decoder
    g = torch.Generator(device=card).manual_seed(0)
    enc = torch.randn(4, 12, 128, device=card, generator=g)
    mask = torch.arange(12, device=card)[None] < torch.tensor(
        [12, 9, 3, 0], device=card)[:, None]
    caps = torch.tensor([40, 30, 10, 0], device=card)
    before = da.decode_attention.launches
    with torch.inference_mode(), profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        for _ in range(2):                          # capture, then replay
            dec.generate(enc, mask, caps, 40, 299)
        spans = [s for s in profiler.spans() if s.id not in seen
                 and s.name == "decoder.graph"]
    steps = sum(s.attrs["steps"] for s in spans)
    assert steps == 2 * 41
    assert all(s.attrs["attn_launches"] == 2 * 3 * s.attrs["steps"]
               for s in spans)
    assert da.decode_attention.launches - before == 2 * 3 * steps
