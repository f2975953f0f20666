"""The port's CTC fine-tuning step (training/train_step.py) against the
JAX package's on the same numpy inputs, on the CPU: ``ctc_loss`` against
``optax.ctc_loss``, SpecAugment's mask rules, one and three AdamW steps
against the JAX ``train_step`` on weights from ``params_from_jax``
(fp32, no augment), remat, SpecAugment's global draw for a rank's rows,
and the refusals (kernels under autograd, one-process meshes)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_processor_tpu.models import wav2vec2bert as jw
from audio_processor_tpu.training import train_step as jts
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.training import train_step as tts

KW = dict(vocab_size=40, hidden_size=128, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=256,
          conv_depthwise_kernel_size=7)
LR = 1e-4
# fp32 on both sides, another summation order.
LOSS_RTOL = 1e-5
# A gradient leaf within 1e-4 of its own max |g|, plus a floor of 1e-9
# of the model's max |g| for leaves that are zero in exact arithmetic
# (linear_k.bias: softmax ignores a per-query constant), which hold
# rounding noise (~1e-10) on both sides.
GRAD_LEAF_RTOL, GRAD_FLOOR = 1e-4, 1e-9
# After 3 AdamW steps. Adam moves each element by ~lr whatever its
# gradient's size, so an element whose gradient sits at the fp32 noise
# floor (|g| ~ 1e-8, the size of eps) moves differently on the two
# sides: every element within lr, all but 0.1% within lr / 100
# (measured: 0.68 lr and 0.015%). Moments: 1e-4 of the leaf's max plus
# the gradient floor (squared for the second moment).
PARAM_ATOL, PARAM_TIGHT, PARAM_LOOSE_SHARE = LR, LR / 100, 1e-3
MOMENT_RTOL = 1e-4


def _jax_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """JAX params, a port model with the same weights, and a batch with
    ragged feature masks, ragged labels and an adjacent repeat."""
    import jax

    jcfg = jw.W2VBertConfig(**KW)
    tcfg = tw.W2VBertConfig(**KW)
    params = jw.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    B, T, N = 4, 48, 10
    fm = np.ones((B, T), np.float32)
    fm[1, 30:] = 0.0
    fm[2, 20:] = 0.0
    labels = rng.integers(1, KW["vocab_size"], (B, N)).astype(np.int32)
    lm = np.ones((B, N), np.float32)
    lm[0, 7:] = 0.0
    lm[2, 5:] = 0.0
    labels[0, 2] = labels[0, 1]                      # a repeat
    labels[lm == 0] = 0
    batch = {"features": rng.standard_normal((B, T, 160)).astype(np.float32),
             "feature_mask": fm, "labels": labels, "label_mask": lm}
    return jcfg, tcfg, params, batch


def _port_model(setup):
    _, tcfg, params, _ = setup
    model = tw.Wav2Vec2Bert(tcfg)
    model.load_state_dict(tw.params_from_jax(_jax_tree(params), tcfg))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_grads(model, ref_sd):
    gmax = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        ref = ref_sd[name].numpy()
        tol = GRAD_LEAF_RTOL * np.abs(ref).max() + GRAD_FLOOR * gmax
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=tol,
                                   err_msg=name)


def _ctc_inputs():
    """Rows: full, masked frames, adjacent repeats, empty labels, labels
    that cannot fit their frames (a repeat included), and a run of
    repeats that fits exactly."""
    rng = np.random.default_rng(1)
    B, T, K, N = 6, 16, 12, 8
    logits = (2 * rng.standard_normal((B, T, K))).astype(np.float32)
    lp = np.zeros((B, T), np.float32)
    lp[1, 11:] = 1.0
    lp[4, 5:] = 1.0
    lp[5, 9:] = 1.0
    labels = rng.integers(1, K, (B, N)).astype(np.int32)
    lpad = np.zeros((B, N), np.float32)
    lpad[0, 6:] = 1.0
    lpad[1, 4:] = 1.0
    labels[2, :4] = [3, 3, 5, 5]
    lpad[3, :] = 1.0
    labels[4, :3] = [7, 7, 2]                # 7 labels + 1 repeat > 5
    lpad[4, 7:] = 1.0
    labels[5, :5] = [4, 4, 4, 4, 4]          # 5 + 4 repeats = 9 frames
    lpad[5, 5:] = 1.0
    labels[lpad == 1] = 0
    return logits, lp, labels, lpad


def test_ctc_loss_matches_optax():
    """Loss per sequence within 1e-5 relative on the rows that fit and
    1e-3 on the row that does not; gradients (|g| <= 1) against
    jax.grad: 1e-5 absolute plus 1e-5 relative on the rows that fit, and on the infeasible row 1e-6 against optax in
    float64 (the port's recursion runs in float64; optax in fp32 is
    ~2e-3 from both there, its own rounding at a loss of ~1e5)."""
    import jax
    import optax

    logits, lp, labels, lpad = _ctc_inputs()
    ref = np.asarray(optax.ctc_loss(logits, lp, labels, lpad))
    grad_ref = np.asarray(jax.grad(
        lambda x: optax.ctc_loss(x, lp, labels, lpad).sum())(logits))
    with jax.enable_x64(True):
        grad64 = np.asarray(jax.grad(
            lambda x: optax.ctc_loss(x, lp, labels, lpad).sum())(
                logits.astype(np.float64)))
    x = torch.tensor(logits, requires_grad=True)
    got = tts.ctc_loss(x, torch.tensor(lp), torch.tensor(labels),
                       torch.tensor(lpad))
    got.sum().backward()
    got = got.detach().numpy()
    fits = np.array([True, True, True, True, False, True])
    assert ref[4] > 1e4 and np.isfinite(ref).all()
    np.testing.assert_allclose(got[fits], ref[fits], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[~fits], ref[~fits], rtol=1e-3)
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g[fits], grad_ref[fits], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g[~fits], grad64[~fits], rtol=0, atol=1e-6)
    np.testing.assert_allclose(g[~fits], grad_ref[~fits], rtol=0, atol=5e-3)


def test_infeasible_row_is_finite_where_torch_ctc_is_inf():
    """The trap: ``F.ctc_loss`` gives inf (and NaN gradients) on a row
    whose labels cannot fit its frames; the port gives optax's finite
    loss and finite gradients on every row of the batch."""
    logits, lp, labels, lpad = _ctc_inputs()
    frames = torch.tensor((1 - lp).sum(1), dtype=torch.long)
    lens = torch.tensor((1 - lpad).sum(1), dtype=torch.long)
    lsm = torch.log_softmax(torch.tensor(logits), -1).transpose(0, 1)
    plain = F.ctc_loss(lsm, torch.tensor(labels).long(), frames, lens,
                       reduction="none")
    assert torch.isinf(plain[4]) and torch.isfinite(plain[:4]).all()
    x = torch.tensor(logits, requires_grad=True)
    loss = tts.ctc_loss(x, torch.tensor(lp), torch.tensor(labels),
                        torch.tensor(lpad)).mean()
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(x.grad).all()


def test_ctc_loss_non_prefix_padding_matches_optax():
    """A padded frame inside a row (not a prefix mask) takes the
    recursion, as optax skips such frames."""
    import optax

    logits, lp, labels, lpad = _ctc_inputs()
    lp = lp.copy()
    lp[0, 3] = lp[2, 7] = 1.0
    ref = np.asarray(optax.ctc_loss(logits, lp, labels, lpad))
    got = tts.ctc_loss(torch.tensor(logits), torch.tensor(lp),
                       torch.tensor(labels), torch.tensor(lpad)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], rtol=LOSS_RTOL)


def test_spec_augment_structure():
    """The structure tests/test_finetune.py asserts of the JAX
    spec_augment, on the port's."""
    B, T, F_ = 3, 64, 160
    feats = torch.ones(B, T, F_)
    aug = tts.SpecAugment(num_time_masks=2, time_mask_span=10,
                          num_freq_masks=1, freq_mask_span=8)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    out = tts.spec_augment(gen(), feats, aug).numpy()
    dropped = out == 0.0
    assert 0.0 < dropped.mean() <= (2 * 10 / T) + (1 * 8 / 80)
    fmask = dropped.all(axis=1)                          # [B, F]
    np.testing.assert_array_equal(fmask[:, :80], fmask[:, 80:])
    t_full = dropped.all(axis=2)
    assert t_full.any(axis=1).all() or fmask.any(axis=1).all()
    np.testing.assert_array_equal(
        out, tts.spec_augment(gen(), feats, aug).numpy())
    none = tts.SpecAugment(0, 0, 0, 0)
    np.testing.assert_array_equal(
        tts.spec_augment(gen(), feats, none).numpy(), feats.numpy())


def test_spec_augment_rows_of_a_global_batch():
    """A data-parallel rank's rows are masked as the single-device step
    masks them: the starts of every global row are drawn, and each rank
    keeps its own."""
    feats = torch.randn(8, 40, 160, generator=torch.Generator()
                        .manual_seed(1))
    aug = tts.SpecAugment()
    gen = lambda: tts.step_generator(3, 5, torch.device("cpu"))  # noqa: E731
    whole = tts.spec_augment(gen(), feats, aug)
    for start in (0, 2, 4, 6):
        part = tts.spec_augment(gen(), feats[start:start + 2], aug,
                                row_start=start, global_rows=8)
        assert torch.equal(part, whole[start:start + 2]), start
    assert not torch.equal(tts.spec_augment(gen(), feats[4:6], aug),
                           whole[4:6])


def test_spec_augment_matches_numpy_span_mask():
    """The drop mask equals a numpy restatement of the JAX span_mask
    formula on the starts the generator draws (time first, then bands),
    on features that are not a multiple of mel_bins wide as well."""
    rng = np.random.default_rng(2)
    aug = tts.SpecAugment(num_time_masks=3, time_mask_span=7,
                          num_freq_masks=2, freq_mask_span=9)

    def span_mask(starts, span, idx):
        hit = (idx[None, None, :] >= starts[:, :, None]) \
            & (idx[None, None, :] < starts[:, :, None] + span)
        return hit.any(axis=1)

    for F_ in (160, 90):
        B, T = 4, 50
        feats = rng.standard_normal((B, T, F_)).astype(np.float32) + 5.0
        bins = 80 if F_ % 80 == 0 else F_
        out = tts.spec_augment(torch.Generator().manual_seed(3),
                               torch.from_numpy(feats), aug).numpy()
        g = torch.Generator().manual_seed(3)
        ts = torch.randint(0, T - 7 + 1, (B, 3), generator=g).numpy()
        fs = torch.randint(0, bins - 9 + 1, (B, 2), generator=g).numpy()
        drop = span_mask(ts, 7, np.arange(T))[:, :, None] \
            | span_mask(fs, 9, np.arange(F_) % bins)[:, None, :]
        np.testing.assert_array_equal(out, np.where(drop, 0.0, feats))


def test_step_generator_depends_on_seed_and_step_only():
    draw = lambda s, k: torch.randint(  # noqa: E731
        0, 1 << 30, (8,), generator=tts.step_generator(s, k, torch.device(
            "cpu")))
    assert torch.equal(draw(1, 5), draw(1, 5))
    assert not torch.equal(draw(1, 5), draw(1, 6))
    assert not torch.equal(draw(1, 5), draw(2, 5))


def test_one_train_step_matches_jax(setup):
    """Loss within 1e-5 relative; every gradient leaf within GRAD_*."""
    import jax
    import jax.numpy as jnp

    jcfg, tcfg, params, batch = setup
    jloss, jgrads = jax.value_and_grad(jts.ctc_loss_fn)(
        params, jcfg, batch, dtype=jnp.float32)
    model = _port_model(setup)
    state = tts.init_state(model, tts.make_optimizer(LR))
    state, loss = tts.train_step(state, _torch_batch(batch),
                                 dtype=torch.float32)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(model, tw.params_from_jax(_jax_tree(jgrads), tcfg))


def test_three_train_steps_match_jax(setup):
    """Losses of 3 steps, then params and both Adam moments (through
    ``moments_from_jax``) and the step count, against the JAX
    ``make_train_step`` with optax.adamw."""
    import jax.numpy as jnp

    jcfg, tcfg, params, batch = setup
    tx = jts.make_optimizer(LR)
    jstate = jts.init_state(params, tx)
    jstep = jts.make_train_step(jcfg, tx, dtype=jnp.float32)
    model = _port_model(setup)
    state = tts.init_state(model, tts.make_optimizer(LR))
    tb = _torch_batch(batch)
    gmax = 0.0
    for _ in range(3):
        jstate, jloss = jstep(jstate, batch)
        state, loss = tts.train_step(state, tb, dtype=torch.float32)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
        gmax = max(gmax, max(float(p.grad.abs().max())
                             for p in model.parameters()))
    ref_p = tw.params_from_jax(_jax_tree(jstate.params), tcfg)
    loose = total = 0
    for name, p in model.named_parameters():
        d = (p.detach() - ref_p[name]).abs()
        assert float(d.max()) <= PARAM_ATOL, name
        loose += int((d > PARAM_TIGHT).sum())
        total += d.numel()
    assert loose <= PARAM_LOOSE_SHARE * total, (loose, total)
    ref_m = tts.moments_from_jax(_jax_tree(jstate.opt_state), tcfg)
    got_m = tts.named_moments(state)
    assert got_m["step"] == ref_m["step"] == 3
    for key, floor in (("exp_avg", GRAD_FLOOR * gmax),
                       ("exp_avg_sq", (GRAD_FLOOR * gmax) ** 2)):
        assert set(got_m[key]) == set(ref_m[key])
        for name, ref in ref_m[key].items():
            ref = ref.numpy()
            np.testing.assert_allclose(
                got_m[key][name].numpy(), ref, rtol=0,
                atol=MOMENT_RTOL * np.abs(ref).max() + floor,
                err_msg=f"{key} {name}")


def test_remat_gives_the_same_logits_and_gradients(setup):
    _, _, _, batch = setup
    tb = _torch_batch(batch)
    out = []
    for remat in (False, True):
        model = _port_model(setup)
        loss = tts.ctc_loss_fn(model, tb, dtype=torch.float32, remat=remat)
        loss.backward()
        with torch.no_grad():
            logits = model(tb["features"], tb["feature_mask"].bool(),
                           remat=remat)
        out.append((float(loss.detach()), logits,
                    {n: p.grad for n, p in model.named_parameters()}))
    (l0, x0, g0), (l1, x1, g1) = out
    assert l0 == l1 and torch.equal(x0, x1)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-9,
                                   msg=name)


def test_kernel_wrappers_refuse_autograd():
    """Every kernel wrapper raises on an operand that requires grad while
    autograd records (checked before the CPU/CUDA branch, so here on the
    CPU as on the card), and runs under inference_mode and no_grad; the
    model under ``flash_rel`` or ``flash`` refuses training."""
    from audio_processor_tpu_torch.models import flash_rel_parts as frp
    from audio_processor_tpu_torch.models.flash_attention import (
        flash_attention,
    )
    from audio_processor_tpu_torch.models.flash_rel_attention import (
        flash_rel_attention,
    )

    g = torch.Generator().manual_seed(0)

    def qkv(L):
        return [torch.randn(1, 2, L, 64, generator=g).to(torch.bfloat16)
                for _ in range(3)]

    (q, k, v), (q6, k6, v6) = qkv(256), qkv(640)
    E = torch.randn(73, 64, generator=g)
    s_rel = torch.randn(1, 2, 256, frp.TABLE, generator=g)
    s_rel6 = torch.randn(1, 2, 640, frp.TABLE, generator=g)
    calls = [
        (q, lambda q: flash_rel_attention(q, k, v, E, torch.ones(1, 256),
                                          0.125, 64, 73)),
        (q, lambda q: flash_attention(q, k, v, None, 0.125)),
        (q, lambda q: frp.variant(q, k, v, s_rel, torch.ones(1, 256))),
        (q6, lambda q: frp.kb640(q, k6, v6, s_rel6, torch.ones(1, 640))),
        (q, lambda q: frp.bare(q, k, v)),
    ]
    for x, call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call(x.clone().requires_grad_())
        with torch.inference_mode():
            call(x.clone().requires_grad_())
        with torch.no_grad():
            call(x.clone().requires_grad_())
        call(x)                          # no operand requires grad
    model = tw.build_synthetic(tw.W2VBertConfig(**KW), torch.device("cpu"))
    feats = torch.randn(1, 256, 160, generator=g)
    for impl in ("flash_rel", "flash"):
        with pytest.raises(RuntimeError, match="no backward"):
            model(feats, attention_impl=impl)
    model(feats, attention_impl="xla").sum().backward()


def test_one_process_meshes_do_not_train(setup):
    """Training over a mesh runs one process per device: a one-process
    mesh of several devices is refused, a mesh of one device is the
    plain step, and a step bound to a mesh refuses a state built without
    it."""
    from audio_processor_tpu_torch.parallel.mesh import make_mesh

    model = _port_model(setup)
    tx = tts.make_optimizer(LR)
    with pytest.raises(ValueError, match="one process per device"):
        tts.init_state(model, tx, mesh=make_mesh(data=2,
                                                 devices=["cpu"] * 2))
    one = make_mesh(data=1, devices=["cpu"])
    state = tts.init_state(model, tx, mesh=one, zero1=True)
    assert state.mesh is None and state.module is None
    assert isinstance(state.optimizer, torch.optim.AdamW)
    with pytest.raises(ValueError, match="not built over this mesh"):
        tts.make_train_step(mesh=one)(state, _torch_batch(setup[3]))


def test_make_optimizer_matches_optax_adamw():
    """AdamW alone: 5 updates of one tensor from seeded gradients, with
    decay, against optax.adamw (same learning rate and weight decay)."""
    import optax

    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((64, 32)).astype(np.float32)
    grads = [rng.standard_normal((64, 32)).astype(np.float32)
             for _ in range(5)]
    tx = optax.adamw(1e-2, weight_decay=0.1)
    jp, js = p0, tx.init(p0)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tts.make_optimizer(1e-2, 0.1)([p])
    for g in grads:
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)
