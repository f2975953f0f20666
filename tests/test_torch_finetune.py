"""The port's fine-tuning entry point (training/finetune.py) against the
JAX package's on the same manifests and weights, on the CPU: label
encoding, manifests and batches, a 4-step ``finetune`` loss history,
``evaluate``, bitwise resume, eval metrics in the checkpoint metadata,
the YAML CLI, a data-parallel ZeRO-1 run in two processes against one
process, and the card as the default device.

The manifests hold tones over noise, not the pure tones of
tests/test_finetune.py's ``_tiny_setup``: a pure tone leaves most mel
bins at spectral-leakage level, where two fp32 DFTs that sum in another
order differ by ~1% (features up to 0.024 apart), which no fbank
tolerance covers. The model is ``_tiny_setup``'s config."""

import json

import numpy as np
import pytest
import torch

from audio_processor_tpu.io import wav
from audio_processor_tpu.models import wav2vec2bert as jw
from audio_processor_tpu.models.tokenizer import CTCVocab as JVocab
from audio_processor_tpu.training import finetune as jft
from audio_processor_tpu_torch.dsp.fbank import kaldi_mel_filters
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.models.tokenizer import CTCVocab
from audio_processor_tpu_torch.training import finetune as tft
from audio_processor_tpu_torch.training import train_step as tts

TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, conv_depthwise_kernel_size=7,
            left_max_position_embeddings=8, right_max_position_embeddings=2)
# tests/test_torch_dsp.py's fbank tolerance (fp32, another summation
# order): atol 1e-4 plus rtol 1e-4.
FEAT_ATOL = FEAT_RTOL = 1e-4
LOSS_RTOL = 1e-4          # a loss history after AdamW steps
# Adam moments: of their leaf's max, plus tests/test_torch_multidevice.py's
# gradient floor
MOMENT_RTOL, GRAD_FLOOR = 1e-4, 1e-9
MARGIN = 1e-3             # ids compared only off near ties (ROADMAP.md)
KW = dict(batch_size=4, learning_rate=3e-4, max_audio_sec=0.5,
          checkpoint_every=0, spec_augment=False)


def _manifest(tmp_path, texts=("salam", "labas", "salam", "labas"),
              rates=None, name="train.jsonl"):
    """0.5 s WAVs of a tone in as loud a noise (int16-exact), one row per
    text, at ``rates[i]`` Hz (16 kHz by default)."""
    rng = np.random.default_rng(len(texts))
    rows = []
    for i, txt in enumerate(texts):
        sr = rates[i] if rates else 16000
        t = np.arange(sr // 2) / sr
        x = 0.1 * np.sin(2 * np.pi * (200 + 50 * i) * t) \
            + 0.1 * rng.standard_normal(t.size)
        p = tmp_path / f"{name}-{i}.wav"
        wav.write(p, (np.round(x * 32767) / 32768)[None, :].astype(
            np.float32), sr)
        rows.append({"audio": str(p), "text": txt})
    path = tmp_path / name
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path


@pytest.fixture(scope="module")
def weights():
    """JAX params of _tiny_setup's config and the vocab of both sides."""
    import jax

    jvocab = JVocab.darija_default()
    jcfg = jw.W2VBertConfig(vocab_size=len(jvocab), **TINY)
    params = jw.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, jvocab, CTCVocab(jvocab.vocab)


def _model(weights):
    import jax

    jcfg, params, _, _ = weights
    tcfg = tw.W2VBertConfig(vocab_size=jcfg.vocab_size, **TINY)
    model = tw.Wav2Vec2Bert(tcfg)
    model.load_state_dict(tw.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return model


def _cfgs(manifest, out=None, **kw):
    kw = {**KW, **kw}
    extra = {"output_dir": str(out)} if out is not None else {}
    return (jft.FinetuneConfig(manifest=str(manifest), **extra, **kw),
            tft.FinetuneConfig(manifest=str(manifest), device="cpu",
                               **extra, **kw))


def test_encode_text_and_load_manifest_match_jax(tmp_path, weights):
    _, _, jvocab, vocab = weights
    for text in ("ab c", "a#b", "Salam Labas", "سلام عليكم 12", ""):
        assert tft.encode_text(text, vocab) == jft.encode_text(text, jvocab)
    p = tmp_path / "m.jsonl"
    p.write_text('{"audio": "a.wav", "text": "x"}\n\n'
                 '{"audio": "b.wav", "text": "y"}\n')
    assert tft.load_manifest(p) == jft.load_manifest(p)


def test_make_batch_matches_jax(tmp_path, weights):
    """A short batch (3 rows of 4, one at 8 kHz through resample_np):
    labels and masks equal, features within the fbank tolerance; for the
    8 kHz row, on the mel bins that lie wholly below its 4 kHz Nyquist
    frequency (above it only the resampler's stopband is left, as
    ill-conditioned as a pure tone's leakage)."""
    _, _, jvocab, vocab = weights
    manifest = _manifest(tmp_path, ("salam", "wakha bzaf", "la"),
                         rates=(16000, 8000, 16000))
    jcfg, tcfg = _cfgs(manifest)
    rows = jft.load_manifest(manifest)
    ref = jft._make_batch(rows, jcfg, jvocab)
    got = tft._make_batch(rows, tcfg, vocab)
    assert got["labels"].dtype == torch.int64
    for key in ("labels", "label_mask", "feature_mask"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key], key)
    assert got["feature_mask"][3].sum() == 0         # the zero-padded row
    feats = got["features"].numpy()
    np.testing.assert_allclose(feats[[0, 2, 3]], ref["features"][[0, 2, 3]],
                               atol=FEAT_ATOL, rtol=FEAT_RTOL)
    hz = np.arange(257) * 16000 / 512
    below = kaldi_mel_filters()[hz > 4000].sum(0) == 0       # [80]
    assert 50 < below.sum() < 80
    keep = np.tile(below, 2)                     # both stacked sub-frames
    np.testing.assert_allclose(feats[1][:, keep], ref["features"][1][:, keep],
                               atol=FEAT_ATOL, rtol=FEAT_RTOL)


def test_finetune_loss_history_matches_jax(tmp_path, weights):
    """4 steps, same seed and weights, SpecAugment off on both (the JAX
    default is on, and the two PRNGs differ): the loss histories (steps
    0 and 3) within 1e-4 relative, and the same files written."""
    jcfg_m, params, jvocab, vocab = weights
    manifest = _manifest(tmp_path)
    jc, _ = _cfgs(manifest, tmp_path / "jax", num_steps=4)
    _, tc = _cfgs(manifest, tmp_path / "port", num_steps=4)
    _, ref = jft.finetune(jc, model_cfg=jcfg_m, params=params, vocab=jvocab)
    _, got = tft.finetune(tc, model=_model(weights), vocab=vocab)
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert (tmp_path / "port" / "step_4" / "params.pt").exists()
    assert (tmp_path / "port" / "state_latest" / tft.STATE_FILE).exists()


def test_evaluate_matches_jax(tmp_path, weights):
    """3 rows at batch 2 (an uneven final batch): loss (the one full
    batch) within 1e-5 relative; WER and CER equal, the port's logits
    having no frame whose top-2 margin is under 1e-3."""
    import jax

    jcfg_m, params, jvocab, vocab = weights
    # A 100x lm_head on both sides spreads the random model's logits, so
    # that no frame is a near tie.
    params = {**params, "lm_head": jax.tree.map(lambda a: 100 * a,
                                                params["lm_head"])}
    manifest = _manifest(tmp_path, ("salam", "labas", "wakha"))
    jc, tc = _cfgs(manifest, batch_size=2)
    rows = jft.load_manifest(manifest)
    model = _model((jcfg_m, params) + weights[2:])
    ref = jft.evaluate(params, jcfg_m, jvocab, rows, jc)
    got = tft.evaluate(model, vocab, rows, tc)
    assert got["num_utterances"] == ref["num_utterances"] == 3
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    with torch.no_grad():
        for start in (0, 2):
            b = tft._make_batch(rows[start:start + 2], tc, vocab)
            logits = model(b["features"], b["feature_mask"].bool())
            top2 = logits.topk(2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1])[b["feature_mask"] > 0]
            assert float(margin.min()) > MARGIN
    assert (got["wer"], got["cer"]) == (ref["wer"], ref["cer"])


def test_resume_restores_exact_state(tmp_path, weights):
    """resume=True with num_steps == the saved step runs no step and
    gives back bitwise the saved params, both Adam moments and step."""
    manifest = _manifest(tmp_path)
    _, tc = _cfgs(manifest, tmp_path / "out", num_steps=3)
    trained, _ = tft.finetune(tc, model=_model(weights), vocab=weights[3])
    saved = {k: v.clone() for k, v in trained.state_dict().items()}
    blob = torch.load(tmp_path / "out" / "state_latest" / tft.STATE_FILE,
                      weights_only=True)
    tc.resume = True
    seen = []
    resumed, losses = tft.finetune(
        tc, model=_model(weights), vocab=weights[3],
        on_step=lambda step, *a: seen.append(step))
    assert losses == [] and seen == []
    for name, t in resumed.state_dict().items():
        assert torch.equal(t, saved[name]), name
    state = tts.init_state(resumed, tts.make_optimizer())
    state = tft.load_train_state(state, tmp_path / "out")
    assert state.step == 3
    moments = tts.named_moments(state)
    assert moments["step"] == 3
    for i, (name, _) in enumerate(resumed.named_parameters()):
        st = blob["optimizer"]["state"][i]
        assert torch.equal(moments["exp_avg"][name], st["exp_avg"])
        assert torch.equal(moments["exp_avg_sq"][name], st["exp_avg_sq"])


def test_resume_runs_only_the_remaining_steps(tmp_path, weights):
    """After 3 steps, num_steps 5 with resume runs steps 3 and 4 alone,
    from the restored moments (the Adam step count goes on to 5)."""
    manifest = _manifest(tmp_path)
    _, tc = _cfgs(manifest, tmp_path / "out", num_steps=3)
    tft.finetune(tc, model=_model(weights), vocab=weights[3])
    tc.resume, tc.num_steps = True, 5
    seen = []
    _, losses = tft.finetune(
        tc, model=_model(weights), vocab=weights[3],
        on_step=lambda step, state, loss, times: seen.append(
            (step, tts.named_moments(state)["step"])))
    assert seen == [(3, 4), (4, 5)]
    assert len(losses) == 1 and np.isfinite(losses[0])   # the last step


def test_on_step_reports_times_and_gradients(tmp_path, weights):
    manifest = _manifest(tmp_path)
    _, tc = _cfgs(manifest, tmp_path / "out", num_steps=2,
                  spec_augment=True)
    seen = []

    def on_step(step, state, loss, times):
        seen.append((step, state.step, set(times)))
        assert times["frames"] == 4 * 24       # 4 rows of 0.5 s, 20 ms
        assert torch.isfinite(loss)
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in state.model.parameters())

    tft.finetune(tc, model=_model(weights), vocab=weights[3],
                 on_step=on_step)
    keys = {"prep_s", "fwd_bwd_s", "opt_s", "frames"}
    assert seen == [(0, 1, keys), (1, 2, keys)]


def test_eval_during_finetune_writes_metrics(tmp_path, weights):
    manifest = _manifest(tmp_path)
    out = tmp_path / "out"
    _, tc = _cfgs(manifest, out, num_steps=2, eval_manifest=str(manifest))
    tft.finetune(tc, model=_model(weights), vocab=weights[3])
    meta = json.loads((out / "step_2" / "metadata.json").read_text())
    assert set(meta["eval"]) >= {"wer", "cer", "loss"}
    assert np.isfinite(meta["eval"]["loss"]) and meta["step"] == 2
    assert meta["config"]["hidden_size"] == TINY["hidden_size"]
    assert meta["vocab"] == weights[3].vocab


def test_cli_main_validates_and_dispatches(tmp_path, monkeypatch):
    pytest.importorskip("yaml")
    seen = {}
    monkeypatch.setattr(tft, "finetune",
                        lambda cfg: (seen.setdefault("cfg", cfg), [1.0]))
    good = tmp_path / "cfg.yaml"
    good.write_text("manifest: m.jsonl\nnum_steps: 3\ndevice: cpu\n")
    assert tft.main([str(good)]) == 0
    assert (seen["cfg"].manifest, seen["cfg"].num_steps,
            seen["cfg"].device) == ("m.jsonl", 3, "cpu")
    bad = tmp_path / "bad.yaml"
    bad.write_text("not_a_field: 1\n")
    with pytest.raises(SystemExit):
        tft.main([str(bad)])


def test_cli_main_without_yaml_says_so(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("num_steps: 3\n")
    with pytest.raises(SystemExit):
        tft.main([str(cfg)])
    assert "pyyaml is not installed" in capsys.readouterr().err


# One rank of a data-parallel fine-tuning run with ZeRO-1 (gloo, CPU).
RANK_WORKER = r"""
import json, sys
import torch
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.models.tokenizer import CTCVocab
from audio_processor_tpu_torch.parallel.distributed import (
    initialize_distributed,
)
from audio_processor_tpu_torch.training import finetune as tft

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
initialize_distributed(spec["init"], num_processes=2,
                       process_id=int(sys.argv[2]), backend="gloo",
                       timeout_s=60)
model = tw.Wav2Vec2Bert(tw.W2VBertConfig(**spec["model"]))
model.load_state_dict(torch.load(spec["weights"]))
losses = []
tft.finetune(tft.FinetuneConfig(**spec["cfg"]), model=model,
             vocab=CTCVocab.darija_default(),
             on_step=lambda step, state, loss, times: losses.append(
                 float(loss)))
print(json.dumps(losses))
"""


def test_finetune_under_a_mesh_matches_one_process(tmp_path, weights):
    """``mesh_shape: {data: 2}`` with ``zero1`` in two gloo processes
    (each decodes its half of every global batch, SpecAugment drawn for
    the global batch) against one process on the same manifest: every
    step's loss within 1e-4, and rank 0's resume point, in the
    single-device format, loads into a one-process state whose moments
    are within 1e-4 of their leaf's max of the one-process run's, and
    whose params are all but 0.1% within lr / 100 of them (Adam moves an
    element whose gradient sits at the fp32 noise floor by up to lr
    either way each step, tests/test_torch_multidevice.py)."""
    from audio_processor_tpu_torch.parallel import launch

    model = _model(weights)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    base = dict(manifest=str(_manifest(tmp_path)), device="cpu",
                num_steps=3, **{**KW, "spec_augment": True})
    spec = {"init": launch.file_init_method(tmp_path),
            "weights": str(tmp_path / "w.pt"),
            "model": {"vocab_size": model.cfg.vocab_size, **TINY},
            "cfg": {**base, "output_dir": str(tmp_path / "mesh"),
                    "mesh_shape": {"data": 2}, "zero1": True}}
    outs = launch.run_ranks(
        lambda r: launch.python_argv(RANK_WORKER, json.dumps(spec), str(r),
                                     module=False), 2, 180)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    one_losses, one_states = [], []

    def on_step(step, state, loss, times):
        one_losses.append(float(loss))
        one_states.append(state)

    one, _ = tft.finetune(
        tft.FinetuneConfig(**base, output_dir=str(tmp_path / "one")),
        model=_model(weights), vocab=CTCVocab.darija_default(),
        on_step=on_step)
    assert len(one_losses) == 3 and ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0], one_losses, rtol=LOSS_RTOL)
    assert not (tmp_path / "mesh" / "state_latest" / (
        tft.STATE_FILE + ".tmp")).exists()
    state = tft.load_train_state(
        tts.init_state(_model(weights), tts.make_optimizer(KW[
            "learning_rate"])), tmp_path / "mesh")
    assert state.step == 3
    got, want = tts.named_moments(state), tts.named_moments(one_states[-1])
    assert got["step"] == want["step"] == 3
    # The gradient floor: a gradient that is zero in exact arithmetic (a
    # key bias under softmax) is fp32 noise of the largest gradient.
    gmax = max(float(t.abs().max()) for t in want["exp_avg"].values()) * 10
    for key, floor in (("exp_avg", GRAD_FLOOR * gmax),
                       ("exp_avg_sq", (GRAD_FLOOR * gmax) ** 2)):
        assert set(got[key]) == set(want[key])
        for name, ref in want[key].items():
            np.testing.assert_allclose(
                got[key][name].numpy(), ref.numpy(), rtol=0,
                atol=MOMENT_RTOL * float(ref.abs().max()) + floor,
                err_msg=f"{key} {name}")
    loose = total = 0
    for name, p in one.named_parameters():
        d = (state.model.get_parameter(name).detach() - p.detach()).abs()
        loose += int((d > KW["learning_rate"] / 100).sum())
        total += d.numel()
    assert loose <= 1e-3 * total, (loose, total)


def test_finetune_runs_on_the_card_unless_asked(tmp_path):
    """``device`` defaults to "cuda", and with no CUDA device the run
    fails instead of falling back to the CPU."""
    cfg = tft.FinetuneConfig(manifest=str(_manifest(tmp_path)),
                             output_dir=str(tmp_path / "out"), **KW)
    assert cfg.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tft.finetune(cfg, model_cfg=tw.W2VBertConfig(vocab_size=78, **TINY))
