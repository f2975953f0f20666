"""The port's parallel/ against the JAX package's on the CPU.

The JAX side runs as tests/test_multidevice.py runs it, on the 8 virtual
CPU devices of tests/conftest.py. The port's multi-process strategies run
in gloo processes on the CPU (parallel/launch.py: a ``file://``
rendezvous, a 60 s collective timeout, every rank killed if the group
overruns), on the JAX weights through ``params_from_jax``:

- the data-parallel engine on 8 CPU replicas against the one-device
  engine and the JAX mesh engine;
- dp x tp (2 x 2) with ZeRO-1 and without, the sequence-parallel steps
  (dp x sp, sp x tp), a ZeRO-1 step over data=4 whose resume point loads
  into one process, and the 4-stage pipelined forward, in one 4-rank run;
- the 2-stage pipelined forward and train step in a 2-rank run.

Tolerances: losses 1e-4 relative (tests/test_multidevice.py:305), and the
sequence-parallel loss 1e-3 relative against JAX's dp/tp loss (its
:158); ZeRO-1 against the replicated optimizer rtol 2e-5, atol 2e-6 (its
:307-309); the pipelined forward and step 1e-4 (its :195, :248-251).
Params after one AdamW step in another summation order (another
framework, or another split of the work) use tests/test_torch_train_step.py's
budget: Adam moves an element whose gradient sits at the fp32 noise floor
by up to lr either way, so two sides may differ by 2 lr there (one element
in 8192 does here, against JAX and against the one-device port alike);
all but 0.1% within lr / 100. The moments within 1e-4 of their leaf's max
plus the gradient floor.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_processor_tpu.models import wav2vec2bert as jw
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.parallel import launch
from audio_processor_tpu_torch.parallel.mesh import Mesh, make_mesh
from audio_processor_tpu_torch.parallel.multi_device import (
    MultiDeviceManager,
)
from audio_processor_tpu_torch.training import train_step as tts

REPO = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=36, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128,
          conv_depthwise_kernel_size=7, left_max_position_embeddings=8,
          right_max_position_embeddings=2)
LR = 1e-4
LOSS_RTOL = 1e-4
SP_LOSS_RTOL = 1e-3
ZERO1_RTOL, ZERO1_ATOL = 2e-5, 2e-6
PP_ATOL = 1e-4
PARAM_ATOL, PARAM_TIGHT, PARAM_LOOSE_SHARE = 2 * LR, LR / 100, 1e-3
MOMENT_RTOL, GRAD_FLOOR = 1e-4, 1e-9
RANK_TIMEOUT_S = 240

# One rank of the strategy runs: loads the weights and the batch the test
# wrote, runs each strategy asked for and leaves rank 0's results.
WORKER = r"""
import json, sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from audio_processor_tpu_torch.models import wav2vec2bert as w2v
from audio_processor_tpu_torch.parallel.distributed import (
    initialize_distributed,
)
from audio_processor_tpu_torch.parallel.mesh import (
    gather_params, make_mesh, opt_state_shardings,
)
from audio_processor_tpu_torch.parallel.pipeline import (
    make_pipelined_forward, make_pipelined_train_step, make_stage_mesh,
    stage_parameter_names,
)
from audio_processor_tpu_torch.training import train_step as ts

root, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
init, jobs = sys.argv[4], json.loads(sys.argv[5])
torch.set_num_threads(1)
initialize_distributed(init, num_processes=world, process_id=rank,
                       backend="gloo", timeout_s=60)
spec = json.loads((root / "spec.json").read_text())
batch = {k: torch.from_numpy(v) for k, v in
         np.load(root / "batch.npz").items()}
LR = spec["lr"]


def model_of(name):
    cfg = w2v.W2VBertConfig(**spec[name])
    model = w2v.Wav2Vec2Bert(cfg)
    model.load_state_dict(torch.load(root / f"{name}.pt"))
    return model.train()


out = {}
for job in jobs:
    name, kind = job["name"], job["kind"]
    if kind == "step":
        mesh = make_mesh(world, device="cpu", **job["shape"])
        state = ts.init_state(model_of("cfg"), ts.make_optimizer(LR),
                              mesh=mesh, zero1=job["zero1"])
        sh = opt_state_shardings(state.optimizer, state.model, mesh) \
            if job["zero1"] else None
        step = ts.make_train_step(torch.float32, mesh=mesh,
                                  opt_shardings=sh)
        state, loss = step(state, ts.shard_batch(batch, mesh))
        owned = None
        if job["zero1"]:
            local = ts.named_moments(state)["exp_avg"]
            owned = [None] * world
            dist.all_gather_object(owned, sorted(local))
        blob = ts.gather_train_state(state)
        out[name] = {"loss": float(loss), "blob": blob, "owned": owned,
                     "mesh": mesh.shape}
    elif kind == "pipeline":
        mesh = make_stage_mesh(world, device="cpu")
        model = model_of("cfg_pp")
        feats, fmask = batch["features"], batch["feature_mask"].bool()
        fwd = make_pipelined_forward(model.cfg, mesh, job["micro"])
        logits = fwd(model, feats, fmask)
        res = {"logits": logits}
        if job.get("train"):
            step = make_pipelined_train_step(model.cfg, mesh, job["micro"])
            state = ts.init_state(model, ts.make_optimizer(LR))
            state, loss = step(state, batch)
            names = stage_parameter_names(model, mesh)
            mom = ts.named_moments(state)
            mine = {key: {n: t.detach() for n, t in mom[key].items()
                          if n in names}
                    for key in ("exp_avg", "exp_avg_sq")}
            mine["params"] = {n: p.detach()
                              for n, p in model.named_parameters()
                              if n in names}
            parts = [None] * world
            dist.all_gather_object(parts, mine)
            res["loss"] = float(loss)
            for key in ("params", "exp_avg", "exp_avg_sq"):
                res[key] = {k: v for p in parts for k, v in p[key].items()}
        out[name] = res
if rank == 0:
    torch.save(out, root / "results.pt")
dist.destroy_process_group()
"""


def _batch(B=8, T=32, N=8, seed=0):
    rng = np.random.default_rng(seed)
    fm = np.ones((B, T), np.float32)
    fm[1, 20:] = 0.0
    fm[6, 25:] = 0.0
    return {
        "features": rng.standard_normal((B, T, 160)).astype(np.float32),
        "feature_mask": fm,
        "labels": rng.integers(1, KW["vocab_size"], (B, N)).astype(np.int64),
        "label_mask": np.ones((B, N), np.float32),
    }


def _jax_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _run_ranks(root: Path, world: int, jobs: list) -> dict:
    init = launch.file_init_method(root)
    launch.run_ranks(
        lambda r: launch.python_argv(WORKER, str(root), str(r), str(world),
                                     init, json.dumps(jobs), module=False),
        world, RANK_TIMEOUT_S, cwd=str(REPO))
    return torch.load(root / "results.pt", weights_only=False)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """JAX weights (2 and 4 layers) and a ragged batch, written for the
    ranks; the 4-rank and the 2-rank runs."""
    import jax

    root = tmp_path_factory.mktemp("multidevice")
    kw4 = {**KW, "num_hidden_layers": 4}
    params = jw.init_params(jax.random.PRNGKey(0), jw.W2VBertConfig(**KW))
    params4 = jw.init_params(jax.random.PRNGKey(1), jw.W2VBertConfig(**kw4))
    torch.save(tw.params_from_jax(_jax_tree(params), tw.W2VBertConfig(**KW)),
               root / "cfg.pt")
    torch.save(tw.params_from_jax(_jax_tree(params4),
                                  tw.W2VBertConfig(**kw4)),
               root / "cfg_pp.pt")
    batch = _batch()
    np.savez(root / "batch.npz", **batch)
    (root / "spec.json").write_text(json.dumps(
        {"cfg": KW, "cfg_pp": kw4, "lr": LR}))
    steps = [("dp_tp_zero1", {"data": 2, "model": 2}, True),
             ("dp_tp", {"data": 2, "model": 2}, False),
             ("dp_sp", {"data": 2, "seq": 2}, False),
             ("sp_tp", {"data": 1, "seq": 2, "model": 2}, False),
             ("dp4_zero1", {"data": 4}, True)]
    four = _run_ranks(root, 4, [
        {"name": n, "kind": "step", "shape": s, "zero1": z}
        for n, s, z in steps] + [
        {"name": "pp4", "kind": "pipeline", "micro": 8}])
    two = _run_ranks(root, 2, [{"name": "pp2", "kind": "pipeline",
                                "micro": 4, "train": True}])
    return {"params": params, "params4": params4, "batch": batch,
            "four": four, "two": two, "kw4": kw4}


def _jax_zero1_step(ws):
    import jax.numpy as jnp

    from audio_processor_tpu.parallel import mesh as jmesh
    from audio_processor_tpu.training import train_step as jts

    jcfg = jw.W2VBertConfig(**KW)
    tx = jts.make_optimizer(LR)
    mesh = jmesh.make_mesh(n_devices=4, model=2)
    state = jts.init_state(ws["params"], tx, mesh=mesh, cfg=jcfg, zero1=True)
    sh = jmesh.opt_state_shardings(state.opt_state, state.params, mesh, jcfg)
    step = jts.make_train_step(jcfg, tx, mesh=mesh, dtype=jnp.float32,
                               opt_shardings=sh)
    with mesh:
        state, loss = step(state, ws["batch"])
    return state, float(loss)


def _jax_one_device_moments(ws) -> dict:
    """The Adam moments after the JAX step on one device, by the port's
    parameter names."""
    import jax.numpy as jnp

    from audio_processor_tpu.training import train_step as jts

    jcfg = jw.W2VBertConfig(**KW)
    tx = jts.make_optimizer(LR)
    one, _ = jts.make_train_step(jcfg, tx, dtype=jnp.float32)(
        jts.init_state(ws["params"], tx), ws["batch"])
    return tts.moments_from_jax(_jax_tree(one.opt_state),
                                tw.W2VBertConfig(**KW))


def _blob_moments(blob: dict, cfg) -> dict:
    """A resume point's moments by parameter name."""
    names = [n for n, _ in tw.Wav2Vec2Bert(cfg).named_parameters()]
    st = blob["optimizer"]["state"]
    return {key: {n: st[i][key] for i, n in enumerate(names)}
            for key in ("exp_avg", "exp_avg_sq")}


def _assert_moments_near(got: dict, want: dict):
    """Both moments of every parameter in ``want`` within 1e-4 of the
    leaf's max plus the gradient floor (exp_avg after one step is 0.1 g,
    so the floor scales with the largest gradient)."""
    assert set(got["exp_avg"]) == set(want["exp_avg"])
    gmax = max(float(t.abs().max()) for t in got["exp_avg"].values()) * 10
    for key, floor in (("exp_avg", GRAD_FLOOR * gmax),
                       ("exp_avg_sq", (GRAD_FLOOR * gmax) ** 2)):
        for name, ref in want[key].items():
            ref = ref.numpy()
            np.testing.assert_allclose(
                got[key][name].numpy(), ref, rtol=0,
                atol=MOMENT_RTOL * np.abs(ref).max() + floor,
                err_msg=f"{key} {name}")


def _assert_params_near(got: dict, want: dict):
    """Every element within 2 lr, all but 0.1% within lr / 100."""
    loose = total = 0
    for name, ref in want.items():
        d = (got[name].float() - ref).abs()
        assert float(d.max()) <= PARAM_ATOL, name
        loose += int((d > PARAM_TIGHT).sum())
        total += d.numel()
    assert loose <= PARAM_LOOSE_SHARE * total, (loose, total)


def test_dp_tp_zero1_step_matches_jax(workspace):
    """dp x tp (2 x 2) with ZeRO-1 in 4 gloo ranks against the JAX
    ``make_train_step`` with ``opt_state_shardings`` on a 2 x 2 mesh: the
    loss and the gathered params. Both gathered Adam moments against the
    JAX step on one device: on a mesh with model > 1 the JAX step's
    depthwise-conv moments come out doubled (its gradient summed over
    'model' though the conv is replicated; AdamW's first step is blind to
    a constant scale, so its params still agree)."""
    jstate, jloss = _jax_zero1_step(workspace)
    res = workspace["four"]["dp_tp_zero1"]
    assert res["mesh"] == {"data": 2, "seq": 1, "model": 2}
    np.testing.assert_allclose(res["loss"], jloss, rtol=LOSS_RTOL)
    cfg = tw.W2VBertConfig(**KW)
    blob = res["blob"]
    assert blob["step"] == 1
    _assert_params_near(blob["model"],
                        tw.params_from_jax(_jax_tree(jstate.params), cfg))
    _assert_moments_near(_blob_moments(blob, cfg),
                         _jax_one_device_moments(workspace))


def test_zero1_matches_the_replicated_optimizer(workspace):
    """The same dp x tp step with the moments partitioned over 'data' and
    replicated: equal loss, params and consolidated moments (the JAX
    test's tolerances), and each 'data' rank holds a disjoint part of
    the moments."""
    four = workspace["four"]
    z, rep = four["dp_tp_zero1"], four["dp_tp"]
    np.testing.assert_allclose(z["loss"], rep["loss"], rtol=LOSS_RTOL)
    for name, want in rep["blob"]["model"].items():
        np.testing.assert_allclose(z["blob"]["model"][name].numpy(),
                                   want.numpy(), rtol=ZERO1_RTOL,
                                   atol=ZERO1_ATOL, err_msg=name)
    cfg = tw.W2VBertConfig(**KW)
    zm, rm = _blob_moments(z["blob"], cfg), _blob_moments(rep["blob"], cfg)
    for key in ("exp_avg", "exp_avg_sq"):
        for name, want in rm[key].items():
            np.testing.assert_allclose(zm[key][name].numpy(), want.numpy(),
                                       rtol=ZERO1_RTOL, atol=ZERO1_ATOL,
                                       err_msg=f"{key} {name}")
    # ranks 0 and 2 are the two 'data' ranks of model rank 0
    d0, d1 = set(z["owned"][0]), set(z["owned"][2])
    assert d0 and d1 and not d0 & d1
    assert d0 | d1 == set(rep["blob"]["model"])
    d4 = [set(o) for o in four["dp4_zero1"]["owned"]]
    assert all(d4) and sum(map(len, d4)) == len(set().union(*d4))


def test_sequence_parallel_loss_matches(workspace):
    """Frames split over 'seq' (dp x sp, sp x tp): the loss within 1e-3
    of the JAX dp/tp loss (tests/test_multidevice.py:158), and within
    1e-4 of the port's own dp x tp loss with params after the step
    within the cross-strategy bounds. The gathered moments against the
    JAX step on one device: AdamW's first step is blind to a constant
    per-leaf gradient scale (a gradient summed twice over 'seq'), its
    moments are not."""
    _, jloss = _jax_zero1_step(workspace)
    ref_m = _jax_one_device_moments(workspace)
    cfg = tw.W2VBertConfig(**KW)
    four = workspace["four"]
    base = four["dp_tp"]
    for name in ("dp_sp", "sp_tp"):
        res = four[name]
        assert abs(res["loss"] - jloss) < SP_LOSS_RTOL * max(1.0, abs(jloss))
        np.testing.assert_allclose(res["loss"], base["loss"],
                                   rtol=LOSS_RTOL)
        _assert_params_near(res["blob"]["model"], base["blob"]["model"])
        _assert_moments_near(_blob_moments(res["blob"], cfg), ref_m)


def test_zero1_resume_point_loads_into_one_process(workspace, tmp_path):
    """The data=4 ZeRO-1 run's resume point, consolidated on rank 0, is
    the single-device format: it loads into a one-process state, whose
    next step equals a one-process step from the same point."""
    from audio_processor_tpu_torch.training import finetune as tft

    blob = workspace["four"]["dp4_zero1"]["blob"]
    (tmp_path / "state_latest").mkdir()
    torch.save(blob, tmp_path / "state_latest" / tft.STATE_FILE)
    cfg = tw.W2VBertConfig(**KW)
    states = []
    for _ in range(2):
        model = tw.Wav2Vec2Bert(cfg).train()
        state = tft.load_train_state(
            tts.init_state(model, tts.make_optimizer(LR)), tmp_path)
        states.append(state)
    state = states[0]
    assert state.step == 1
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), blob["model"][name]), name
    moments = tts.named_moments(state)
    assert moments["step"] == 1 and len(moments["exp_avg"]) == len(
        blob["model"])
    batch = {k: torch.from_numpy(v) for k, v in workspace["batch"].items()}
    _, l0 = tts.train_step(states[0], batch, dtype=torch.float32)
    _, l1 = tts.train_step(states[1], batch, dtype=torch.float32)
    assert float(l0) == float(l1) and np.isfinite(float(l0))


def test_pipelined_forward_matches_plain_and_jax(workspace):
    """4 stages x 8 microbatches and 2 stages x 4, with ragged masks:
    logits within 1e-4 of the plain forward and of the JAX
    ``make_pipelined_forward`` (4 virtual devices)."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from audio_processor_tpu.parallel.pipeline import (
        make_pipelined_forward,
    )

    kw4 = workspace["kw4"]
    cfg = tw.W2VBertConfig(**kw4)
    model = tw.Wav2Vec2Bert(cfg)
    model.load_state_dict(tw.params_from_jax(
        _jax_tree(workspace["params4"]), cfg))
    b = workspace["batch"]
    mask = b["feature_mask"].astype(bool)
    with torch.no_grad():
        plain = model(torch.from_numpy(b["features"]),
                      torch.from_numpy(mask)).numpy()
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]), ("stage",))
    ref = np.asarray(make_pipelined_forward(
        jw.W2VBertConfig(**kw4), jmesh, 8)(workspace["params4"],
                                            b["features"], mask))
    for got in (workspace["four"]["pp4"]["logits"],
                workspace["two"]["pp2"]["logits"]):
        np.testing.assert_allclose(got.numpy(), plain, rtol=0, atol=PP_ATOL)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=PP_ATOL)


def test_pipelined_train_step_matches(workspace):
    """The 2-stage step: loss and every stage's params within 1e-4 of the
    port's plain step, and loss within 1e-4 and params within the
    cross-framework bounds of the JAX ``make_pipelined_train_step``."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from audio_processor_tpu.parallel.pipeline import (
        make_pipelined_train_step,
    )
    from audio_processor_tpu.training import train_step as jts

    kw4 = workspace["kw4"]
    cfg = tw.W2VBertConfig(**kw4)
    model = tw.Wav2Vec2Bert(cfg).train()
    model.load_state_dict(tw.params_from_jax(
        _jax_tree(workspace["params4"]), cfg))
    b = workspace["batch"]
    state, loss = tts.train_step(
        tts.init_state(model, tts.make_optimizer(LR)),
        {k: torch.from_numpy(v) for k, v in b.items()}, dtype=torch.float32)
    pp = workspace["two"]["pp2"]
    assert abs(pp["loss"] - float(loss)) < PP_ATOL
    assert set(pp["params"]) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert float((pp["params"][name] - p.detach()).abs().max()) \
            < PP_ATOL, name
    _assert_moments_near(pp, tts.named_moments(state))
    jcfg = jw.W2VBertConfig(**kw4)
    tx = jts.make_optimizer(LR)
    jmesh = JaxMesh(np.asarray(jax.devices()[:2]), ("stage",))
    with jmesh:
        jstate, jloss = make_pipelined_train_step(jcfg, tx, jmesh, 4)(
            jts.init_state(workspace["params4"], tx), b)
    np.testing.assert_allclose(pp["loss"], float(jloss), rtol=LOSS_RTOL)
    _assert_params_near(pp["params"],
                        tw.params_from_jax(_jax_tree(jstate.params), cfg))


def test_data_parallel_engine_matches_one_device_and_jax():
    """The engine over a ``data: 8`` mesh of CPU replicas: 16 device
    chunks in 8 slices of 2; rows equal the one-device engine's (the
    same per-replica shapes), ids equal the JAX mesh engine's on every
    frame whose JAX top-2 margin exceeds 1e-3, features within 2e-4."""
    from audio_processor_tpu.config import PipelineConfig as JaxConfig
    from audio_processor_tpu.parallel.mesh import make_mesh as jax_mesh
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
    from audio_processor_tpu_torch.pipeline.chunker import split_audio

    from tests.test_multidevice import _tiny
    from tests.test_torch_asr_engine import (
        FEAT_ATOL, _assert_clear_ids_equal, _int16_exact_call,
    )

    settings = dict(enable_mixed_precision=False, chunk_duration_sec=4.0,
                    overlap_sec=1.0, length_buckets_sec=(2.0, 4.0),
                    chunk_batch_size=2)
    jeng = _tiny(JaxConfig(**settings), mesh=jax_mesh(n_devices=8, data=8))
    fields = {f for f in tw.W2VBertConfig.__dataclass_fields__}
    mcfg = tw.W2VBertConfig(**{k: v for k, v in vars(jeng.model_cfg).items()
                               if k in fields})
    model = tw.Wav2Vec2Bert(mcfg)
    model.load_state_dict(tw.params_from_jax(_jax_tree(jeng.params), mcfg))
    cfg = PipelineConfig(**settings)
    mesh = make_mesh(data=8, devices=["cpu"] * 8)
    multi = ASREngine(cfg, device="cpu", model=model, vocab=jeng.vocab,
                      mesh=mesh)
    single = ASREngine(cfg, device="cpu", model=model, vocab=jeng.vocab)
    assert multi.device_chunks == 16 and len(multi.replicas) == 8
    call = _int16_exact_call(30.0)
    chunks = split_audio(call, 16000, "c.wav", 4.0, 1.0)        # 10 chunks
    out_m = multi.transcribe_chunks(chunks)
    out_s = single.transcribe_chunks(split_audio(call, 16000, "c.wav",
                                                 4.0, 1.0))
    assert multi.replica_dispatches == [1] * 8
    for a, b in zip(out_s, out_m):
        for f in ("transcription_chunk", "agent_transcription",
                  "client_transcription", "error"):
            assert a[f] == b[f], f
        np.testing.assert_allclose(a["agent_acoustic_features"],
                                   b["agent_acoustic_features"],
                                   rtol=1e-6, atol=1e-6)
    from audio_processor_tpu_torch.pipeline.chunker import chunk_batch

    (batch,) = chunk_batch(chunks[:8], multi.bucket_samples)
    buf, lengths = multi._prepare_fused_buffer(batch, 16)
    parts = multi._run_fused(buf, lengths, batch.bucket_len)
    ids, mask, af = (np.concatenate([p[i].numpy() for p in parts])
                     for i in range(3))
    jids, jmask, jaf = (np.asarray(a) for a in jeng._fused_fn(
        batch.bucket_len)(jeng.params, buf, lengths))
    np.testing.assert_array_equal(mask, jmask)
    _assert_clear_ids_equal(jeng, ids, jids, jmask, buf, lengths, 8,
                            batch.bucket_len)
    scale = np.maximum(np.abs(jaf[:8]), 1.0)
    assert float(np.abs((af[:8] - jaf[:8]) / scale).max()) <= FEAT_ATOL


def test_mesh_shapes_and_manager():
    """make_mesh over explicit devices, the manager's mesh from
    ``mesh_shape`` (with a 'seq' axis), the visible device count (the
    CPU here) and the engine inputs' split, and too few devices (here no
    card, with no CPU devices asked for) refused."""
    from audio_processor_tpu_torch.parallel.multi_device import (
        data_shardings, get_optimal_device_count,
    )

    mgr = MultiDeviceManager({"mesh_shape": {"data": 4, "model": 2}},
                             device="cpu")
    assert mgr.num_workers == 8 and mgr.data_parallel_size == 4
    mgr = MultiDeviceManager({"mesh_shape": {"data": 2, "seq": 2,
                                             "model": 2}}, device="cpu")
    assert mgr.mesh.shape == {"data": 2, "seq": 2, "model": 2}
    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    assert isinstance(mesh, Mesh) and not mesh.multi_process
    assert get_optimal_device_count() == get_optimal_device_count(4) == 1
    assert data_shardings(mesh)["buf3"] == ("data", None, None)
    assert mesh.coordinate("data") == 0 and mesh.group("data") is None
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        make_mesh(n_devices=4)
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        make_mesh(n_devices=4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="2x1x1"):
        make_mesh(n_devices=3, data=2, devices=["cpu"] * 3)


def test_dryrun_multichip_on_four_processes():
    """The entry module's multi-process dry run on the CPU (gloo):
    a dp x tp ZeRO-1 step, the sp x tp step's loss against it, a
    4-stage pipelined forward and sharded inference."""
    from audio_processor_tpu_torch import entry

    out = entry.dryrun_multichip(4, device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert out["backend"] == "gloo" and out["device"] == "cpu"
    assert out["mesh"] == {"data": 2, "seq": 1, "model": 2}
    assert abs(out["seq_parallel_loss"] - out["loss"]) \
        < SP_LOSS_RTOL * abs(out["loss"])
    assert out["pipeline_max_err"] < PP_ATOL
    assert out["sharded_inference_chunks"] == 4
    assert sys.modules.get("audio_processor_tpu_torch.entry") is entry
