"""The port runs on the card unless the CPU is asked for: with no card
visible, every mesh builder, the mesh manager, the GPipe stage mesh, the
dry run and its ``python -m`` entry raise (the dry run before any rank
process starts), and each still builds or runs when given ``"cpu"``.

``torch.cuda.is_available`` is patched to False in every test, so they
say the same on a machine that has a card."""

import pytest
import torch

from audio_processor_tpu_torch import entry
from audio_processor_tpu_torch.parallel import launch
from audio_processor_tpu_torch.parallel import mesh as pmesh
from audio_processor_tpu_torch.parallel.mesh import Mesh, build_mesh, make_mesh
from audio_processor_tpu_torch.parallel.multi_device import (
    MultiDeviceManager, mesh_from_config,
)
from audio_processor_tpu_torch.parallel.pipeline import make_stage_mesh

NO_CARD = "no CUDA device is visible"
CONFIG = {"mesh_shape": {"data": 1}}


@pytest.fixture(autouse=True)
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("build", [
    lambda: make_mesh(),
    lambda: make_mesh(n_devices=1),
    lambda: mesh_from_config(CONFIG),
    lambda: MultiDeviceManager(CONFIG),
    lambda: make_stage_mesh(2),
], ids=["make_mesh", "make_mesh_n1", "mesh_from_config", "manager",
        "stage_mesh"])
def test_mesh_builders_raise_without_a_card(build):
    with pytest.raises(RuntimeError, match=NO_CARD) as err:
        build()
    assert "devices=['cpu'] * n" in str(err.value)


@pytest.mark.parametrize("run", [
    lambda: entry.dryrun_multichip(2),
    lambda: entry.main([]),
], ids=["dryrun_multichip", "entry_main"])
def test_dry_run_raises_before_any_rank_starts(run, monkeypatch):
    started = []
    monkeypatch.setattr(launch, "run_ranks",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match=NO_CARD):
        run()
    assert started == []


@pytest.mark.parametrize("build,shape", [
    (lambda: make_mesh(n_devices=2, devices=["cpu"] * 2),
     {"data": 2, "seq": 1, "model": 1}),
    (lambda: mesh_from_config({"mesh_shape": {"data": 2, "model": 2}},
                              device="cpu"),
     {"data": 2, "seq": 1, "model": 2}),
    (lambda: MultiDeviceManager(CONFIG, device="cpu").mesh,
     {"data": 1, "seq": 1, "model": 1}),
    (lambda: make_stage_mesh(2, devices=["cpu"] * 2), {"stage": 2}),
], ids=["make_mesh", "mesh_from_config", "manager", "stage_mesh"])
def test_cpu_meshes_build_when_asked(build, shape):
    mesh = build()
    assert isinstance(mesh, Mesh) and not mesh.multi_process
    assert mesh.shape == shape
    assert {d.type for d in mesh.devices.flat} == {"cpu"}


def test_process_group_mesh_defaults_to_the_card(monkeypatch):
    """Inside a process group of several ranks, ``build_mesh`` puts this
    rank on its card unless ``device`` names the CPU: with no card it
    raises before building a device mesh."""
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda *a: 2)
    with pytest.raises(RuntimeError, match="asked for CUDA"):
        build_mesh({"data": 2})
    with pytest.raises(RuntimeError, match="asked for CUDA"):
        make_stage_mesh(2)


def test_entry_main_runs_on_the_cpu_when_asked(capsys):
    """``python -m audio_processor_tpu_torch.entry --devices 2 --device
    cpu``: two gloo ranks on the CPU."""
    assert entry.main(["--devices", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip ok" in out
    assert "'backend': 'gloo'" in out and "'device': 'cpu'" in out
