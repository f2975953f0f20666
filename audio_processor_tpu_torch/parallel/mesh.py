"""Device mesh and the tensor-parallel and ZeRO-1 layouts (port of
parallel/mesh.py).

The reference's mesh is one process's grid of devices, and XLA inserts the
collectives. Here a :class:`Mesh` is either

- one process's grid of devices (``devices=``, or the visible cards when
  no process group is up): the data-parallel inference engine keeps one
  model replica per 'data' device and runs its slices of each batch there
  (pipeline/asr_engine.py);
- or a grid of processes, one device each, with one process group per
  axis (a ``torch.distributed.device_mesh.DeviceMesh``): training shards
  the batch over 'data', frames over 'seq' and heads and FFN columns over
  'model', with explicit collectives (parallel/collectives.py).

Axis names are ``("data", "seq", "model")``, as in the reference; GPipe's
mesh has one ``"stage"`` axis (parallel/pipeline.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from audio_processor_tpu_torch.parallel import collectives as coll
from audio_processor_tpu_torch.parallel import distributed as pdist

class Mesh:
    """A grid of devices (one process) or of processes (several), with
    named axes. ``devices`` is the grid: torch devices in one process,
    global ranks across processes. ``shape`` maps each axis to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device_mesh=None, local_device: Optional[torch.device]
                 = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"grid of {devices.ndim} dims for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        self.local_device = local_device if local_device is not None \
            else devices.flat[0]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multi_process(self) -> bool:
        return self.device_mesh is not None

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """The process group along ``axis`` (None in one process or for an
        axis the mesh lacks)."""
        if self.device_mesh is None or axis not in self.axis_names:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This process's index along ``axis`` (0 in one process)."""
        if self.device_mesh is None or axis not in self.axis_names:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def group_ranks(self, axis: str):
        """The global ranks of this process's group along ``axis``, in
        group-rank order."""
        if self.device_mesh is None:
            return [0]
        idx = [self.coordinate(a) if a != axis else slice(None)
               for a in self.axis_names]
        return [int(r) for r in np.asarray(self.devices[tuple(idx)]).ravel()]

    def __repr__(self) -> str:
        kind = "processes" if self.multi_process else "devices"
        return f"Mesh({self.shape}, {kind})"


def _default_devices() -> list:
    """The visible cards. With none, raise: a CPU mesh is built only when
    the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible, so no mesh of cards can be built; "
            "pass devices=['cpu'] * n to build a CPU mesh of n devices")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def build_mesh(sizes: Dict[str, int], devices: Optional[Sequence] = None,
               device: Optional[str] = None) -> Mesh:
    """A mesh of the given axis sizes. ``devices`` (a list, repeats
    allowed) makes one process's grid; otherwise an initialised process
    group of several processes makes a grid of them (the local device is
    ``cuda:<LOCAL_RANK>``, or ``device``: pass ``"cpu"`` for CPU ranks),
    and with none the visible cards make the grid (RuntimeError when no
    card is visible)."""
    names = tuple(sizes)
    n = math.prod(sizes.values())
    if devices is None and dist.is_initialized() \
            and dist.get_world_size() > 1:
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"a mesh over processes spans every rank: "
                             f"{sizes} has {n} places for {world} ranks")
        local = pdist.local_device(device or "cuda")
        if local.type == "cuda":
            # Set before DeviceMesh, which would otherwise pick
            # cuda:<LOCAL_RANK> even where ranks share a card.
            torch.cuda.set_device(local)
        from torch.distributed.device_mesh import DeviceMesh

        ranks = torch.arange(world).reshape(tuple(sizes.values()))
        dm = DeviceMesh(local.type, ranks, mesh_dim_names=names)
        return Mesh(ranks.numpy(), names, device_mesh=dm,
                    local_device=local)
    avail = [torch.device(d) for d in devices] if devices is not None \
        else _default_devices()
    if len(avail) < n:
        raise RuntimeError(
            f"make_mesh needs {n} devices but only {len(avail)} "
            f"({', '.join(map(str, avail))}) are given or visible; pass "
            "devices=[...] (a device may repeat: ['cpu'] * 8 makes a "
            "virtual CPU mesh) or launch one process per device")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(avail[:n]):
        grid[i] = d
    return Mesh(grid.reshape(tuple(sizes.values())), names)


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: int = 1, seq: int = 1,
              devices: Optional[Sequence] = None,
              device: Optional[str] = None) -> Mesh:
    """A ('data', 'seq', 'model') mesh. ``n_devices`` defaults to the
    world size across processes, else to ``len(devices)`` or the visible
    cards; ``data`` to ``n_devices // (model * seq)``. Too few devices,
    or no card when no ``devices`` are given, raise RuntimeError."""
    if n_devices is None:
        if devices is not None:
            n_devices = len(devices)
        elif dist.is_initialized():
            n_devices = dist.get_world_size()
        else:
            n_devices = len(_default_devices())
    if data is None:
        data = n_devices // (model * seq)
    if data * model * seq != n_devices:
        raise ValueError(f"mesh {data}x{seq}x{model} != {n_devices} devices")
    return build_mesh({"data": data, "seq": seq, "model": model},
                      devices=devices, device=device)


# ---------------------------------------------------------------- layouts
def _tp_role(name: str) -> Optional[str]:
    """'col' for the column-parallel products (output dim sharded), 'row'
    for the row-parallel ones (input dim sharded), None if replicated."""
    if ".self_attn.linear_" in name:
        return "row" if ".linear_out." in name else "col"
    if ".intermediate_dense." in name:
        return "col"
    if ".output_dense." in name:
        return "row"
    return None


def w2v_param_specs(cfg) -> Dict[str, tuple]:
    """Per state-dict name of :class:`Wav2Vec2Bert`, one entry per dim:
    ``"model"`` where the dim shards over the 'model' axis, else None.

    Column-parallel (weight ``[out, in]`` split on ``out``, bias split):
    ``linear_q/k/v`` (local heads) and both FFNs' ``intermediate_dense``.
    Row-parallel (weight split on ``in``; bias replicated, added once after
    the sum): ``linear_out`` and ``output_dense``. Replicated: the norms,
    the conv module, ``distance_embedding`` (its gradient is summed over
    'model': each rank's comes from its own heads), ``lm_head`` and the
    feature projection, which the reference splits by columns but which
    buys nothing in eager PyTorch (one [160, H] product on the input)."""
    from audio_processor_tpu_torch.models.wav2vec2bert import Wav2Vec2Bert

    with torch.device("meta"):
        model = Wav2Vec2Bert(cfg)
    specs = {}
    for name, p in model.named_parameters():
        spec = [None] * p.ndim
        role = _tp_role(name)
        if role == "col":
            spec[0] = "model"
        elif role == "row" and name.endswith(".weight"):
            spec[1] = "model"
        specs[name] = tuple(spec)
    return specs


def _shard_dim(spec: tuple) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor under ``spec``."""
    dim = _shard_dim(spec)
    tp = mesh.axis_size("model")
    if dim is None or tp == 1:
        return t
    size = t.shape[dim] // tp
    return t.narrow(dim, mesh.coordinate("model") * size, size)


def unshard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every 'model' rank's slice (a collective over
    the 'model' group)."""
    dim = _shard_dim(spec)
    if dim is None or mesh.axis_size("model") == 1:
        return t
    return coll.all_gather(t, dim, mesh.group("model"))


def shard_params(model, mesh: Mesh, cfg=None):
    """Give this rank its tensor-parallel shard of ``model`` (in place;
    every rank starts from the same whole weights) and attach the mesh's
    'model' and 'seq' groups, which the forward then uses: H/tp heads and
    FFN/tp columns per rank, frames split over 'seq'. Returns ``model``."""
    from audio_processor_tpu_torch.models.wav2vec2bert import ParallelGroups

    cfg = cfg or model.cfg
    tp, sp = mesh.axis_size("model"), mesh.axis_size("seq")
    if tp > 1 and (cfg.num_attention_heads % tp
                   or cfg.intermediate_size % tp):
        raise ValueError(f"{cfg.num_attention_heads} heads and FFN "
                         f"{cfg.intermediate_size} do not split over "
                         f"model={tp}")
    if tp > 1:
        specs = w2v_param_specs(cfg)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if _shard_dim(specs[name]) is not None:
                    p.data = shard_tensor(p.data, specs[name],
                                          mesh).contiguous()
    model.set_parallel(ParallelGroups(
        model=mesh.group("model") if tp > 1 else None,
        seq=mesh.group("seq") if sp > 1 else None))
    return model


def gather_params(model, mesh: Mesh, cfg=None) -> Dict[str, torch.Tensor]:
    """The whole state dict of a tensor-parallel model (a collective over
    'model'; every rank gets it)."""
    specs = w2v_param_specs(cfg or model.cfg)
    out = {}
    for name, t in model.state_dict().items():
        out[name] = unshard_tensor(t, specs[name], mesh) if name in specs \
            else t
    return out


def zero1_param_specs(model, mesh: Mesh, cfg=None) -> Dict[str, dict]:
    """ZeRO-1 layout of the Adam moments: per parameter name its
    tensor-parallel spec and the 'data' rank that owns its moments.

    The reference adds 'data' to a dim of every moment; the port partitions
    whole parameters over the 'data' group instead, as
    ``torch.distributed.optim.ZeroRedundancyOptimizer`` does (largest
    first, each to the rank with the fewest elements so far), so each rank
    keeps about 1/dp of the moments and updates those parameters, and the
    updated parameters are broadcast from their owners."""
    specs = w2v_param_specs(cfg or model.cfg)
    dp = mesh.axis_size("data")
    named = list(model.named_parameters())
    sizes = [0] * dp
    owner = {}
    for name, p in sorted(named, key=lambda kv: kv[1].numel(), reverse=True):
        r = sizes.index(min(sizes))
        owner[name] = r
        sizes[r] += p.numel()
    return {name: {"spec": specs[name], "owner": owner[name]}
            for name, _ in named}


def opt_state_shardings(optimizer, model, mesh: Mesh, cfg=None,
                        zero1: bool = True) -> Dict[str, dict]:
    """The moments' layout by parameter name: :func:`zero1_param_specs`
    under ``zero1``, else each parameter's spec with no owner (the moments
    replicated over 'data'). ``optimizer`` must be the one the layout
    describes: a ``ZeroRedundancyOptimizer`` over the mesh's 'data' group
    under ``zero1``, whose local partition must match."""
    if not zero1:
        specs = w2v_param_specs(cfg or model.cfg)
        return {name: {"spec": specs[name], "owner": None}
                for name, _ in model.named_parameters()}
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if not isinstance(optimizer, ZeroRedundancyOptimizer):
        raise ValueError("zero1 layout asked for an optimizer that is not "
                         "a ZeroRedundancyOptimizer")
    layout = zero1_param_specs(model, mesh, cfg)
    mine = {id(p) for g in optimizer.optim.param_groups for p in g["params"]}
    d = mesh.coordinate("data")
    for name, p in model.named_parameters():
        if (layout[name]["owner"] == d) != (id(p) in mine):
            raise ValueError(f"ZeRO partition of {name} differs from the "
                             "layout")
    return layout
