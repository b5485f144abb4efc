"""Serving meshes over torch.distributed (port of src/repro/launch/mesh.py).

The reference lays a ``(data, model)`` device mesh over one JAX process;
the port runs one process per rank (SPMD) and a mesh is that process's
view of the world: the axis sizes, its rank along ``model``, its device
and the process group its collectives run over (`models.parallel`).

Serving meshes have the shape (1, tp): one replica, ``tp`` model shards.
Rank r runs on ``cuda:{r % device_count}``. The backend is NCCL when every
rank has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU; gloo's collectives of CUDA tensors
are staged through pinned host buffers (`Mesh.staging`).

Two ways into a mesh:

  * inside an initialised process group (``torchrun``'s environment, or a
    caller's own ``init_process_group``), call ``make_serving_mesh(tp)`` on
    every rank;
  * ``spawn(fn, tp, device, *args)`` starts ``tp`` processes, joins them
    through a ``FileStore`` in a temporary directory (no TCP store), builds
    the mesh and calls ``fn(mesh, *args)`` on each; it returns the ranks'
    results in rank order. ``fn`` must be importable by name (spawn
    pickles it).

The reference's pod meshes (`make_driver_mesh("single" | "multi")`) and
data axes > 1 are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

AXES = ("data", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a (data, model) mesh. ``shape`` maps axis ->
    size, as the reference's ``mesh.shape``; ``group`` is the process
    group of the model axis (None at tp = 1)."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: Any = None
    axis_names: Tuple[str, ...] = AXES
    collective_calls: int = 0
    collective_seconds: float = 0.0
    _pinned: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def tp(self) -> int:
        return self.shape["model"]

    def staging(self, nbytes: int, tp: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pinned host buffers (send [nbytes], receive [tp, nbytes]) of uint8
        for a gloo collective of CUDA tensors, made once per size."""
        key = (nbytes, tp)
        if key not in self._pinned:
            self._pinned[key] = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True),
                                 torch.empty((tp, nbytes), dtype=torch.uint8, pin_memory=True))
        return self._pinned[key]


def choose_backend(tp: int, device: str) -> str:
    """``nccl`` when each of the ``tp`` ranks has a card of its own, else
    ``gloo`` (ranks sharing a card, or on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: str) -> torch.device:
    """Rank r's device: the CPU, or ``cuda:{(i + r) % device_count}`` for
    ``device`` ``cuda:i`` (``cuda``: i = 0)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return torch.device("cuda", ((dev.index or 0) + rank) % torch.cuda.device_count())


def make_serving_mesh(tp: int = 1, device: str = "cuda", backend: Optional[str] = None) -> Mesh:
    """(1, tp) mesh for tensor-parallel serving: one replica, ``tp`` model
    shards. Pass it to ``EngineConfig(mesh=...)`` on every rank. At tp = 1
    without a process group it is the single-device mesh; at tp > 1 it
    needs an initialised process group of ``tp`` ranks (it initialises one
    from torchrun's environment variables where they are set)."""
    import torch.distributed as dist

    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not dist.is_initialized():
        if tp == 1:
            return Mesh({"data": 1, "model": 1}, device=rank_device(0, device))
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(f"make_serving_mesh(tp={tp}) needs an initialised process "
                               "group: run under torchrun or through launch.mesh.spawn")
        dist.init_process_group(backend or choose_backend(tp, device), init_method="env://")
    world = dist.get_world_size()
    if world != tp:
        raise NotImplementedError(
            f"a process group of {world} ranks for a (1, {tp}) mesh: data axes > 1 are not "
            "ported yet (ROADMAP.md, Modules to port)")
    rank = dist.get_rank()
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh({"data": 1, "model": tp}, rank=rank, device=dev, backend=dist.get_backend(),
                group=dist.group.WORLD)


def make_driver_mesh(kind: str = "none", device: str = "cuda") -> Mesh:
    """The train driver's ``--mesh``: ``none`` is the (1, 1) mesh on
    ``device``; the reference's pod meshes (``single``, ``multi``) are not
    ported."""
    if kind == "none":
        return make_serving_mesh(1, device)
    raise NotImplementedError(f"mesh kind {kind!r} (TPU pod meshes) is not ported "
                              "(ROADMAP.md, Modules to port)")


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data") and mesh.shape[a] > 1)


def tp_axis(mesh) -> str:
    return "model"


# --------------------------------------------------------------------- spawn
def _entry(rank: int, fn, tp: int, device: str, backend: Optional[str], tmp: str, args):
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # gloo over loopback only
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or choose_backend(tp, device),
                            init_method=f"file://{tmp}/store", rank=rank, world_size=tp)
    out = Path(tmp) / f"result{rank}.pkl"
    try:
        res = fn(make_serving_mesh(tp, device), *args)
        out.write_bytes(pickle.dumps(("ok", res)))
    except BaseException as e:          # the parent re-raises it with the rank's traceback
        out.write_bytes(pickle.dumps(("error", f"rank {rank}: {e!r}\n{traceback.format_exc()}")))
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, tp: int, device: str = "cuda", *args, backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``tp`` spawned ranks of a (1, tp) mesh on
    ``device`` and return their results in rank order; a rank's exception
    is re-raised as RuntimeError with that rank's traceback."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro-mesh-")

    def read(rank: int):
        p = Path(tmp) / f"result{rank}.pkl"
        return pickle.loads(p.read_bytes()) if p.exists() else None

    try:
        try:
            mp.start_processes(_entry, args=(fn, tp, device, backend, tmp, args), nprocs=tp,
                               join=True, start_method="spawn")
        except Exception as e:          # a rank failed: its own message, if it wrote one
            errs = [m[1] for m in map(read, range(tp)) if m and m[0] == "error"]
            raise RuntimeError("\n".join(errs) or str(e)) from None
        return [read(r)[1] for r in range(tp)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
