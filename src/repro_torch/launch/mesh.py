"""Meshes over torch.distributed (port of src/repro/launch/mesh.py).

The reference lays a ``(pod, data, model)`` device mesh over one JAX
process; the port runs one process per rank (SPMD) and a mesh is that
process's view of the world: the axis sizes, its coordinate on each axis,
its device and one process group per axis of size > 1, over which its
collectives run (`models.parallel`). Ranks are numbered pod-major, then
data, then model: rank = (pod * data_n + data) * model_n + model.

Rank r runs on ``cuda:{r % device_count}``. The backend is NCCL when every
rank has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU; gloo's collectives of CUDA tensors
are staged through one pinned host buffer of the mesh, ``STAGE_BYTES``
long, in chunks (`Mesh.stage`).

One maker, ``make_mesh({"pod": p, "data": d, "model": m})``, builds every
mesh; three callers hold it to what is ported:

  * ``make_serving_mesh(tp)``: (data 1, model tp), tensor-parallel serving
    (data axes > 1 are refused: serving has no data parallelism);
  * ``make_train_mesh({"pod": p, "data": d, "model": m})``: data- and
    tensor-parallel training;
  * ``make_driver_mesh("none" | "single" | "multi", model=M)``: the train
    driver's ``--mesh``, the port's stand-in for the reference's TPU pod
    meshes (16 x 16 and 2 x 16 x 16, which are not built): over the world's
    W ranks, ``single`` is (data W / M, model M) and ``multi`` (pod 2,
    data W / 2M, model M).

Two ways into a mesh: inside an initialised process group (``torchrun``'s
environment, or a caller's own ``init_process_group``), call the maker on
every rank; or ``spawn(fn, shape, device, *args)``, which starts one process
per rank, joins them through a ``FileStore`` in a temporary directory (no
TCP store), builds the mesh and calls ``fn(mesh, *args)`` on each, and
returns the ranks' results in rank order. ``fn`` must be importable by
name (spawn pickles it). A world that fails or outlives its deadline is
killed and raises RuntimeError with the ranks' tracebacks.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import itertools
import math
import os
import pickle
import shutil
import signal
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

AXES = ("pod", "data", "model")
# the pinned host buffer a rank stages gloo collectives of CUDA tensors through
STAGE_BYTES = 256 << 20


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh. ``shape`` maps axis -> size, as the
    reference's ``mesh.shape`` (axes in ``AXES`` order; a mesh without a
    ``pod`` axis has none); ``rank`` is the global rank; ``groups`` maps
    each axis of size > 1 to its process group."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    axis_names: Optional[Tuple[str, ...]] = None
    collective_calls: int = 0
    collective_seconds: float = 0.0
    # bytes this rank sent, by collective
    collective_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    _pinned: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.axis_names is None:
            self.axis_names = tuple(a for a in AXES if a in self.shape)

    @property
    def tp(self) -> int:
        return self.shape["model"]

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis (pod-major rank order)."""
        out, r = {}, self.rank
        for a in reversed(self.axis_names):
            r, out[a] = divmod(r, self.shape[a])
        return out

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def pinned_bytes(self) -> int:
        return 0 if self._pinned is None else self._pinned.numel()

    def stage(self) -> torch.Tensor:
        """The rank's pinned host buffer (uint8, ``STAGE_BYTES``) for gloo
        collectives of CUDA tensors, made at first use."""
        if self._pinned is None:
            self._pinned = torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
        return self._pinned

    def count(self, kind: str, nbytes: int, seconds: float):
        self.collective_calls += 1
        self.collective_seconds += seconds
        self.collective_bytes[kind] = self.collective_bytes.get(kind, 0) + nbytes

    def reset_counts(self):
        self.collective_calls, self.collective_seconds = 0, 0.0
        self.collective_bytes = {}


def choose_backend(world: int, device: str) -> str:
    """``nccl`` when each of the ``world`` ranks has a card of its own, else
    ``gloo`` (ranks sharing a card, or on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
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


def _normal_shape(shape: Mapping[str, int]) -> Dict[str, int]:
    bad = set(shape) - set(AXES)
    if bad:
        raise ValueError(f"unknown mesh axes {sorted(bad)}; the axes are {AXES}")
    out = {a: int(shape[a]) for a in AXES if a in shape}
    out.setdefault("data", 1)
    out.setdefault("model", 1)
    if any(n < 1 for n in out.values()):
        raise ValueError(f"mesh sizes must be >= 1, got {out}")
    return {a: out[a] for a in AXES if a in out}


def _world_group(world: int, device: str, backend: Optional[str], what: str) -> None:
    """Initialise the process group from torchrun's environment where it is
    not initialised yet."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(f"{what} needs an initialised process group: run under torchrun "
                           "or through launch.mesh.spawn")
    dist.init_process_group(backend or choose_backend(world, device), init_method="env://")


def _build(shape: Dict[str, int], device: str) -> Mesh:
    """The mesh of ``shape`` over the initialised world: this rank's device
    and one group per axis of size > 1 (every rank makes every group, in
    one order, as ``new_group`` requires)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(dict(shape), rank=rank, device=dev, backend=dist.get_backend())
    names, sizes = mesh.axis_names, [shape[a] for a in mesh.axis_names]
    coords = mesh.coords
    for i, axis in enumerate(names):
        if sizes[i] == 1:
            continue
        if sizes[i] == mesh.world:
            mesh.groups[axis] = dist.group.WORLD
            continue
        stride = math.prod(sizes[i + 1:])
        others = [a for a in names if a != axis]
        for rest in itertools.product(*(range(shape[a]) for a in others)):
            c = dict(zip(others, rest))
            base = sum(c[a] * math.prod(sizes[j + 1:]) for j, a in enumerate(names) if a != axis)
            ranks = [base + k * stride for k in range(sizes[i])]
            g = dist.new_group(ranks)
            if all(c[a] == coords[a] for a in others):
                mesh.groups[axis] = g
    return mesh


def make_mesh(shape: Mapping[str, int], device: str = "cuda",
              backend: Optional[str] = None) -> Mesh:
    """The mesh of ``shape`` ({"pod": p, "data": d, "model": m}; a missing
    pod axis is absent, data and model default to 1) over an initialised
    process group of p * d * m ranks (initialised from torchrun's
    environment where it is set; one rank needs none)."""
    import torch.distributed as dist

    shape = _normal_shape(shape)
    world = math.prod(shape.values())
    if world == 1 and not dist.is_initialized():
        return Mesh(shape, device=rank_device(0, device))
    _world_group(world, device, backend, f"a mesh {shape}")
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {shape} needs {world} ranks; the process group has "
                         f"{dist.get_world_size()}")
    return _build(shape, device)


def make_serving_mesh(tp: int = 1, device: str = "cuda", backend: Optional[str] = None) -> Mesh:
    """(1, tp) mesh for tensor-parallel serving: one replica, ``tp`` model
    shards. Pass it to ``EngineConfig(mesh=...)`` on every rank. At tp = 1
    without a process group it is the single-device mesh; at tp > 1 it
    needs a process group of ``tp`` ranks (`make_mesh`)."""
    import torch.distributed as dist

    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", tp)))
    if world != tp:
        raise NotImplementedError(
            f"a process group of {world} ranks for a (1, {tp}) serving mesh: serving with data "
            "axes > 1 is not ported yet (ROADMAP.md, Modules to port)")
    return make_mesh({"data": 1, "model": tp}, device, backend)


def make_train_mesh(shape: Mapping[str, int], device: str = "cuda",
                    backend: Optional[str] = None) -> Mesh:
    """A training mesh of ``shape`` (`make_mesh`): FSDP and the batch over
    ``pod`` / ``data``, the training layout's shards over ``model``."""
    return make_mesh(shape, device, backend)


def driver_shape(kind: str, world: int, model: int = 1) -> Dict[str, int]:
    """The train driver's mesh over ``world`` ranks with a model axis of
    ``model``: ``none`` (one rank), ``single`` (data W / M, model M),
    ``multi`` (pod 2, data W / 2M, model M). A world that does not divide
    raises ValueError."""
    if model < 1:
        raise ValueError(f"the model axis must be >= 1, got {model}")
    if kind == "none":
        if world != 1:
            raise ValueError(f"mesh 'none' is one rank; the world has {world}")
        return {"data": 1, "model": 1}
    if kind == "single":
        if world % model:
            raise ValueError(f"mesh 'single' puts a model axis of {model} over the world; "
                             f"{world} ranks do not divide by it")
        return {"data": world // model, "model": model}
    if kind == "multi":
        if world % (2 * model):
            raise ValueError(f"mesh 'multi' puts two pods with a model axis of {model} over "
                             f"the world; {world} ranks do not split in two pods of it")
        return {"pod": 2, "data": world // (2 * model), "model": model}
    raise ValueError(f"unknown mesh kind {kind!r} (none, single, multi)")


def make_driver_mesh(kind: str = "none", device: str = "cuda", model: int = 1) -> Mesh:
    """The train driver's ``--mesh`` on every rank of the world
    (`driver_shape`); without a process group the world is one rank."""
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    return make_train_mesh(driver_shape(kind, world, model), device)


def dp_axes(mesh) -> tuple:
    """The mesh's data-parallel axes of size > 1 (``pod``, ``data``)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data") and mesh.shape[a] > 1)


def tp_axis(mesh) -> str:
    return "model"


# --------------------------------------------------------------------- spawn
def _entry(rank: int, fn, shape, device: str, backend: Optional[str], tmp: str, args):
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # gloo over loopback only
    # the parent signals SIGUSR1 at the deadline: every thread's stack to a file
    stacks = open(Path(tmp) / f"stack{rank}.txt", "w")
    faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
    world = math.prod(_normal_shape(shape).values())
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or choose_backend(world, device),
                            init_method=f"file://{tmp}/store", rank=rank, world_size=world)
    out = Path(tmp) / f"result{rank}.pkl"
    try:
        mesh = make_mesh(shape, device)
        res = fn(mesh, *args)
        out.write_bytes(pickle.dumps(("ok", res)))
    except BaseException as e:          # the parent re-raises it with the rank's traceback
        out.write_bytes(pickle.dumps(("error", f"rank {rank}: {e!r}\n{traceback.format_exc()}")))
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, shape: Mapping[str, int], device: str = "cuda", *args,
          backend: Optional[str] = None, deadline: float = 1800.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on one spawned process per rank of the mesh
    ``shape`` (its axis sizes, `make_mesh`; a (1, tp) serving mesh is
    ``{"model": tp}``) on ``device`` and return the results in rank order.
    A rank's exception is re-raised as RuntimeError with that rank's
    traceback; past ``deadline`` seconds the world is killed and
    RuntimeError carries every live rank's stacks (a rank waiting on a
    collective that another rank never joins)."""
    import torch.multiprocessing as mp

    world = math.prod(_normal_shape(shape).values())
    tmp = tempfile.mkdtemp(prefix="repro-mesh-")

    def read(rank: int):
        p = Path(tmp) / f"result{rank}.pkl"
        return pickle.loads(p.read_bytes()) if p.exists() else None

    def errors() -> List[str]:
        return [m[1] for m in map(read, range(world)) if m and m[0] == "error"]

    try:
        ctx = mp.start_processes(_entry, args=(fn, shape, device, backend, tmp, args),
                                 nprocs=world, join=False, start_method="spawn")
        end = time.monotonic() + deadline
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, end - time.monotonic()))):
                if time.monotonic() < end:
                    continue
                live = [p for p in ctx.processes if p.is_alive()]
                for p in live:
                    os.kill(p.pid, signal.SIGUSR1)
                time.sleep(2.0)
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                stacks = []
                for r in range(world):
                    f = Path(tmp) / f"stack{r}.txt"
                    text = f.read_text() if f.exists() else ""
                    if text.strip():
                        stacks.append(f"rank {r} at the deadline:\n{text}")
                raise RuntimeError("\n".join(
                    [f"the world of {world} ranks outlived its deadline of {deadline:.0f} s "
                     "and was killed"] + errors() + stacks))
        except RuntimeError:
            raise
        except Exception as e:          # a rank failed: its own message, if it wrote one
            raise RuntimeError("\n".join(errors()) or str(e)) from None
        return [read(r)[1] for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
