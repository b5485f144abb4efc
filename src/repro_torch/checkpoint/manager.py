"""Fault-tolerant checkpointing: sharded npz, atomic, async, resumable (port
of src/repro/checkpoint/manager.py, with its on-disk format).

Layout:  <dir>/step_<n>/shard_<i>.npz + MANIFEST.json (written LAST — a
checkpoint without a manifest is incomplete and ignored on restore, which
makes the save atomic under crash-at-any-point). A background writer thread
overlaps serialization with the next training steps; ``wait()`` drains it.

Keys are the reference's flatten paths (``params/layers/sub0/attn/wq/w``,
``opt/m/...``, ``opt/step``) in sorted-key order, so a checkpoint written
by either package restores in the other. A save copies every tensor to
host memory before it returns; a restore puts each array on the device of
the matching leaf of ``tree_like``.

Restore picks the newest *complete* step, so a node failure mid-save falls
back to the previous checkpoint (crash-consistency test covers this).

Under data and tensor parallelism a rank holds slices of some leaves
(`launch.sharding.params_shardings`: FSDP slices over ``data``, model
shards over ``model``). ``save(..., dims=, model_dims=, ctx=)`` gathers
each sliced leaf whole, over ``data`` and then over ``model`` (every rank
takes part in the exchanges), and only global rank 0 writes;
``restore(..., dims=, model_dims=, ctx=)`` reads the whole arrays on every
rank and keeps the rank's slice along both axes. A checkpoint thus holds
whole arrays in the reference's format whatever the mesh (at the
tp-padded shapes of ``init_params(tp=)``, as the reference's), and
restores at another data size (elastic re-sharding: written at dp = 2,
restored at dp = 1, and the reverse).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_from_items, tree_items


def _flatten(tree):
    """[(key, leaf)] in the reference's flatten order, keys joined by '/'."""
    return [("/".join(str(k) for k in path), leaf) for path, leaf in tree_items(tree)]


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a CPU tensor's numpy view would share its
    memory, which the train step updates in place while a save is queued)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False,
             shard_id: int = 0, num_shards: int = 1, dims=None, ctx=None, model_dims=None):
        """Snapshot to host memory now; write in the background. ``dims`` /
        ``model_dims`` (trees matching ``tree``: each leaf's dim over
        ``data`` / ``model``, or None) and ``ctx``: gather the slices whole,
        leaf by leaf, and write on rank 0 only."""
        root = ctx is None or ctx.mesh is None or ctx.mesh.rank == 0
        host = {}
        d_items = dict(tree_items(dims)) if dims is not None else {}
        m_items = dict(tree_items(model_dims)) if model_dims is not None else {}
        for path, leaf in tree_items(tree):
            d, md = d_items.get(path), m_items.get(path)
            if d is not None and ctx is not None:
                leaf = ctx.all_gather_dim(leaf, d, "data")
            if md is not None and ctx is not None:
                leaf = ctx.all_gather_dim(leaf, md, "model")
            if root:
                host["/".join(str(k) for k in path)] = _to_host(leaf)  # device -> host copy
            del leaf
        if not root:
            return
        job = (step, host, shard_id, num_shards)
        if self._thread is None or blocking:
            self._write(job)
        else:
            self._q.put(job)

    def _worker(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._write(job)
            except BaseException as e:  # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, job):
        step, host, shard_id, num_shards = job
        d = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        # unique tmp name: a blocking save may race an async save of the
        # same step (both are atomic via os.replace, last one wins)
        tmp = os.path.join(
            d, f".tmp_shard_{shard_id}_{os.getpid()}_{time.monotonic_ns()}.npz")
        np.savez(tmp, **host)
        os.replace(tmp, os.path.join(d, f"shard_{shard_id}.npz"))
        # manifest written last == commit point
        if shard_id == num_shards - 1:
            man = {"step": step, "num_shards": num_shards,
                   "time": time.time(),
                   "keys": sorted(host.keys())}
            mtmp = os.path.join(d, ".tmp_manifest")
            with open(mtmp, "w") as f:
                json.dump(man, f)
            os.replace(mtmp, os.path.join(d, "MANIFEST.json"))
            self._gc()

    def _gc(self):
        steps = self.complete_steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        """Drain pending async saves; re-raise background errors."""
        if self._thread is not None:
            self._q.join()
        if self._err:
            err, self._err = self._err, None
            raise err

    # ---------------------------------------------------------- restore
    def complete_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_"):
                continue
            if os.path.exists(os.path.join(self.dir, name, "MANIFEST.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None,
                shard_id: int = 0, dims=None, ctx=None, model_dims=None):
        """Restore into the structure of `tree_like` (shapes validated): a
        tree of tensors with the stored dtypes, each on its leaf's device
        (the CPU for a leaf that is not a tensor). ``dims`` / ``model_dims``
        and ``ctx``: a leaf of ``tree_like`` with a dim is the rank's slice
        of the stored array along ``data`` / ``model``, which is read whole
        and sliced."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        axes = [(dict(tree_items(t)), ctx.size(a), ctx.coord(a))
                for t, a in ((dims, "data"), (model_dims, "model"))
                if t is not None and ctx is not None]
        d = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(d, f"shard_{shard_id}.npz")) as data:
            items = []
            for path, like in tree_items(tree_like):
                key = "/".join(str(k) for k in path)
                arr = data[key]
                shape = list(like.shape) if torch.is_tensor(like) else list(np.shape(like))
                cuts = [(by[path], n, r) for by, n, r in axes if by.get(path) is not None]
                for dim, n, _ in cuts:
                    shape[dim] *= n
                if tuple(arr.shape) != tuple(shape):
                    raise ValueError(
                        f"checkpoint shape mismatch at {key}: {arr.shape} vs {tuple(shape)}")
                for dim, n, r in cuts:
                    if n > 1:
                        m = arr.shape[dim] // n
                        arr = np.ascontiguousarray(
                            np.take(arr, np.arange(r * m, (r + 1) * m), dim))
                device = like.device if torch.is_tensor(like) else "cpu"
                items.append((path, torch.from_numpy(arr).to(device)))
        return tree_from_items(items), step
