"""Parallelism context threaded through model code (port of
src/repro/models/parallel.py, over torch.distributed).

The model definitions stay mesh-agnostic: with ``NO_CTX`` (unit tests, one
device) every layer runs its single-device path; with the context of a
(1, tp) serving mesh (`launch.mesh.make_serving_mesh`) each process is one
rank of the ``model`` axis, holds its shards of the weights
(`launch.sharding`) and its kv heads of the page pools, and the layers
exchange activations through the two collectives below. Neither splits a
sum across ranks in an order that depends on the backend, so a tp > 1
step gives every rank the bits of the tp = 1 step:

  * `all_gather_last` concatenates the ranks' slices along the last axis
    in rank order (the N-sharded outputs of every linear, the attention
    output before ``wo``, the FFN's hidden before ``w_down``);
  * `sum_ranks` all-gathers and adds the ranks' tensors in rank order,
    ``((r0 + r1) + r2) + ...``, the same on every rank (the vocab-sharded
    embedding lookup, expert parallelism's partial sums, the merge of the
    sequence-sharded flash-decode's ``l`` and ``o``). No ``all_reduce``:
    its association differs by backend and algorithm;
  * `max_ranks` all-gathers and takes the element-wise max, which is exact
    in any order (the merge's running max ``m``).

Contiguous caches at tp > 1 are sequence-sharded (``seq_shard``, as the
reference's ``seq_shard_cache``): rank r holds positions r * S_loc ..
(r + 1) * S_loc - 1 of every slot's K / V rows (of a ring's slots), and
the recurrent states' inner width in slices of d_inner / tp channels.

A collective of CUDA tensors over a backend without CUDA transport (gloo,
the backend of ranks that share one card) is staged explicitly through
pinned host buffers of the mesh: device -> host, the gather on the host,
host -> device. The mesh counts the calls and the host seconds they take
(`Mesh.collective_calls` / ``collective_seconds``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[object] = None          # launch.mesh.Mesh
    dp_axes: Tuple[str, ...] = ()          # mesh axes the batch is sharded over (none yet)
    tp_axis: Optional[str] = None          # the tensor / expert-parallel axis
    # contiguous caches sharded over their sequence (decode at tp > 1; off
    # for page pools, which shard their heads, and at tp = 1)
    seq_shard: bool = False

    @property
    def tp(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]

    @property
    def rank(self) -> int:
        """This process's index along the model axis."""
        return self.mesh.rank if self.tp > 1 else 0

    @property
    def seq_rank(self) -> int:
        """The index of this rank's sequence shard of a contiguous cache (0
        where the cache is whole)."""
        return self.rank if self.seq_shard and self.tp > 1 else 0

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along the last axis in rank order."""
        if self.tp == 1:
            return x
        return torch.cat(self._gather(x), dim=-1)

    def all_gather_last_each(self, *xs: torch.Tensor) -> List[torch.Tensor]:
        """`all_gather_last` of each of ``xs`` (one dtype, one leading
        shape) in one exchange of their concatenation."""
        if self.tp == 1:
            return list(xs)
        parts = self._gather(torch.cat(xs, dim=-1))
        out, lo = [], 0
        for x in xs:
            w = x.shape[-1]
            out.append(torch.cat([p[..., lo:lo + w] for p in parts], dim=-1))
            lo += w
        return out

    def sum_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` added in rank order, ``((r0 + r1) + r2) + ...``:
        the same bits on every rank."""
        if self.tp == 1:
            return x
        parts = self._gather(x)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return s

    def max_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise max of the ranks' ``x`` (exact in any order)."""
        if self.tp == 1:
            return x
        return torch.stack(self._gather(x)).amax(dim=0)

    def _gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (same shape and dtype on every rank), in rank
        order, on x's device. The bytes travel, so any dtype is exact."""
        import torch.distributed as dist

        mesh, tp = self.mesh, self.tp
        t0 = time.perf_counter()
        x = x.contiguous()
        flat = x.reshape(-1).view(torch.uint8)
        n = flat.numel()
        if x.is_cuda and mesh.backend == "nccl":
            out = torch.empty((tp, n), dtype=torch.uint8, device=x.device)
            dist.all_gather_into_tensor(out, flat, group=mesh.group)
        elif x.is_cuda:
            send, recv = mesh.staging(n, tp)
            send.copy_(flat)                         # waits for x on its stream
            dist.all_gather(list(recv.unbind(0)), send, group=mesh.group)
            out = recv.to(x.device)                  # pinned -> device, before reuse
        else:
            out = torch.empty((tp, n), dtype=torch.uint8)
            dist.all_gather(list(out.unbind(0)), flat, group=mesh.group)
        mesh.collective_calls += 1
        mesh.collective_seconds += time.perf_counter() - t0
        return [out[r].view(x.dtype).reshape(x.shape) for r in range(tp)]


NO_CTX = ParallelCtx()


def heads_split(kv: int, tp: int) -> bool:
    """Whether ``kv`` kv heads split over a model axis of ``tp`` ranks: a
    rank then holds kv / tp heads of every page-pool plane and attends with
    its own q heads; otherwise every rank holds the whole pool (the
    reference's `pool_shardings` rule)."""
    return tp > 1 and kv % tp == 0
