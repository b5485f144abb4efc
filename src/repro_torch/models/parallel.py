"""Parallelism context threaded through model code (port of
src/repro/models/parallel.py, over torch.distributed).

The model definitions stay mesh-agnostic: with ``NO_CTX`` (unit tests, one
device) every layer runs its single-device path; with the context of a
(1, tp) serving mesh (`launch.mesh.make_serving_mesh`) each process is one
rank of the ``model`` axis, holds its shards of the weights
(`launch.sharding`) and its kv heads of the page pools, and the layers
exchange activations through the collectives below; with the context of a
training mesh (`launch.mesh.make_train_mesh`) each process holds its rows
of the batch (``dp_axes``) and its FSDP slices of the masters, and the
train step (`launch.steps.build_train_step`) exchanges weights and grads
over ``data`` and ``pod``, and, with a model axis, the forward runs the
reference's column / row pairing (``train_layout``, below). Every
collective takes the mesh axis it runs over (``"model"`` by default).
None splits a sum across ranks in an order that depends on the backend,
so every rank gets the same bits, and a tp > 1 serving step gives every
rank the bits of the tp = 1 step:

  * `all_gather_last` concatenates the ranks' slices along the last axis
    in rank order (the N-sharded outputs of every linear, the attention
    output before ``wo``, the FFN's hidden before ``w_down``);
    `all_gather_dim` along any dim (an FSDP leaf from its slices);
  * `sum_ranks` all-gathers and adds the ranks' tensors in rank order,
    ``((r0 + r1) + r2) + ...``, the same on every rank (the vocab-sharded
    embedding lookup, expert parallelism's partial sums, the merge of the
    sequence-sharded flash-decode's ``l`` and ``o``, replicated grads).
    No ``all_reduce``: its association differs by backend and algorithm;
  * `reduce_scatter_ranks` gives each rank its 1 / w slice of the rank-order
    sum (each rank's slice the bits `sum_ranks` gives it), from an
    ``all_to_all``: no ``reduce_scatter`` either (the FSDP grads);
  * `sum_ranks_grad` is `sum_ranks` under autograd: its backward passes
    the gradient through unchanged (a batch-wide statistic of a forward
    whose rows are sharded, the MoE load-balance loss's);
  * `max_ranks` all-gathers and takes the element-wise max, which is exact
    in any order (the merge's running max ``m``).

Tensor-parallel training (``train_layout`` on a ctx of tp > 1, `col_row`)
pairs two conjugate operations under autograd, as Megatron's f / g, and
gathers where heads do not split:

  * `copy_ranks`: the identity forward, `sum_ranks` over ``model`` in the
    backward. It takes the replicated input of every column-parallel group
    (``wq / wk / wv``, ``w_gate / w_up``, each expert's FFN, ``lm_head``),
    whose ranks' partial input grads add up to the whole one;
  * `sum_ranks_grad` over ``model``: `sum_ranks` forward, the identity
    backward. It adds every row-parallel product's partial sums (``wo``,
    ``w_down``), the vocab-sharded embedding lookup and the loss's
    vocab-sharded statistics;
  * `gather_ranks_grad`: `all_gather_last` forward, the rank's slice of the
    rank-order sum backward (k / v where the kv heads do not split).

Every rank runs the same graph, so autograd issues the backward's
collectives in one order on every rank (the rematerialised forward's, under
`torch.utils.checkpoint`, too), and a replicated leaf's grad comes out with
the same bits on every model rank without a reduction.

Contiguous caches at tp > 1 are sequence-sharded (``seq_shard``, as the
reference's ``seq_shard_cache``): rank r holds positions r * S_loc ..
(r + 1) * S_loc - 1 of every slot's K / V rows (of a ring's slots), and
the recurrent states' inner width in slices of d_inner / tp channels.

A collective of CUDA tensors over a backend without CUDA transport (gloo,
the backend of ranks that share one card) is staged explicitly through
the mesh's one pinned host buffer (`Mesh.stage`), in chunks that fit it:
device -> host, the exchange on the host, host -> device. The mesh counts
the calls, the host seconds they take and the bytes the rank sent by
collective (`Mesh.collective_calls` / ``collective_seconds`` /
``collective_bytes``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[object] = None          # launch.mesh.Mesh
    # mesh axes whose ranks hold other rows of one forward's batch, over
    # which its batch-wide statistics sum (training; () when serving)
    dp_axes: Tuple[str, ...] = ()
    tp_axis: Optional[str] = None          # the tensor / expert-parallel axis
    # contiguous caches sharded over their sequence (decode at tp > 1; off
    # for page pools, which shard their heads, and at tp = 1)
    seq_shard: bool = False
    # the training layout over ``model`` (`launch.sharding.train_dims`:
    # column-parallel linears shard N, row-parallel ones K, the embedding
    # its vocab); False: the serving layout (every linear N-sharded)
    train_layout: bool = False

    @property
    def col_row(self) -> bool:
        """Whether the layers run the training layout's column / row
        pairing: ``train_layout`` at tp > 1. Every layer that shards a
        linear asks this one rule."""
        return self.train_layout and self.tp > 1

    @property
    def tp(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]

    @property
    def rank(self) -> int:
        """This process's index along the model axis (the innermost one in
        rank order)."""
        return self.mesh.rank % self.tp if self.tp > 1 else 0

    @property
    def seq_rank(self) -> int:
        """The index of this rank's sequence shard of a contiguous cache (0
        where the cache is whole)."""
        return self.rank if self.seq_shard and self.tp > 1 else 0

    def size(self, axis: str = "model") -> int:
        """The number of ranks along ``axis`` (1 without a mesh)."""
        if axis == "model":
            return self.tp
        return 1 if self.mesh is None else self.mesh.size(axis)

    def coord(self, axis: str = "model") -> int:
        """This rank's index along ``axis``."""
        return 0 if self.size(axis) == 1 else self.mesh.coord(axis)

    def all_gather_last(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """The ranks' ``x`` concatenated along the last axis in rank order."""
        return self.all_gather_dim(x, -1, axis)

    def all_gather_dim(self, x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        if self.size(axis) == 1:
            return x
        return torch.cat(self._gather(x, axis), dim=dim)

    def all_gather_last_each(self, *xs: torch.Tensor, axis: str = "model") -> List[torch.Tensor]:
        """`all_gather_last` of each of ``xs`` (one dtype, one leading
        shape) in one exchange of their concatenation."""
        if self.size(axis) == 1:
            return list(xs)
        parts = self._gather(torch.cat(xs, dim=-1), axis)
        out, lo = [], 0
        for x in xs:
            w = x.shape[-1]
            out.append(torch.cat([p[..., lo:lo + w] for p in parts], dim=-1))
            lo += w
        return out

    def gather_ranks(self, x: torch.Tensor, axis: str = "model",
                     kind: str = "all_gather") -> List[torch.Tensor]:
        """Every rank's ``x`` along ``axis``, in rank order (``kind`` names
        the exchange in the mesh's byte counts)."""
        if self.size(axis) == 1:
            return [x]
        return self._gather(x, axis, kind)

    def sum_ranks(self, x: torch.Tensor, axis="model") -> torch.Tensor:
        """The ranks' ``x`` added in rank order, ``((r0 + r1) + r2) + ...``:
        the same bits on every rank. ``axis``: one axis, or a tuple summed
        one axis after the other (the last first)."""
        for a in reversed((axis,) if isinstance(axis, str) else tuple(axis)):
            if self.size(a) == 1:
                continue
            parts = self._gather(x, a, "sum")
            x = parts[0]
            for p in parts[1:]:
                x = x + p
        return x

    def sum_ranks_grad(self, x: torch.Tensor, axis="data") -> torch.Tensor:
        """`sum_ranks` that autograd records: the backward passes the
        gradient through unchanged, so each rank's ``x`` takes the gradient
        of the sum (the ranks' grads are summed later, with the weights')."""
        if all(self.size(a) == 1 for a in ((axis,) if isinstance(axis, str) else axis)):
            return x
        return _SumRanks.apply(x, self, axis)

    def copy_ranks(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """``x`` as it is, recorded by autograd so that the backward adds
        the ranks' gradients of it in rank order (`sum_ranks`): the
        replicated input of a column-parallel group."""
        if self.size(axis) == 1:
            return x
        return _CopyRanks.apply(x, self, axis)

    def gather_ranks_grad(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """`all_gather_last` recorded by autograd: the backward hands each
        rank its slice of the rank-order sum of the ranks' gradients."""
        if self.size(axis) == 1:
            return x
        return _GatherRanks.apply(x, self, axis)

    def max_ranks(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """The element-wise max of the ranks' ``x`` (exact in any order)."""
        if self.size(axis) == 1:
            return x
        return torch.stack(self._gather(x, axis, "max")).amax(dim=0)

    def reduce_scatter_ranks(self, flat: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Rank r's slice r of ``flat`` [n] (n a multiple of the axis's w
        ranks) summed over the ranks in rank order: ``flat`` split in w
        slices of n / w, slice j sent to rank j (``all_to_all``), the w
        received added ``((r0 + r1) + r2) + ...``: the bits of `sum_ranks`'s
        slice r, at 1 / w of its traffic."""
        w = self.size(axis)
        if w == 1:
            return flat
        import torch.distributed as dist

        mesh = self.mesh
        n = flat.numel()
        if flat.dim() != 1 or n % w:
            raise ValueError(f"reduce_scatter_ranks takes a flat tensor of a multiple of {w} "
                             f"elements, got {tuple(flat.shape)}")
        t0 = time.perf_counter()
        s, es = n // w, flat.element_size()
        parts = flat.contiguous().view(w, s)
        out = torch.empty(s, dtype=flat.dtype, device=flat.device)
        group = mesh.groups[axis]
        if flat.is_cuda and mesh.backend == "nccl":
            recv = torch.empty((w, s), dtype=flat.dtype, device=flat.device)
            dist.all_to_all_single(recv, parts, group=group)
            _add_rows(recv, out)
        else:
            step = _chunk(s, 2 * w * es, mesh.stage().numel() if flat.is_cuda else _CPU_CHUNK)
            for lo in range(0, s, step):
                m = min(step, s - lo)
                if flat.is_cuda:
                    buf = mesh.stage()
                    send = buf[:w * m * es].view(flat.dtype).view(w, m)
                    recv = buf[w * m * es:2 * w * m * es].view(flat.dtype).view(w, m)
                    send.copy_(parts[:, lo:lo + m])          # waits for flat on its stream
                    dist.all_to_all_single(recv, send, group=group)
                    _add_rows(recv.to(flat.device), out[lo:lo + m])
                else:
                    recv = torch.empty((w, m), dtype=flat.dtype)
                    dist.all_to_all_single(recv, parts[:, lo:lo + m].contiguous(), group=group)
                    _add_rows(recv, out[lo:lo + m])
        mesh.count("reduce_scatter", n * es, time.perf_counter() - t0)
        return out

    def barrier(self):
        """Every rank of the mesh waits for the others: a barrier over each
        axis's group in turn (nothing without a process group)."""
        import torch.distributed as dist

        if self.mesh is None:
            return
        for axis in self.mesh.axis_names:
            if axis in self.mesh.groups:
                dist.barrier(group=self.mesh.groups[axis])

    def _gather(self, x: torch.Tensor, axis: str = "model",
                kind: str = "all_gather") -> List[torch.Tensor]:
        """Every rank's ``x`` along ``axis`` (same shape and dtype on every
        rank), in rank order, on x's device. The bytes travel, so any dtype
        is exact."""
        import torch.distributed as dist

        mesh, w = self.mesh, self.size(axis)
        group = mesh.groups[axis]
        t0 = time.perf_counter()
        x = x.contiguous()
        flat = x.reshape(-1).view(torch.uint8)
        n = flat.numel()
        out = torch.empty((w, n), dtype=torch.uint8, device=x.device)
        if x.is_cuda and mesh.backend == "nccl":
            dist.all_gather_into_tensor(out, flat, group=group)
        else:
            step = _chunk(n, w + 1, mesh.stage().numel() if x.is_cuda else _CPU_CHUNK)
            for lo in range(0, n, step):
                m = min(step, n - lo)
                if x.is_cuda:
                    buf = mesh.stage()
                    send, recv = buf[:m], buf[m:(w + 1) * m].view(w, m)
                    send.copy_(flat[lo:lo + m])              # waits for x on its stream
                    dist.all_gather(list(recv.unbind(0)), send, group=group)
                    out[:, lo:lo + m].copy_(recv)            # pinned -> device, before reuse
                else:
                    dist.all_gather(list(out[:, lo:lo + m].unbind(0)), flat[lo:lo + m],
                                    group=group)
        mesh.count(kind, n, time.perf_counter() - t0)
        return [out[r].view(x.dtype).reshape(x.shape) for r in range(w)]


# CPU collectives run in chunks of this many bytes too (no staging: the
# chunking keeps gloo's buffers bounded and is the path the card's takes)
_CPU_CHUNK = 64 << 20


def _chunk(n: int, per: int, cap: int) -> int:
    """Elements (bytes) of one chunk of an exchange of ``n`` whose staging
    holds ``per`` bytes an element, within ``cap`` bytes: a multiple of 64
    (aligned views of any dtype), at least 64."""
    return min(n, max(64, (cap // per) // 64 * 64))


def _add_rows(recv: torch.Tensor, out: torch.Tensor):
    """out = ((recv[0] + recv[1]) + recv[2]) + ..."""
    s = recv[0]
    for p in recv[1:]:
        s = s + p
    out.copy_(s)


class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, pctx, axis):
        return pctx.sum_ranks(x, axis)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _CopyRanks(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, pctx, axis):
        fctx.pctx, fctx.axis = pctx, axis
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.pctx.sum_ranks(g, fctx.axis), None, None


class _GatherRanks(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, pctx, axis):
        fctx.pctx, fctx.axis, fctx.width = pctx, axis, x.shape[-1]
        return pctx.all_gather_last(x, axis)

    @staticmethod
    def backward(fctx, g):
        w, r = fctx.width, fctx.pctx.coord(fctx.axis)
        return fctx.pctx.sum_ranks(g, fctx.axis)[..., r * w:(r + 1) * w], None, None


NO_CTX = ParallelCtx()


def heads_split(kv: int, tp: int) -> bool:
    """Whether ``kv`` kv heads split over a model axis of ``tp`` ranks: a
    rank then holds kv / tp heads of every page-pool plane and attends with
    its own q heads; otherwise every rank holds the whole pool (the
    reference's `pool_shardings` rule)."""
    return tp > 1 and kv % tp == 0
