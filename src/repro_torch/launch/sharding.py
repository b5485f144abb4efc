"""Parameter sharding of tensor-parallel serving (port of the engine-step
layout of src/repro/launch/sharding.py, ``param_spec(serve_n_shard=True,
moe="ep")``) and the slicing that applies it.

In that layout every linear of the served blocks is N-sharded: its output
dim over the ``model`` axis, row-parallel ones (``wo``, ``w_down``) too,
so every decode contraction keeps its K dim whole on each rank and sharded
streams are bit-identical to tp = 1 (the only cross-rank traffic is an
exact all-gather of activations, `models.parallel`). Quantized planes
``hi`` / ``lsb`` [.., K_rows, N] and ``scale`` [.., N] shard N; the
embedding shards its vocab rows; experts shard their expert dim; the
router and the norms stay whole. AMS groups run along K and the scale is
per column (`core.ams`), so quantizing a weight and slicing its planes
equals quantizing the slice.

Page pools are head-sharded by `models.make_cache(tp=)`
(`models.parallel.heads_split`); page ids, block tables and the prefix
index never see the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# linears of the served blocks (GQA, MoE-GQA, the head) whose N is sharded
N_SHARDED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}


def serve_shard_dim(names: Sequence[str], leaf, n_stack: int = 0) -> Optional[int]:
    """The dim of the leaf at path ``names`` sharded over ``model`` in the
    serving layout, or None (whole on every rank). ``n_stack``: its
    leading stacked dims (the layers' G)."""
    names = [str(n) for n in names]
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    if "experts" in names:
        return n_stack                                  # the expert dim
    if last in ("hi", "lsb", "scale"):
        return leaf.ndim - 1
    if last == "w" and "embed" in (parent, gparent):
        return n_stack                                  # vocab rows
    if last in ("w", "b") and parent in N_SHARDED:
        return leaf.ndim - 1
    return None


def _slice(t: torch.Tensor, dim: Optional[int], rank: int, tp: int) -> torch.Tensor:
    if dim is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over tp={tp}")
    return t.narrow(dim, rank * (n // tp), n // tp).clone()


def shard_tree(tree, rank: int, tp: int, prefix: Sequence[str] = (),
               n_stack: Optional[int] = None):
    """Rank ``rank``'s slice of every leaf of the serving tree ``tree``
    found at path ``prefix`` in the full params. ``n_stack`` defaults to 1
    under ``layers`` (the stacked repeats), else 0."""
    def visit(names, node):
        if isinstance(node, dict):
            return {k: visit(names + [k], v) for k, v in node.items()}
        ns = n_stack if n_stack is not None else int(bool(names) and names[0] == "layers")
        return _slice(node, serve_shard_dim(names, node, ns), rank, tp)

    return visit(list(prefix), tree)


def shard_params(params, ctx):
    """One rank's serving params: each leaf of the full serving tree sliced
    along its `serve_shard_dim`. ``ctx``: a `models.parallel.ParallelCtx`."""
    if ctx.tp == 1:
        return params
    return shard_tree(params, ctx.rank, ctx.tp)
