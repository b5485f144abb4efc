"""Parameter sharding (port of src/repro/launch/sharding.py): the layout of
tensor-parallel serving, ``param_spec(serve_n_shard=True, moe="ep")``, the
training layout at model = 1, ``param_spec(fsdp="data", moe="tp")``, and
the slicing that applies them.

Training (`fsdp_dim`, `params_shardings`): FSDP shards a plain 2-D ``w``
(after its stacked dims) over ``data`` where both of its last two dims are
>= 1024; which dim follows the linear's class, as in the reference: a
column-parallel linear (``wq``, ``w_up``, ``lm_head``, ...) and a
replicated one shard their K rows, a row-parallel one (``wo``,
``w_down``, ...) its N columns. The embedding is never FSDP-sharded (the
reference shards it over ``model`` only), nor are biases, norms, vectors
and the smaller factors. An expert's FFN follows the dense rule (``moe=
"tp"``: the expert dim is whole). A rank holds slice ``data_index`` of
each such leaf of the masters, m and v (`shard_tree(..., dims=)`); the
train step all-gathers the bf16 compute copies (`unshard_tree`).

Serving:

In that layout every linear of the served blocks is N-sharded: its output
dim over the ``model`` axis, row-parallel ones (``wo``, ``w_down``,
Mamba's ``x_proj`` / ``out_proj``, the RG-LRU's gates and ``out_proj``)
too, so every decode contraction keeps its K dim whole on each rank and
sharded streams are bit-identical to tp = 1 (the only cross-rank traffic
is an exact all-gather of activations, `models.parallel`). Quantized
planes ``hi`` / ``lsb`` [.., K_rows, N] and ``scale`` [.., N] shard N; the
embedding shards its vocab rows; experts shard their expert dim; the
router, the norms and MLA's down-projections ``wq_a`` / ``wkv_a`` stay
whole (the reference's REPLICATED; its packed-plane rule would shard the
planes of those two as well, which the port does not: every rank computes
the whole latent). The SSM / RG-LRU vectors of the inner width (A_log
[di, n] along di, D, Λ, the conv bias) and the conv taps [w, di] shard
the inner width. Mamba's ``in_proj`` [D, 2 di] is the two halves [x | z]:
a rank holds its slice of each, side by side (`in_proj_halves`), so its x
and z channels pair up. AMS groups run along K and the scale is per column
(`core.ams`), so quantizing a weight and slicing its planes equals
quantizing the slice.

Page pools are head-sharded by `models.make_cache(tp=)`
(`models.parallel.heads_split`); page ids, block tables and the prefix
index never see the mesh. Contiguous caches are sequence-sharded
(`cache_shard_dim`, the reference's ``cache_spec(seq_shard=True)``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# linears of the served blocks (GQA, MoE-GQA, MLA, Mamba, RG-LRU, the head)
# whose N is sharded
N_SHARDED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
             "wq_b", "w_uk", "w_uv",
             "in_proj", "x_proj", "dt_proj", "out_proj",
             "in_x", "in_gate", "w_rec_gate", "w_in_gate"}
# linears every rank holds whole (the reference's REPLICATED)
WHOLE = {"router", "wq_a", "wkv_a"}
# vectors of the inner width, sharded along it (the reference's MODEL_VECTORS)
INNER_VECTORS = {"A_log", "D", "lam", "conv_b"}
# the reference's row-parallel linears: FSDP shards their N columns, every
# other linear (column-parallel or replicated) its K rows
ROW_PARALLEL = {"wo", "w_down", "out_proj", "x_proj", "w_rec_gate", "w_in_gate"}
# FSDP shards a weight only where both of its last two dims are at least this
FSDP_MIN_DIM = 1024


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
    if parent in WHOLE:
        return None
    if last in ("hi", "lsb", "scale"):
        return leaf.ndim - 1
    if last == "w" and "embed" in (parent, gparent):
        return n_stack                                  # vocab rows
    if last in ("w", "b") and parent in N_SHARDED:
        return leaf.ndim - 1
    if last in INNER_VECTORS:
        return n_stack                                  # di (A_log [di, n]), W
    if last == "conv_w":
        return leaf.ndim - 1                            # [w, di]
    return None


def in_proj_halves(names: Sequence[str]) -> int:
    """How many equal parts the sharded dim of the leaf at ``names`` holds,
    each sliced on its own: Mamba's ``in_proj`` is [x | z], 2; else 1."""
    return 2 if "in_proj" in [str(n) for n in names] else 1


def fsdp_dim(names: Sequence[str], leaf, n_stack: int = 0) -> Optional[int]:
    """The dim of the leaf at path ``names`` sharded over ``data`` in the
    training layout at model = 1 (the reference's ``param_spec(...,
    fsdp="data", moe="tp")``), or None. ``n_stack``: its leading stacked
    dims (the layers' G); an expert's leaf has one more, the expert dim."""
    names = [str(n) for n in names]
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    if last != "w" or "embed" in (parent, gparent):
        return None
    lead = n_stack + ("experts" in names)
    if leaf.dim() - lead != 2 or min(leaf.shape[-2:]) < FSDP_MIN_DIM:
        return None
    return leaf.dim() - 1 if parent in ROW_PARALLEL else leaf.dim() - 2


def params_shardings(params, *, fsdp: bool = True):
    """The training layout of a params(-shaped) tree at model = 1: a tree of
    the dim each leaf shards over ``data`` (`fsdp_dim`; the leaves under
    ``layers`` have one stacked dim), None where it is whole (every leaf,
    without ``fsdp``)."""
    def visit(names, node):
        if isinstance(node, dict):
            return {k: visit(names + [k], v) for k, v in node.items()}
        if not fsdp:
            return None
        return fsdp_dim(names, node, int(bool(names) and names[0] == "layers"))

    return visit([], params)


def unshard_tree(tree, dims, ctx):
    """The whole leaves of a tree of FSDP slices: each leaf whose ``dims``
    entry is a dim all-gathered along it over ``data`` in rank order
    (`ParallelCtx.all_gather_dim`), the others as they are."""
    def visit(node, d):
        if isinstance(node, dict):
            return {k: visit(v, d[k]) for k, v in node.items()}
        return node if d is None else ctx.all_gather_dim(node, d, "data")

    return visit(tree, dims)


def _slice(t: torch.Tensor, dim: Optional[int], rank: int, tp: int,
           parts: int = 1) -> torch.Tensor:
    """Rank ``rank``'s 1 / tp of ``t`` along ``dim``: of each of its
    ``parts`` equal parts, side by side."""
    if dim is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % (tp * parts):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over tp={tp}"
                         + (f" in {parts} parts" if parts > 1 else ""))
    w, m = n // parts, n // (tp * parts)
    return torch.cat([t.narrow(dim, i * w + rank * m, m) for i in range(parts)], dim=dim)


def shard_tree(tree, rank: int, tp: int, prefix: Sequence[str] = (),
               n_stack: Optional[int] = None, dims=None):
    """Rank ``rank``'s slice of every leaf of the serving tree ``tree``
    found at path ``prefix`` in the full params. ``n_stack`` defaults to 1
    under ``layers`` (the stacked repeats), else 0. With ``dims`` (a tree
    of dims, `params_shardings`) each leaf is cut along its own entry
    instead, in ``tp`` parts (the FSDP slices of a data axis of that
    size)."""
    def visit(names, node, d):
        if isinstance(node, dict):
            return {k: visit(names + [k], v, None if d is None else d[k])
                    for k, v in node.items()}
        if dims is not None:
            return _slice(node, d, rank, tp)
        ns = n_stack if n_stack is not None else int(bool(names) and names[0] == "layers")
        return _slice(node, serve_shard_dim(names, node, ns), rank, tp, in_proj_halves(names))

    return visit(list(prefix), tree, dims)


def cache_shard_dim(names: Sequence[str], leaf, n_stack: int = 0) -> Optional[int]:
    """The dim of a contiguous cache leaf split over ``model`` at decode
    (the reference's ``cache_spec(seq_shard=True)``): the sequence of
    ``k`` / ``v`` / ``kv`` [.., B, S, ...] (a ring's slots too), the inner
    width of ``conv`` [.., B, w - 1, di], ``ssm`` [.., B, di, n] and
    ``state`` [.., B, W]. `models.make_cache(tp=)` makes a rank's leaves
    with these dims cut to 1 / tp."""
    last = str(names[-1])
    if last in ("k", "v", "kv"):
        return n_stack + 1
    if last == "conv":
        return leaf.ndim - 1
    if last in ("ssm", "state"):
        return n_stack + 1
    return None


def shard_params(params, ctx):
    """One rank's serving params: each leaf of the full serving tree sliced
    along its `serve_shard_dim`. ``ctx``: a `models.parallel.ParallelCtx`."""
    if ctx.tp == 1:
        return params
    return shard_tree(params, ctx.rank, ctx.tp)
