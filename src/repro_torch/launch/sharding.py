"""Parameter sharding (port of src/repro/launch/sharding.py): the layout of
tensor-parallel serving, ``param_spec(serve_n_shard=True, moe="ep")``, the
training layout, ``param_spec(fsdp="data" | None, moe="tp")``, and the
slicing that applies them.

Training (`train_dims`, `params_shardings`): the reference's Megatron
pairing over ``model``. A column-parallel linear (``wq``, ``w_up``,
``lm_head``, ...; `COL_PARALLEL`) shards its output dim N, a row-parallel
one (``wo``, ``w_down``, ...; `ROW_PARALLEL`) its input dim K, and the
embedding its vocab rows; a column-parallel bias shards with N, a
row-parallel bias, the norms and the replicated linears (``router``,
``wq_a``, ``wkv_a``) stay whole; the SSM / RG-LRU vectors and conv taps
shard the inner width. FSDP shards the other dim of a plain 2-D ``w``
(after its stacked dims) over ``data`` where both of its last two dims are
>= `FSDP_MIN_DIM`: K of a column-parallel or replicated linear, N of a
row-parallel one; never the embedding. An expert's FFN follows the dense
rule (``moe="tp"``: the expert dim is whole). A rank holds slice
(``model`` index, ``data`` index) of each such leaf of the masters, m and
v (`shard_tree(..., dims=)` once per axis); the train step all-gathers the
bf16 compute copies over ``data`` only (`unshard_tree`), so the model
shards stay shards.

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

from typing import Optional, Sequence, Tuple

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
# the reference's column-parallel linears (training: N over model, K over
# data) and row-parallel ones (K over model, N over data); every other
# linear is replicated (K over data)
COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "in_x", "in_gate",
                "wq_b", "w_uk", "w_uv", "dt_proj", "lm_head"}
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


def train_dims(names: Sequence[str], leaf, n_stack: int = 0,
               fsdp: bool = True) -> Tuple[Optional[int], Optional[int]]:
    """(the dim over ``model``, the dim over ``data``) of the leaf at path
    ``names`` in the training layout, each None where the leaf is whole
    along that axis: the dims where the reference's ``param_spec(path,
    leaf, fsdp="data" if fsdp else None, moe="tp", n_stack=n_stack)`` puts
    ``model`` and ``data``. ``n_stack``: its leading stacked dims (the
    layers' G); an expert's leaf has one more, the expert dim, whole."""
    names = [str(n) for n in names]
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    lead = n_stack + ("experts" in names)
    nd = leaf.dim()
    if last == "w":
        if "embed" in (parent, gparent):
            return lead, None                           # vocab rows
        if nd - lead != 2:
            return None, None
        wf = fsdp and min(leaf.shape[-2:]) >= FSDP_MIN_DIM
        if parent in COL_PARALLEL:
            return nd - 1, (nd - 2 if wf else None)
        if parent in ROW_PARALLEL:
            return nd - 2, (nd - 1 if wf else None)
        return None, (nd - 2 if wf else None)
    if last == "b":
        return (nd - 1 if parent in COL_PARALLEL else None), None
    if last in INNER_VECTORS:
        return lead, None                               # di (A_log [di, n]), W
    if last == "conv_w":
        return nd - 1, None                             # [w, di]
    return None, None


def params_shardings(params, *, fsdp: bool = True, axis: str = "data"):
    """The training layout of a params(-shaped) tree along ``axis``: a
    tree of the dim each leaf shards over it (`train_dims`; the leaves
    under ``layers`` have one stacked dim), None where it is whole (over
    ``data``: every leaf, without ``fsdp``)."""
    which = ("model", "data").index(axis)

    def visit(names, node):
        if isinstance(node, dict):
            return {k: visit(names + [k], v) for k, v in node.items()}
        n_stack = int(bool(names) and names[0] == "layers")
        return train_dims(names, node, n_stack, fsdp)[which]

    return visit([], params)


def unshard_tree(tree, dims, ctx):
    """The leaves of a tree of FSDP slices made whole: each leaf whose
    ``dims`` entry is a dim all-gathered along it over ``data`` in rank
    order (`ParallelCtx.all_gather_dim`), the others as they are."""
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
    instead, in ``tp`` parts (a training layout's slices over an axis of
    that size, `params_shardings`)."""
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
