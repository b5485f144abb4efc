"""The continuous-batching engine step and the train step (port of
src/repro/launch/steps.py: build_engine_step, engine_step_signature,
_loss_fn and build_train_step; the engine step takes a `ParallelCtx` where
the reference takes a mesh).

The reference jits one slot-masked program per engine and donates the
cache to it. The port's step is a plain function with the same arguments:

    step(params, token [B] | [B, C], pos [B], cache, sampling, *,
         nvalid [B] = None, block_tables [B, MP] = None,
         embeds [B(, C), D] = None, embed_mask [B(, C)] = None)
        -> (next_token [B], done [B], cache)

``pos`` holds each slot's start position (negative = idle slot, its cache
write suppressed); with ``chunk`` = C > 1 every slot feeds a ragged block of
up to C tokens and ``nvalid`` its valid count; ``block_tables`` is taken by
paged caches only; ``embeds`` (f32) and ``embed_mask`` (nonzero where a
slot feeds a modality prefix embedding instead of a token) only when the
config has a modality front end (``num_prefix_embeds > 0``), as in the
reference's signature. The epilogue is the sampling draw with in-step
termination (`sampling.sample_tokens`). With ``speculate_k`` = K > 0 the
step also takes ``ndraft`` [B] (the drafts closing each slot's chunk),
scores the last ndraft + 1 positions, verifies the drafts
(`speculative.verify_tokens`) and zeroes the rejected entries' cache rows
(`speculative.truncate_cache`), all inside the step:

        -> ((out_tokens [B, K+1], n_emit [B], accepted [B], done [B]), cache)

The caches are written in place and returned. Nothing in the step waits on
the device or copies from host memory.

The engine feeds it from `StepInputs`, one set of static buffers staged in
one host buffer (pinned on the card) and sent with one copy per tick. On
CUDA tensors `GraphedStep` replays the step as CUDA graphs, one per (chunk
width, sampled) pair, the counterpart of the reference's compiled program:
the caches and inputs are the graphs' static memory, written in place. On
CPU tensors the engine calls the same step eagerly at the same widths.

Tensor-parallel serving (a ``ctx`` of tp > 1): every rank runs the step
on its shards of the weights and its kv heads of the pools, or its shard
of a contiguous cache's sequence and of the recurrent states
(`models.decode_step`; the speculative rollback zeroes the positions the
rank holds); the residual stream and the logits are replicated, so every
rank samples the same tokens. The step then runs eagerly on the card: its
collectives (gloo, staged through host memory, when the ranks share a
card) cannot be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from contextlib import contextmanager
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.tree import tree_from_items, tree_items, tree_leaves, tree_map
from repro_torch.kernels.build import add_counts, recorded_counts
from repro_torch.models import decode_step, forward_seq, layer_pattern
from repro_torch.models.parallel import NO_CTX
from repro_torch.optim import AdamWConfig, apply_updates, compressed_psum, warmup_cosine

from .mesh import dp_axes
from .sampling import any_sampled, sample_tokens
from .sharding import params_shardings, shard_tree, unshard_tree
from .speculative import truncate_cache, verify_tokens


def build_engine_step(cfg: ModelConfig, rcfg: RunConfig, cache_cfg, speculate_k: int = 0,
                      ctx=NO_CTX):
    """Returns the step function for this (model, run, cache); one function
    serves one-token and chunked ticks (`decode_step` reads the token's
    shape). Which layers the cache holds was checked where the cache was
    made (`models.make_cache`). A speculative step verifies up to
    min(speculate_k, width - 1) drafts per slot: a width-1 tick of a
    speculative engine scores one position with the same epilogue. ``ctx``:
    the rank's `models.parallel.ParallelCtx` (`NO_CTX`: one device)."""
    policy = rcfg.quant if rcfg.quantized else None

    def step(params, token, pos, cache, sampling, *, nvalid=None, block_tables=None,
             ndraft=None, embeds=None, embed_mask=None):
        emb = dict(embeds=embeds, embed_mask=embed_mask)
        if not speculate_k:
            logits, cache = decode_step(params, token, cache, pos, cfg, policy=policy,
                                        block_tables=block_tables, cache_cfg=cache_cfg,
                                        nvalid=nvalid, ctx=ctx, **emb)
            next_token, done = sample_tokens(logits, sampling)
            return next_token, done, cache
        k = min(speculate_k, token.shape[1] - 1)
        logits, cache = decode_step(params, token, cache, pos, cfg, policy=policy,
                                    block_tables=block_tables, cache_cfg=cache_cfg,
                                    nvalid=nvalid, ndraft=ndraft, n_logits=k + 1, ctx=ctx,
                                    **emb)
        if k == 0:
            logits = logits[:, None]
        out, n_emit, accepted, done = verify_tokens(logits, token, nvalid, ndraft, sampling, k)
        if k:
            # un-insert the rejected suffix in the step: positions
            # pos + 1 + accepted .. pos + ndraft go back to zeros
            truncate_cache(cache, pos + 1 + accepted, torch.clamp_min(ndraft - accepted, 0), k,
                           cache_cfg=cache_cfg, block_tables=block_tables, ctx=ctx)
        out = torch.nn.functional.pad(out, (0, speculate_k - k))
        return (out, n_emit, accepted, done), cache

    return step


class StepInputs:
    """The step's static inputs: token [B, C], pos [B], nvalid [B],
    block_tables [B, MP] (paged caches only), the sampling row ngen [B],
    ndraft [B] (speculative engines only) and, with ``d_embed`` > 0 (a
    config with prefix embeds), embed_mask [B, C] and embeds [B, C, D]. All
    are views of one device buffer (``dev``) staged through numpy views of
    one host buffer (``host``, pinned on CUDA): int32 views, and an f32
    view of the same 4-byte words for the embeds. `send` copies the host
    buffer over in one non-blocking copy: the host writes the next tick's
    inputs only after the tick's outputs were read, so the copy has landed
    by then."""

    def __init__(self, slots: int, chunk: int, max_pages: int, device: torch.device,
                 speculative: bool = False, d_embed: int = 0):
        shapes = {"token": (slots, chunk), "pos": (slots,), "nvalid": (slots,)}
        if max_pages:
            shapes["block_tables"] = (slots, max_pages)
        shapes["ngen"] = (slots,)
        if speculative:
            shapes["ndraft"] = (slots,)
        if d_embed:
            shapes["embed_mask"] = (slots, chunk)
            shapes["embeds"] = (slots, chunk, d_embed)
        n = sum(math.prod(sh) for sh in shapes.values())
        pinned = device.type == "cuda"
        self.host_buf = torch.zeros(n, dtype=torch.int32, pin_memory=pinned)
        self.dev_buf = torch.zeros(n, dtype=torch.int32, device=device)
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        off = 0
        for name, sh in shapes.items():
            size = math.prod(sh)
            host, dev = self.host_buf[off:off + size], self.dev_buf[off:off + size]
            if name == "embeds":
                host, dev = host.view(torch.float32), dev.view(torch.float32)
            self.host[name] = host.numpy().reshape(sh)
            self.dev[name] = dev.view(sh)
            off += size
        self.chunked = chunk > 1

    def send(self) -> None:
        self.dev_buf.copy_(self.host_buf, non_blocking=True)

    def set_idle(self) -> None:
        """Every slot idle: nothing is written, every cache byte stays."""
        self.host["token"][:] = 0
        self.host["pos"][:] = -1
        self.host["nvalid"][:] = 0
        if "ndraft" in self.host:
            self.host["ndraft"][:] = 0
        if "embed_mask" in self.host:
            self.host["embed_mask"][:] = 0

    def step_args(self, width: int):
        """(token, pos, nvalid, block_tables, extra keywords) device views for
        a tick of ``width`` tokens per slot: token [B] and no nvalid on a
        one-token engine, token [B, width] on a chunked one; the keywords
        hold ndraft and the embeds where the engine has them."""
        d = self.dev
        cols = slice(0, width) if self.chunked else 0
        kw = {}
        if "ndraft" in d:
            kw["ndraft"] = d["ndraft"]
        if "embeds" in d:
            kw["embeds"] = d["embeds"][:, cols]
            kw["embed_mask"] = d["embed_mask"][:, cols]
        return (d["token"][:, cols], d["pos"], d["nvalid"] if self.chunked else None,
                d.get("block_tables"), kw)


def run_step(step, params, cache, inputs: StepInputs, sampling, width: int) -> torch.Tensor:
    """The eager step on the static inputs, as one int32 block: [2, B]
    (next token, done), or for a speculative step [B, K+4] (tokens
    [B, K+1], n_emit, accepted, done)."""
    token, pos, nvalid, bt, kw = inputs.step_args(width)
    if "ndraft" not in kw:
        next_token, done, _ = step(params, token, pos, cache, sampling, nvalid=nvalid,
                                   block_tables=bt, **kw)
        return torch.stack([next_token, done.to(torch.int32)])
    (out, n_emit, accepted, done), _ = step(params, token, pos, cache, sampling,
                                            nvalid=nvalid, block_tables=bt, **kw)
    return torch.cat([out, n_emit[:, None], accepted[:, None],
                      done[:, None].to(torch.int32)], dim=1)


class GraphedStep:
    """The engine step as CUDA graphs, one per (chunk width, sampled), each
    captured at its first use: one warm-up run with every slot idle on the
    capture stream (it builds the kernels and libraries, sets the kernels'
    shared-memory limits, fills the constant tables and leaves every cache
    byte as it was), then the capture. ``sampled`` is the host's choice of
    the epilogue (`sampling.any_sampled`), which the step reads from the
    sampling rows at capture: a greedy graph runs only the argmax. All
    graphs of one engine share one memory pool; their replays never
    overlap. A failed capture raises.

    A replay runs no kernel wrapper, so the launch counts the capture moved
    (`kernels.build.recorded_counts`) are added once per replay."""

    def __init__(self, step, params, cache, inputs: StepInputs, sampling):
        self._run = lambda width: run_step(step, params, cache, inputs, sampling, width)
        self.inputs = inputs
        self.sampling = sampling
        self.device = inputs.dev_buf.device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: Dict[Tuple[int, bool], tuple] = {}   # key -> (graph, out, moved)
        self.capture_seconds: Dict[Tuple[int, bool], float] = {}
        self.pool_bytes = 0

    def capture(self, width: int, sampled: bool = False) -> None:
        if any_sampled(self.sampling) != sampled:
            raise RuntimeError(f"capture of the sampled={sampled} graph while the sampling "
                               "rows say otherwise")
        inputs, dev = self.inputs, self.device
        t0 = time.perf_counter()
        staged = inputs.host_buf.clone()
        inputs.set_idle()
        inputs.send()
        s = self.stream
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            self._run(width)
        s.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph collects garbage before it starts the capture; a
        # collection during it could free another engine's graphs, which
        # CUDA refuses while a stream captures (the capture would fail)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with recorded_counts() as moved:
                with torch.cuda.graph(graph, pool=self.pool, stream=s):
                    out = self._run(width)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.empty_cache()
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        inputs.host_buf.copy_(staged)
        self.graphs[width, sampled] = (graph, out, moved)
        self.capture_seconds[width, sampled] = time.perf_counter() - t0

    def __call__(self, width: int, sampled: bool = False) -> torch.Tensor:
        """Send the staged inputs and replay the graph of (``width``,
        ``sampled``) (captured first if new) on the current stream: the
        static output block."""
        if (width, sampled) not in self.graphs:
            self.capture(width, sampled)
        graph, out, moved = self.graphs[width, sampled]
        self.inputs.send()
        graph.replay()
        add_counts(moved)
        return out


# block kinds whose cache is a recurrent state that every step advances
RECURRENT_KINDS = ("mamba", "rec")


@contextmanager
def recurrent_states_kept(cache, cfg: ModelConfig):
    """Put the caches of a model with recurrent blocks back as they were on
    exit. A replay of the step on the same staged inputs rewrites each KV
    entry the last tick wrote with the value it had, as long as every
    layer's input is the tick's; a recurrent block's states advance once
    more, though, and every later layer's entries (a hybrid's ring slots)
    are written from them. Timed and profiled replays run inside this: a
    model with a block kind of `RECURRENT_KINDS` in its pattern gets its
    whole cache (stacked repeats and tail) back; any other keeps no copy."""
    saved = []
    if any(kind in RECURRENT_KINDS for kind in layer_pattern(cfg)):
        saved = [(t, t.clone()) for t in tree_leaves(cache)]
    try:
        yield
    finally:
        for t, s in saved:
            t.copy_(s)


def engine_step_signature(cfg: ModelConfig, rcfg: RunConfig, cache_cfg=None,
                          chunk: int = 1, speculate_k: int = 0, tp: int = 1) -> dict:
    """Identity of one engine step: cache mode x attention impl x chunk x
    weight scheme x slot count x the model axis's size."""
    return dict(
        arch=cfg.name,
        scheme=rcfg.quant.scheme if rcfg.quantized else "fp16",
        cache=cache_cfg.kind if cache_cfg is not None else "contiguous",
        kv_scheme=(cache_cfg.kv_scheme
                   if cache_cfg is not None and cache_cfg.quantized else "bf16"),
        impl=cache_cfg.impl if cache_cfg is not None else "ref",
        slots=rcfg.global_batch,
        chunk=chunk,
        speculate_k=speculate_k,
        tp=tp,
    )


# ---------------------------------------------------------------------------
# TRAIN
# ---------------------------------------------------------------------------
def _loss_fn(params, tokens, targets, cfg: ModelConfig, rcfg: RunConfig, prefix,
             dtype=torch.bfloat16, ctx=NO_CTX, nll_scale: float = 1.0):
    """(nll_scale * loss + 0.01 aux, loss + 0.01 aux): the f32 log-softmax
    NLL mean over the target positions (the prefix positions skipped) plus
    the MoE load-balance loss (over the tokens of ``ctx.dp_axes``' ranks).
    The first is differentiated: ``nll_scale`` is the rank's share of a mean
    over the ranks' rows (1: the two are one tensor). In the training
    layout at tp > 1 the logits are the rank's vocab columns
    (`_sharded_nll`)."""
    logits, aux, _ = forward_seq(params, tokens, cfg, remat=rcfg.remat,
                                 block_kv=rcfg.attn_block_kv, prefix_embeds=prefix, dtype=dtype,
                                 ctx=ctx)
    logits = logits[:, -targets.shape[1]:]
    if ctx.col_row:
        nll = _sharded_nll(logits, targets, ctx)
    else:
        ls = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(ls, -1, targets.long()[..., None])[..., 0]
    loss = nll.mean()
    total = loss + 0.01 * aux
    if nll_scale == 1.0:
        return total, total
    return loss * nll_scale + 0.01 * aux, total


def _sharded_nll(logits: torch.Tensor, targets: torch.Tensor, ctx) -> torch.Tensor:
    """-log_softmax(logits)[target] [B, S] from this rank's vocab columns
    [B, S, V / tp] (f32) of the logits: the row max over the ranks
    (`ParallelCtx.max_ranks`, detached: the NLL does not depend on it), and
    the rank's sum of exp(l - max) and its logit of the target (0 where
    another rank holds it) added over ``model`` in one rank-order sum that
    autograd passes through (`ParallelCtx.sum_ranks_grad`): each rank's
    columns take the gradient of the whole row."""
    n = logits.shape[-1]
    m = ctx.max_ranks(logits.detach().amax(dim=-1), "model")
    sum_exp = torch.exp(logits - m[..., None]).sum(dim=-1)
    local = targets.long() - ctx.rank * n
    mine = (local >= 0) & (local < n)
    t = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    both = ctx.sum_ranks_grad(torch.stack([sum_exp, torch.where(mine, t, 0.0)]), "model")
    return -((both[1] - m) - torch.log(both[0]))


def _compute_copy(x: torch.Tensor) -> torch.Tensor:
    """The leaf the forward differentiates (a rank's slice of it, before the
    gather): an f32 leaf of ndim >= 2 cast to bf16, any other leaf as it
    is, detached from the master."""
    if x.dtype == torch.float32 and x.dim() >= 2:
        return x.detach().to(torch.bfloat16)
    return x.detach()


def batch_dp(mesh, global_batch: int):
    """The dp axes actually usable for this batch size (None if B too small),
    as the reference's: every dp axis where B divides over them, else
    ``data`` alone where B divides over it."""
    axes = dp_axes(mesh) if mesh is not None else ()
    n = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if axes and global_batch % n == 0:
        return axes
    if "data" in axes and global_batch % mesh.shape["data"] == 0:
        return ("data",)
    return None


def build_train_step(cfg: ModelConfig, rcfg: RunConfig, device="cuda", ctx=NO_CTX):
    """Returns ``step_fn(params, opt_state, tokens [B, S_tok], targets [B,
    S_tok], prefix [B, P, D] or None, step) -> (params, opt_state, metrics)``
    with ``metrics = {"loss", "lr", "grad_norm"}`` (0-d f32 tensors; loss
    is the microbatches' mean of loss + 0.01 aux).

    The forward runs on bf16 copies of the f32 leaves of ndim >= 2 (1-D
    leaves stay f32), over ``n_micro = B // micro`` microbatches of
    ``micro = rcfg.microbatch or dp_n`` rows (one row per dp shard by
    default, as the reference); each microbatch's grads are added in f32
    and the sum is scaled by 1 / n_micro. Then ``warmup_cosine(step, lr,
    warmup, 10_000)`` and AdamW on the f32 masters, which, with m and v,
    are updated in place (the reference's step donates them). ``device``
    is where the inputs are expected (``cuda`` or ``cpu``).

    Data parallelism (``ctx`` of a training mesh, `launch.mesh.make_train_mesh`;
    the reference's sharded step):

      * every rank is handed the whole batch and keeps the rows the
        reference's ``P(None, dp, None)`` gives it: a contiguous micro /
        dp_n of each microbatch at dp index pod * data_n + data (`batch_dp`
        picks the dp axes; the prefix embeds alike);
      * it holds its FSDP slices of the masters, m and v
        (`launch.sharding.params_shardings` over ``data``; ``rcfg.fsdp``),
        all-gathers each sliced leaf's bf16 cast before the microbatches,
        and accumulates the f32 grads of its rows, whose NLL is scaled to its
        share of the mean (the MoE loss's means span the ranks, `forward_seq`);
      * the grads are summed over ``data`` in rank order: `reduce_scatter_ranks`
        to the rank's slice, `sum_ranks` for whole leaves;
      * over ``pod``: with ``grad_compression="int8_ag"`` the grads scaled by
        1 / npod go through `optim.compressed_psum` (f32 reduce-scatter,
        int8 all-gather), and the MoE loss's means span a pod's tokens only,
        as in the reference's pod-manual region; else the rank-order sum.
        Without a pod axis ``int8_ag`` does nothing, as in the reference;
        where a leaf is sliced over ``data`` too, its int8 shards are those
        of the rank's slice (finer than the reference's shards of the leaf);
      * the loss is the mean of the ranks' losses in rank order, and the
        global norm adds the slices' squares over ``data`` (`optim.adamw`):
        every rank's metrics and whole leaves come out bit-equal.

    Tensor parallelism (a model axis of tp > 1; the reference's column /
    row layout, ``init_params(..., tp=tp)``'s padded dims):

      * every rank of a model group takes the same rows; ``shard`` keeps
        the rank's model shard of each leaf (`launch.sharding.train_dims`)
        and, under FSDP, its data slice of that shard; only the data slices
        are gathered before the microbatches, so the forward runs on model
        shards (`forward_seq` under ``ctx.train_layout``), and the loss
        reads the vocab-sharded logits (`_sharded_nll`);
      * the grads of the rank's shards are reduced over ``data`` / ``pod``
        as above (``int8_ag``'s shards those of the rank's (model, data)
        slice); a replicated leaf's grad comes out bit-equal on every model
        rank with no reduction over ``model`` (`models.parallel`'s
        conjugate collectives), and so do its master, m and v;
      * the global norm adds the model shards' squares over ``model`` too.

    Call ``step_fn.shard(whole_params)`` first on a mesh that slices a
    leaf (FSDP, or tp > 1); ``step_fn.layout(axis)`` is then the tree of
    each leaf's dim over ``axis`` (``"data"``, the default, or
    ``"model"``)."""
    B = rcfg.global_batch
    mesh = ctx.mesh
    dp = batch_dp(mesh, B) or ()
    dp_n = math.prod(mesh.shape[a] for a in dp) if dp else 1
    micro = rcfg.microbatch or dp_n
    if B % micro:
        raise ValueError(f"global batch {B} is not a multiple of the microbatch {micro}")
    if micro % dp_n:
        raise ValueError(f"microbatch {micro} does not split over the {dp_n} dp ranks {dp}")
    n_micro = B // micro
    inv_micro = float(np.float32(1.0 / n_micro))
    compress = rcfg.grad_compression == "int8_ag" and "pod" in dp
    # the axes one forward's batch spans: within a pod where the pods
    # exchange their grads explicitly
    fwd_axes = tuple(a for a in dp if a != "pod") if compress else dp
    fwd_n = math.prod(mesh.shape[a] for a in fwd_axes) if fwd_axes else 1
    rctx = dataclasses.replace(ctx, dp_axes=fwd_axes, train_layout=True)
    tp = ctx.tp
    rows = micro // dp_n
    dp_idx = 0
    for a in dp:
        dp_idx = dp_idx * mesh.shape[a] + mesh.coord(a)
    data_n = ctx.size("data")
    inv_pod = float(np.float32(1.0 / ctx.size("pod")))
    nll_scale = float(np.float32(1.0 / fwd_n))
    inv_dp = float(np.float32(1.0 / dp_n))
    adamw = AdamWConfig(grad_clip=rcfg.grad_clip)
    device = torch.device(device)
    fsdp = rcfg.fsdp and "data" in dp          # dp holds the axes of more than one rank
    layout = {}

    def shard(params):
        """This rank's slices of the whole masters ``params`` (the layout
        is read from the whole shapes and kept for the step): its model
        shard of each leaf, then its FSDP slice of that; the tree as it is
        where nothing is sliced."""
        layout["data"] = params_shardings(params, fsdp=fsdp)
        layout["model"] = params_shardings(params, axis="model")
        if tp > 1:
            params = shard_tree(params, ctx.rank, tp, dims=layout["model"])
        if fsdp:
            params = shard_tree(params, ctx.coord("data"), data_n, dims=layout["data"])
        return params

    def reduce_grads(acc, d_items, paths):
        """The rank's accumulated f32 grads summed over its dp axes: its slice
        of each sharded leaf, each whole leaf whole."""
        if "data" in dp:
            for i, d in enumerate(d_items):         # in place: each whole leaf freed in turn
                acc[i] = (ctx.sum_ranks(acc[i], "data") if d is None
                          else _reduce_scatter_dim(ctx, acc[i], d))
        if compress:
            out = compressed_psum({p: a.mul_(inv_pod) for p, a in zip(paths, acc)}, ctx,
                                  ("pod",))
            acc = [out[p] for p in paths]
        elif "pod" in dp:
            for i in range(len(acc)):
                acc[i] = ctx.sum_ranks(acc[i], "pod")
        return acc

    def step_fn(params, opt_state, tokens, targets, prefix, step):
        if "data" not in layout:
            if fsdp or tp > 1:
                raise RuntimeError("FSDP over data or a model axis: slice the whole masters "
                                   "with step_fn.shard(params) before the first step")
            layout["data"] = params_shardings(params, fsdp=False)
        dims = layout["data"]
        items = tree_items(params)
        paths = ["/".join(path) for path, _ in items]
        d_items = [d for _, d in tree_items(dims)]
        p_cmp = tree_map(lambda t: t.requires_grad_(True),
                         unshard_tree(tree_map(_compute_copy, params), dims, ctx))
        leaves = [leaf for _, leaf in tree_items(p_cmp)]
        acc = [torch.zeros(leaf.shape, dtype=torch.float32, device=device) for leaf in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(n_micro):
            lo = i * micro + dp_idx * rows
            sel = slice(lo, lo + rows)
            pre = prefix[sel] if prefix is not None and prefix.shape[1] else None
            total, metric = _loss_fn(p_cmp, tokens[sel], targets[sel], cfg, rcfg, pre,
                                     ctx=rctx, nll_scale=nll_scale)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.to(torch.float32))
            loss_sum = loss_sum + metric.detach()
            del grads, total, metric
        del p_cmp, leaves
        acc = [a.mul_(inv_micro) for a in acc]
        loss = loss_sum * inv_micro
        if dp_n > 1:
            loss = ctx.sum_ranks(loss, dp) * inv_dp
            acc = reduce_grads(acc, d_items, paths)
        grads = tree_from_items([(path, a) for (path, _), a in zip(items, acc)])
        lr = warmup_cosine(step, rcfg.learning_rate, rcfg.warmup_steps, 10_000).to(device)
        sliced = fsdp or tp > 1
        params, opt_state, om = apply_updates(params, grads, opt_state, lr, adamw,
                                              ctx if sliced else None, dims if sliced else None,
                                              layout["model"] if tp > 1 else None)
        return params, opt_state, {"loss": loss, "lr": lr, **om}

    step_fn.shard = shard
    step_fn.layout = lambda axis="data": layout.get(axis)
    return step_fn


def _reduce_scatter_dim(ctx, a: torch.Tensor, dim: int) -> torch.Tensor:
    """The rank's slice along ``dim`` of the rank-order sum over ``data`` of
    the whole leaf ``a``: ``dim`` moved to the front so each rank's slice
    is a contiguous run of the flat tensor."""
    w = ctx.size("data")
    moved = a.movedim(dim, 0).contiguous()
    red = ctx.reduce_scatter_ranks(moved.reshape(-1), "data")
    shape = (moved.shape[0] // w,) + tuple(moved.shape[1:])
    return red.reshape(shape).movedim(0, dim).contiguous()
