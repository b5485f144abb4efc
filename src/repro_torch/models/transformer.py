"""Decoder assembly for dense GQA and MoE-GQA models (paged or contiguous
caches), absorbed-MLA models, Mamba-1 models and the RG-LRU hybrid
(contiguous caches) (port of the gqa / gqa_moe / mla / mamba / rec / attn
paths of src/repro/models/transformer.py): the one-token and ragged decode
steps (recurrent and ring-cache layers: the one-token step only), and the
full-sequence forward `forward_seq` (prefill with a contiguous cache, and
the self drafter's forward). A ``gqa_moe`` block is the ``gqa`` block with
the MoE FFN of `models.moe` in place of the dense one.

A model is a repeating pattern of block kinds (`layer_pattern`): one kind
for uniform families, ``("rec", "rec", "attn")`` for RecurrentGemma.
Parameters keep the reference's tree: ``embed``, ``layers`` (one entry
``sub{i}`` per pattern position, every leaf stacked ``[G, ...]`` over the
G whole repeats of the pattern), ``tail`` (the L mod P remaining blocks,
unstacked, present when there are any), ``final_norm``, ``lm_head``. The
reference's ``lax.scan`` over the repeats is a Python loop over views
``leaf[g]``, each repeat walking ``sub0 .. sub{P-1}``, then the tail; the
caches (page pools, or contiguous [B, S, ...] slot caches) are laid out
the same way and are written in place (recurrent states only for slots
with ``pos >= 0``: an idle slot's states stay as they were). An ``attn``
block of a model with a sliding window keeps a ring of the last
``sliding_window`` keys, slot ``position % window``. Modality prefix
embeddings (VLM patches) enter `forward_seq` ahead of the tokens, and the
decode step through its ``embeds`` / ``embed_mask`` override.

The decode steps also run as one rank of a (1, tp) serving mesh (a
`models.parallel.ParallelCtx`): the params are the rank's N-shards, page
pools hold the rank's kv heads, contiguous caches (GQA, rings, the MLA
stream) the rank's shard of the sequence (``ctx.seq_shard``; the ranks
merge their partial softmaxes), and Mamba / RG-LRU states the rank's
channels of the inner width (`make_cache(tp=)`). `forward_seq` runs as one
rank of a training mesh's model axis (``ctx.train_layout``): the
reference's column / row shards of ``gqa`` and ``gqa_moe`` blocks, the
embedding's and the head's vocab rows and columns.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_leaves, tree_map, tree_stack

from . import attention as A
from . import ffn as F
from . import moe as M
from . import ssm as S
from .common import Dims, apply_linear, make_linear, make_norm, model_dims, rms_norm
from .parallel import NO_CTX, heads_split


def layer_pattern(cfg) -> Tuple[str, ...]:
    if cfg.family == "hybrid":
        return cfg.block_pattern
    if cfg.family == "ssm":
        return ("mamba",)
    if cfg.family == "moe":
        return ("gqa_moe",)
    if cfg.attention == "mla":
        return ("mla",)
    return ("gqa",)


SERVED_PATTERNS = (("gqa",), ("gqa_moe",), ("mla",), ("mamba",), ("rec", "attn"))
ATTENTION_KINDS = ("gqa", "gqa_moe")     # GQA attention over paged or contiguous caches


def check_serving_support(cfg):
    """The port serves dense GQA, MoE-GQA and absorbed-MLA layers (any FFN
    activation, with or without modality prefix embeds), Mamba-1 layers and
    the RG-LRU hybrid (``rec`` and sliding-window ``attn`` blocks in any
    pattern)."""
    pat = layer_pattern(cfg)
    if not any(set(pat) <= set(kinds) for kinds in SERVED_PATTERNS):
        raise NotImplementedError(
            f"the port serves dense GQA, MoE-GQA, MLA, Mamba and RG-LRU hybrid layers only; "
            f"{cfg.name} has {sorted(set(pat))} (ROADMAP.md, Modules to port)")
    if cfg.num_layers < len(pat):
        raise NotImplementedError(
            f"{cfg.name} at {cfg.num_layers} layers holds no whole repeat of its pattern "
            f"{pat}: the port serves at least {len(pat)} layers")


def check_support(cfg, cache_cfg=None):
    """The one rule of which layers a cache kind holds: contiguous caches
    (``cache_cfg`` None or contiguous) every layer the port serves, paged
    caches GQA layers (dense or MoE) without a sliding window only (MLA's
    compressed stream, recurrent states and ring caches keep their
    contiguous layouts, as in the reference's `check_paged_support`)."""
    check_serving_support(cfg)
    if cache_cfg is None or not cache_cfg.paged:
        return
    bad = [k for k in layer_pattern(cfg) if k not in ATTENTION_KINDS]
    if bad:
        raise NotImplementedError(
            f"paged caches serve dense GQA and MoE-GQA layers only; {cfg.name} has "
            f"{sorted(set(bad))} "
            "(MLA streams and recurrent states keep their contiguous layouts): serve it "
            "over a contiguous cache")
    if cfg.sliding_window:
        raise NotImplementedError("paged caches do not hold sliding-window ring caches: "
                                  "serve the model over a contiguous cache")


def check_tp_support(cfg, cache_cfg, tp: int, capacity: int = 0):
    """What a model axis of ``tp`` > 1 ranks serves: every layer the port
    serves, as the reference's engine step shards it. GQA and MoE-GQA
    layers over page pools hold the rank's kv heads; contiguous caches
    (GQA, sliding-window rings, the MLA stream) hold the rank's shard of
    the sequence and merge the ranks' partial softmaxes; Mamba and RG-LRU
    layers run on the rank's slice of the inner width. A contiguous
    cache's capacity (where given), window and inner widths must divide
    over tp: ValueError otherwise. What stays unported at tp > 1 (data
    axes, the front end, CUDA graphs, the self drafters, the sequence
    forward) is refused where it is asked for."""
    if tp == 1 or (cache_cfg is not None and cache_cfg.paged):
        return
    sizes = {"capacity": capacity}
    pat = set(layer_pattern(cfg))
    if "attn" in pat and cfg.sliding_window:
        sizes["sliding_window"] = cfg.sliding_window
    if "mamba" in pat:
        sizes["d_inner"] = cfg.d_inner
    if "rec" in pat:
        sizes["lru_width"] = cfg.lru_width
    bad = {k: n for k, n in sizes.items() if n % tp}
    if bad:
        raise ValueError(f"a contiguous cache at tp={tp} splits its sequence and inner widths "
                         f"over the ranks: {bad} do not divide by {tp}")


def check_chunked_support(cfg):
    """The ragged multi-token step (``prefill_chunk`` > 1, and speculation,
    whose step is ragged) covers the attention layers without a sliding
    window only, as in the reference: a recurrence integrates its state
    token by token, and a ring cache would need chunk-aware inserts; those
    models keep the one-token step."""
    pat = layer_pattern(cfg)
    bad = [k for k in pat if k not in ATTENTION_KINDS + ("mla",)]
    if bad:
        raise NotImplementedError(
            f"chunked prefill supports gqa/gqa_moe/mla layers only; {cfg.name} has "
            f"{sorted(set(bad))}: serve it with prefill_chunk=1 and no speculation")
    if cfg.sliding_window:
        raise NotImplementedError(
            "chunked prefill does not support sliding-window ring caches: serve the "
            "model with prefill_chunk=1 and no speculation")


def pattern_counts(cfg) -> Tuple[int, int]:
    """(G, R): the whole repeats of `layer_pattern` over the layers, and
    the remaining blocks (the tail)."""
    P = len(layer_pattern(cfg))
    return cfg.num_layers // P, cfg.num_layers % P


def init_block(gen, cfg, dims: Dims, kind: str, *, dtype=torch.float32, device="cpu",
               expert_fn=None):
    """One block's params from ``gen`` (draw order: the mixer or attention,
    then the FFN; norms draw nothing). ``expert_fn``: see `moe.init_moe`."""
    if kind not in ("gqa", "gqa_moe", "attn", "mla", "mamba", "rec"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    kw = dict(dtype=dtype, device=device)
    if kind == "mamba":
        return {"ln1": make_norm(cfg.d_model, **kw), "mixer": S.init_mamba(gen, cfg, **kw)}
    if kind == "rec":
        return {"ln1": make_norm(cfg.d_model, **kw),
                "mixer": S.init_rglru(gen, cfg, **kw),
                "ln2": make_norm(cfg.d_model, **kw),
                "ffn": F.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_activation, **kw)}
    init_attn = A.init_mla if kind == "mla" else A.init_gqa
    p = {"ln1": make_norm(cfg.d_model, **kw),
         "attn": init_attn(gen, cfg, dims, **kw),
         "ln2": make_norm(cfg.d_model, **kw)}
    if kind == "gqa_moe":
        p["moe"] = M.init_moe(gen, cfg, expert_fn=expert_fn, **kw)
    else:
        p["ffn"] = F.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_activation, **kw)
    return p


def init_embed(gen, cfg, dims: Dims, *, dtype=torch.float32, device="cpu"):
    w = torch.randn((dims.V, cfg.d_model), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return {"w": w.to(dtype)}


def init_params(seed: int, cfg, *, tp: int = 1, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    """Full parameter tree from ``torch.Generator(device).manual_seed(seed)``
    (draw order: embed, the layers in model order, the tail, lm_head), at
    the dims of a model axis of ``tp`` ranks (`model_dims`: q heads and the
    vocab padded, as the reference's ``init_params(key, cfg, tp)``; tp = 1
    pads nothing). For full-width models on the card use
    `launch.engine.init_serving_params`, which quantizes layer by layer
    from the same draws."""
    check_serving_support(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = model_dims(cfg, tp)
    pat = layer_pattern(cfg)
    G, R = pattern_counts(cfg)
    kw = dict(dtype=dtype, device=device)
    embed = init_embed(gen, cfg, dims, **kw)
    blocks = [init_block(gen, cfg, dims, pat[l % len(pat)], **kw) for l in range(G * len(pat))]
    tail = [init_block(gen, cfg, dims, pat[i], **kw) for i in range(R)]
    params = {
        "embed": embed,
        "layers": {f"sub{i}": tree_stack(blocks[i::len(pat)]) for i in range(len(pat))},
        "final_norm": make_norm(cfg.d_model, **kw),
        "lm_head": make_linear(gen, cfg.d_model, dims.V, **kw),
    }
    if R:
        params["tail"] = {f"sub{i}": t for i, t in enumerate(tail)}
    return params


def block_cache_shape(cfg, dims: Dims, kind: str, B: int, cap: int, *,
                      dtype=torch.bfloat16, device="cpu", lead=(), tp: int = 1):
    """Zero contiguous cache leaves of one block kind: ``{"k", "v"}`` [*lead,
    B, S, kv, hd] for GQA (S = cap, or the window for a ring ``attn`` block
    of a sliding-window model), ``{"kv"}`` [*lead, B, cap, 1, r_kv + dr]
    (the compressed stream) for MLA, and the recurrent states, independent
    of ``cap``: Mamba's ``{"conv"}`` [*lead, B, conv - 1, d_inner] in
    ``dtype`` and ``{"ssm"}`` [*lead, B, d_inner, n] f32, the RG-LRU's
    ``{"conv"}`` [*lead, B, 3, lru_width] and ``{"state"}`` [*lead, B,
    lru_width] f32. ``tp`` > 1: one rank's leaves, the sequence (a ring's
    slots) and the inner widths cut to 1 / tp (`launch.sharding.
    cache_shard_dim`)."""
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "mamba":
        di = cfg.d_inner // tp
        return {"conv": torch.zeros((*lead, B, cfg.ssm_conv - 1, di), **kw),
                "ssm": torch.zeros((*lead, B, di, cfg.ssm_state), **f32)}
    if kind == "rec":
        W = cfg.lru_width // tp
        return {"conv": torch.zeros((*lead, B, 3, W), **kw),
                "state": torch.zeros((*lead, B, W), **f32)}
    if kind == "mla":
        c = cfg.kv_lora_rank + cfg.qk_rope_dim
        return {"kv": torch.zeros((*lead, B, cap // tp, 1, c), **kw)}
    S_cap = cfg.sliding_window if (kind == "attn" and cfg.sliding_window) else cap
    shape = (*lead, B, S_cap // tp, dims.kv, dims.hd)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def make_cache(cfg, B: int = 0, cap: int = 0, *, cache_cfg=None, dtype=torch.bfloat16,
               device="cpu", tp: int = 1):
    """Zero caches for every layer, laid out as the params: page pools
    (bf16 or AMS planes, [G, P, page, kv, ...]) for a paged ``cache_cfg``,
    else the fixed [G, B, S, ...] slot layout per pattern position
    (``layers/sub{i}``) and [B, S, ...] per tail block (``tail/sub{i}``).
    At ``tp`` > 1 the pools of one rank: its kv / tp heads where tp divides
    them, else every head, as the reference's `pool_shardings`
    (`models.parallel.heads_split`); the contiguous caches of one rank: its
    shard of the sequence (capacity / tp rows, window / tp ring slots) and
    its d_inner / tp or lru_width / tp channels of the recurrent states,
    as the reference's ``cache_shardings(seq_shard=True)``."""
    check_support(cfg, cache_cfg)
    check_tp_support(cfg, cache_cfg, tp, 0 if cache_cfg is not None and cache_cfg.paged
                     else cap)
    dims = model_dims(cfg, tp)
    if cache_cfg is not None and cache_cfg.paged:
        from repro_torch.cache import make_gqa_page_pool
        kv = dims.kv // tp if heads_split(dims.kv, tp) else dims.kv
        return {"layers": {"sub0": make_gqa_page_pool(cache_cfg, kv, dims.hd,
                                                      device=device,
                                                      lead=(cfg.num_layers,))}}
    if B < 1 or cap < 1:
        raise ValueError(f"a contiguous cache needs slots and capacity >= 1, got {B}, {cap}")
    pat = layer_pattern(cfg)
    G, R = pattern_counts(cfg)
    kw = dict(dtype=dtype, device=device, tp=tp)
    cache = {"layers": {f"sub{i}": block_cache_shape(cfg, dims, kind, B, cap, lead=(G,), **kw)
                        for i, kind in enumerate(pat)}}
    if R:
        cache["tail"] = {f"sub{i}": block_cache_shape(cfg, dims, pat[i], B, cap, **kw)
                         for i in range(R)}
    return cache


def reset_cache_slot(cache, slot: int):
    """Zero batch row ``slot`` of every contiguous cache leaf in place (slot
    reuse in the engine; stacked leaves carry the batch at axis 1, tail
    leaves at axis 0)."""
    for leaf in tree_leaves(cache["layers"]):
        leaf[:, slot].zero_()
    for leaf in tree_leaves(cache.get("tail", {})):
        leaf[slot].zero_()
    return cache


def residual(x, out):
    """(x + out in x.dtype, its addends (x, out)): a block's output, and
    what a norm of it sums unrounded in f32 where XLA fuses the add into
    the norm (`_norm_in`): the block's second norm, and the next block's
    first inside a repeat of the pattern and along the tail (the repeats'
    carry between them is rounded)."""
    return x + out, (x, out)


def _norm_in(x, pre, g, eps):
    """A norm rounded to x.dtype: of the producer's addends ``pre``
    summed unrounded in f32 where given, else of x."""
    if pre is None:
        return rms_norm(x, g, eps)
    return rms_norm(pre[0].to(torch.float32) + pre[1].to(torch.float32), g, eps).to(x.dtype)


def residual_norm(x, out, g, eps):
    """(x + out, its norm read from the unrounded sum): the residual stream
    keeps the sum rounded to x.dtype."""
    y, pre = residual(x, out)
    return y, _norm_in(y, pre, g, eps)


def _ffn(p, h, cfg, policy, ctx=NO_CTX, phase="seq"):
    """The block's FFN of its normed input: the MoE FFN of a ``gqa_moe``
    block, the dense one otherwise (under ``ctx``: a rank's shards).
    Returns (output, auxiliary loss or None)."""
    if "moe" in p:
        return M.moe_apply(p["moe"], h, cfg, policy, ctx=ctx, phase=phase)
    return F.ffn_apply(p["ffn"], h, cfg.ffn_activation, policy, ctx), None


def _attn_impl(cache_cfg) -> str:
    """Contiguous-cache attention lowering (``ref`` | ``kernel``)."""
    return cache_cfg.impl if cache_cfg is not None else "ref"


def block_decode(p, x, cache, pos, kind, cfg, dims, *, policy, block_tables, cache_cfg,
                 pre=None, ctx=NO_CTX):
    """x [B, 1, D] through one block: MLA over its compressed stream, GQA
    over a page pool or a contiguous cache (a ring of the last
    ``sliding_window`` keys for an ``attn`` block of a sliding-window
    model), Mamba over its conv / ssm states, the RG-LRU over its conv /
    recurrent states (all written in place; the recurrent states only where
    ``pos >= 0``). ``pre``: the addends of x, where the first norm reads
    their sum unrounded (`residual`). Returns (x, cache, x's addends)."""
    h = _norm_in(x, pre, p["ln1"], cfg.norm_eps)
    if kind == "mamba":
        out, (conv, ssm) = S.mamba_decode(p["mixer"], h, cache["conv"], cache["ssm"], cfg,
                                          policy=policy, live=pos >= 0, ctx=ctx)
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        x, pre = residual(x, out)
        return x, cache, pre
    if kind == "rec":
        out, (conv, state) = S.rglru_decode(p["mixer"], h, cache["conv"], cache["state"], cfg,
                                            policy=policy, live=pos >= 0, ctx=ctx)
        cache["conv"].copy_(conv)
        cache["state"].copy_(state)
    elif kind == "mla":
        out, ckv = A.mla_attn_decode(p["attn"], h, cache["kv"], pos, cfg, dims, policy=policy,
                                     attn_impl=_attn_impl(cache_cfg), ctx=ctx)
        cache = {"kv": ckv}
    elif cache_cfg is not None and cache_cfg.paged:
        out, cache = A.gqa_attn_decode_paged(p["attn"], h, cache, pos, block_tables, cfg,
                                             dims, policy=policy, cache_cfg=cache_cfg, ctx=ctx)
    else:
        window = cfg.sliding_window if kind == "attn" else 0
        out, (ck, cv) = A.gqa_attn_decode(p["attn"], h, cache["k"], cache["v"], pos, cfg,
                                          dims, policy=policy, window=window,
                                          ring=bool(window), attn_impl=_attn_impl(cache_cfg),
                                          ctx=ctx)
        cache = {"k": ck, "v": cv}
    x, h2 = residual_norm(x, out, p["ln2"], cfg.norm_eps)
    x, pre = residual(x, _ffn(p, h2, cfg, policy, ctx, "decode")[0])
    return x, cache, pre


def block_decode_chunk(p, x, cache, pos, nvalid, kind, cfg, dims, *, policy, block_tables,
                       cache_cfg, ctx=NO_CTX):
    """Ragged analogue of `block_decode`: x [B, c, D] (attention layers
    only, `check_chunked_support`)."""
    if kind not in ATTENTION_KINDS + ("mla",):
        raise NotImplementedError(f"chunked decode does not support {kind!r} blocks")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        out, ckv = A.mla_attn_decode_chunk(p["attn"], h, cache["kv"], pos, nvalid, cfg, dims,
                                           policy=policy, attn_impl=_attn_impl(cache_cfg),
                                           ctx=ctx)
        cache = {"kv": ckv}
    elif cache_cfg is not None and cache_cfg.paged:
        out, cache = A.gqa_attn_decode_paged_chunk(p["attn"], h, cache, pos, nvalid,
                                                   block_tables, cfg, dims, policy=policy,
                                                   cache_cfg=cache_cfg, ctx=ctx)
    else:
        out, (ck, cv) = A.gqa_attn_decode_chunk(p["attn"], h, cache["k"], cache["v"], pos,
                                                nvalid, cfg, dims, policy=policy,
                                                attn_impl=_attn_impl(cache_cfg), ctx=ctx)
        cache = {"k": ck, "v": cv}
    x, h2 = residual_norm(x, out, p["ln2"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, policy, ctx, "decode")[0], cache


def _embed(params, tokens, dtype=torch.bfloat16, prefix_embeds=None, ctx=NO_CTX):
    """Token embeddings (after ``prefix_embeds``). Under a tp > 1 ``ctx``
    the table holds this rank's V / tp vocab rows: each rank looks up the
    tokens it holds, -0.0 elsewhere, and the ranks' lookups are added in
    rank order, which is exact (x + -0.0 is x, -0.0 included), by
    `ParallelCtx.sum_ranks_grad` (in training each rank's rows take the
    gradient of the sum)."""
    w = params["embed"]["w"].to(dtype)
    tp = ctx.tp
    if tp == 1:
        x = w[tokens.long()]
    else:
        local = tokens.long() - ctx.rank * w.shape[0]
        mine = (local >= 0) & (local < w.shape[0])
        x = w[torch.where(mine, local, 0)]
        x = torch.where(mine[..., None], x, torch.full_like(x, -0.0))
        x = ctx.sum_ranks_grad(x, "model")
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    return x


def _override(x, embeds, embed_mask):
    """The step's embedding override: where ``embed_mask`` is set, the
    prefix embedding (rounded to x.dtype) replaces the token's."""
    if embeds is None:
        return x
    mask = (embed_mask if embed_mask is not None
            else torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device))
    return torch.where(mask.reshape(x.shape[:-1])[..., None] != 0,
                       embeds.reshape(x.shape).to(x.dtype), x)


def _head(params, x, cfg, dims, policy=None, pre=None, ctx=NO_CTX):
    """Final norm (of the last block's addends ``pre`` summed unrounded,
    where given) and lm_head: f32 logits. Under a tp > 1 ``ctx`` lm_head's
    N-shards are gathered and cut to the true vocab: every rank samples
    from the same logits, of tp = 1's width. In the training layout
    (``ctx.col_row``) lm_head is column-parallel and the logits stay the
    rank's V / tp vocab columns, with its slice of the padded slots' bias:
    the loss reads them sharded (`launch.steps._loss_fn`)."""
    x = _norm_in(x, pre, params["final_norm"], cfg.norm_eps)
    tp = ctx.tp
    if tp == 1:
        logits = apply_linear(params["lm_head"], x, policy)
        return logits.to(torch.float32) + dims.vocab_mask_bias(x.device)[None, None, :]
    if ctx.col_row:
        v = dims.V // tp
        logits = apply_linear(params["lm_head"], ctx.copy_ranks(x), policy)
        bias = dims.vocab_mask_bias(x.device)[ctx.rank * v:(ctx.rank + 1) * v]
        return logits.to(torch.float32) + bias[None, None, :]
    logits = ctx.all_gather_last(apply_linear(params["lm_head"], x, policy, tp))
    return (logits.to(torch.float32)
            + dims.vocab_mask_bias(x.device)[None, None, :])[..., :dims.V_true]


def _blocks(params, cfg):
    """(kind, params, path) of every block in model order: each repeat g
    walks ``layers/sub0 .. sub{P-1}`` (views ``leaf[g]``), then the tail."""
    pat = layer_pattern(cfg)
    G = tree_leaves(params["layers"])[0].shape[0]
    for g in range(G):
        for i, kind in enumerate(pat):
            yield kind, tree_map(lambda t: t[g], params["layers"][f"sub{i}"]), ("layers", i, g)
    for i in range(len(params.get("tail", {}))):
        yield pat[i], params["tail"][f"sub{i}"], ("tail", i, None)


def _block_cache(cache, path):
    group, i, g = path
    c = cache[group][f"sub{i}"]
    return c if g is None else tree_map(lambda t: t[g], c)


def _layers(params, cache, fn, x, cfg):
    """Run ``fn(kind, layer_params, x, layer_cache, pre)`` -> (x, cache,
    pre) over every block. A block's first norm reads its producer's
    addends ``pre`` inside a repeat of the pattern and along the tail, not
    across the repeats' rounded carry (`residual`); returns (x, pre) with
    pre the tail's last addends (None without a tail), which the head's
    norm reads."""
    pre = None
    for kind, bp, path in _blocks(params, cfg):
        x, _, pre = fn(kind, bp, x, _block_cache(cache, path), pre if path[1] else None)
    return x, (pre if "tail" in params else None)


def block_seq(p, x, kind, cfg, dims, *, policy=None, block_kv=1024, prefix_len=0,
              want_cache=False, pre=None, ctx=NO_CTX):
    """x [B, S, D] through one block over the whole sequence. Returns (x,
    cache or None): GQA's ``{"k", "v"}`` [B, S, kv, hd] (a ring cache
    [B, window, kv, hd] for an ``attn`` block of a sliding-window model,
    `_to_ring`), MLA's ``{"kv"}`` [B, S, 1, r_kv + dr], the final recurrent
    states of Mamba (``{"conv", "ssm"}``) or the RG-LRU (``{"conv",
    "state"}``), x's addends (``pre`` as in `block_decode`) and the
    block's auxiliary loss (the MoE router's, over the tokens of
    ``ctx.dp_axes``' ranks; None for the other kinds)."""
    h = _norm_in(x, pre, p["ln1"], cfg.norm_eps)
    if kind == "mamba":
        out, (conv, ssm) = S.mamba_train(p["mixer"], h, cfg, policy=policy)
        x, pre = residual(x, out)
        return x, ({"conv": conv, "ssm": ssm} if want_cache else None), pre, None
    if kind == "rec":
        out, (conv, state) = S.rglru_train(p["mixer"], h, cfg, policy=policy)
        cache = {"conv": conv, "state": state} if want_cache else None
    elif kind == "mla":
        out, kv = A.mla_attn_train(p["attn"], h, cfg, dims, policy=policy, block_kv=block_kv,
                                   prefix_len=prefix_len)
        cache = {"kv": kv[:, :, None, :]} if want_cache else None
    else:
        window = cfg.sliding_window if kind == "attn" else 0
        out, (k, v) = A.gqa_attn_train(p["attn"], h, cfg, dims, policy=policy,
                                       block_kv=block_kv, prefix_len=prefix_len, window=window,
                                       ctx=ctx)
        if window:
            k, v = _to_ring(k, window), _to_ring(v, window)
        cache = {"k": k, "v": v} if want_cache else None
    x, h2 = residual_norm(x, out, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(p, h2, cfg, policy, ctx)
    x, pre = residual(x, y)
    return x, cache, pre, aux


def _to_ring(kv: torch.Tensor, window: int) -> torch.Tensor:
    """The last ``window`` entries of [B, S, kv, hd] laid out by position
    % window (zeros where the sequence is shorter than the window)."""
    B, Skv = kv.shape[0], kv.shape[1]
    W = min(window, Skv)
    ring = torch.zeros((B, window, *kv.shape[2:]), dtype=kv.dtype, device=kv.device)
    ring[:, torch.arange(Skv - W, Skv, device=kv.device) % window] = kv[:, Skv - W:]
    return ring


def _seq_blocks(blocks, x, aux, cfg, dims, kw):
    """x through ``blocks`` [(kind, params)] in order, each block's first norm
    reading its producer's addends (`residual`); returns (x, aux plus the
    blocks' auxiliary losses, the last addends, the blocks' caches)."""
    pre, caches = None, []
    for i, (kind, bp) in enumerate(blocks):
        x, c, pre, a = block_seq(bp, x, kind, cfg, dims, pre=pre if i else None, **kw)
        if a is not None:
            aux = aux + a
        caches.append(c)
    return x, aux, pre, caches


def forward_seq(params, tokens, cfg, *, policy=None, remat=True, block_kv=1024,
                prefix_embeds=None, want_cache=False, dtype=torch.bfloat16, ctx=NO_CTX):
    """Full-sequence forward: tokens [B, S] (after ``prefix_embeds`` [B, P,
    D], which attend to each other both ways). Returns (logits [B, P + S, V]
    f32, aux, cache or None): aux is the reference's auxiliary loss, the
    MoE blocks' load-balance losses summed in model order (0 without MoE
    blocks); ``want_cache`` returns the contiguous cache the sequence
    leaves, laid out as `make_cache` lays it out (``layers/sub{i}`` stacked
    [G, B, P + S, ...], ``tail/sub{i}`` [B, P + S, ...]), from which
    `decode_step` continues (copied into a cache of larger capacity; ring
    caches are [.., B, window, ...] and recurrent states [.., B, ...]
    already, and `decode_step` takes them as they are).

    ``remat`` (the reference's default): where autograd records the layers'
    params, each repeat of the pattern runs under `torch.utils.checkpoint`
    (non-reentrant; the forward draws no random numbers),
    so its activations are recomputed in the backward pass instead of kept,
    as the reference's ``jax.checkpoint`` of its scan body; the tail is not
    rematerialised.

    ``ctx``: a rank of data-parallel training, whose ``tokens`` are its
    rows of a batch sharded over ``ctx.dp_axes``; the only term that is
    not a sum over rows, the MoE load-balance loss, then takes its means
    over every rank's tokens (`moe.load_balance_loss`). With a model axis
    (tp > 1) the params are the rank's shards of the training layout
    (``ctx.train_layout``, `launch.sharding.train_dims`, at the dims of
    ``model_dims(cfg, tp)``): the embedding's vocab rows, each block's
    heads and FFN columns (``moe_tp`` for MoE blocks), and the logits come
    back as the rank's vocab columns (`_head`). Block kinds ``gqa`` and
    ``gqa_moe`` run there; the others, and the serving layout's shards,
    are not ported at tp > 1."""
    check_serving_support(cfg)
    if ctx.tp > 1:
        bad = sorted(set(layer_pattern(cfg)) - set(ATTENTION_KINDS))
        if not ctx.train_layout or bad:
            what = (f"block kinds {bad}" if ctx.train_layout
                    else "the serving layout's shards")
            raise NotImplementedError(
                f"forward_seq on model shards (tp={ctx.tp}) over {what} is not ported yet "
                "(ROADMAP.md, Modules to port)")
    dims = model_dims(cfg, ctx.tp)
    pat = layer_pattern(cfg)
    prefix_len = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    x = _embed(params, tokens, dtype, prefix_embeds, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = dict(policy=policy, block_kv=block_kv, prefix_len=prefix_len, want_cache=want_cache,
              ctx=ctx)
    recompute = (remat and torch.is_grad_enabled()
                 and any(t.requires_grad for t in tree_leaves(params["layers"])))
    layer_caches = []
    for g in range(tree_leaves(params["layers"])[0].shape[0]):
        blocks = [(kind, tree_map(lambda t: t[g], params["layers"][f"sub{i}"]))
                  for i, kind in enumerate(pat)]
        if recompute:
            x, aux, _, cs = checkpoint(_seq_blocks, blocks, x, aux, cfg, dims, kw,
                                       use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux, _, cs = _seq_blocks(blocks, x, aux, cfg, dims, kw)
        layer_caches.append(cs)
    tail = [(pat[i], params["tail"][f"sub{i}"]) for i in range(len(params.get("tail", {})))]
    x, aux, pre, tail_caches = _seq_blocks(tail, x, aux, cfg, dims, kw)
    cache = None
    if want_cache:
        cache = {"layers": {f"sub{i}": tree_stack([cs[i] for cs in layer_caches])
                            for i in range(len(pat))}}
        if tail:
            cache["tail"] = {f"sub{i}": c for i, c in enumerate(tail_caches)}
    return _head(params, x, cfg, dims, policy, pre if tail else None, ctx), aux, cache


def decode_step(params, token, cache, pos, cfg, *, policy=None, dtype=torch.bfloat16,
                block_tables=None, cache_cfg=None, nvalid=None, ndraft=None, n_logits=1,
                embeds=None, embed_mask=None, ctx=NO_CTX):
    """One decode step. token [B] with per-slot positions ``pos`` [B]
    (negative = idle slot, write suppressed), or the ragged multi-token
    step: token [B, C] with start positions ``pos`` [B] and valid counts
    ``nvalid`` [B]; logits are taken at each slot's last valid token. A
    paged ``cache_cfg`` reads page pools through ``block_tables`` [B, MP];
    otherwise the cache is the contiguous slot layout. Returns (logits
    [B, V] f32, cache) — the caches are updated in place.

    Speculative scoring (``n_logits`` = K+1 > 1, ragged step only): the
    chunk's last ``ndraft[b]`` tokens are drafts, and the logits come back
    [B, K+1, V] at positions ``nvalid-1-ndraft .. nvalid-1`` (clipped into
    the chunk): row j scores the token after draft j, row 0 is the plain
    step's last-valid row.

    ``embeds`` [B, D] + ``embed_mask`` [B] (``[B, C, D]`` / ``[B, C]`` in
    the ragged step) override the token embedding where the mask is set:
    the engine streams modality prefix embeddings through the step this
    way during prefill.

    ``ctx``: a `models.parallel.ParallelCtx`; at tp > 1 (`check_tp_support`)
    ``params`` and ``cache`` are this rank's shards (page pools: its kv
    heads; contiguous caches, ``ctx.seq_shard``: its shard of the sequence
    and of the recurrent states' inner width), the residual stream and the
    logits are replicated, and every rank returns the same logits: tp =
    1's bits wherever no attention merges across ranks (the merged softmax
    adds the ranks' partial sums, another association than one rank's)."""
    tp = ctx.tp
    check_tp_support(cfg, cache_cfg, tp)
    if token.dim() == 2:
        return _decode_step_chunk(params, token, cache, pos, nvalid, cfg, policy=policy,
                                  dtype=dtype, block_tables=block_tables,
                                  cache_cfg=cache_cfg, ndraft=ndraft, n_logits=n_logits,
                                  embeds=embeds, embed_mask=embed_mask, ctx=ctx)
    if n_logits != 1:
        raise ValueError("n_logits > 1 requires the ragged [B, C] step")
    dims = model_dims(cfg, tp)
    pos = pos.to(torch.int32)
    x = _override(_embed(params, token[:, None], dtype, ctx=ctx), embeds, embed_mask)

    def fn(kind, bp, x, c, pre):
        return block_decode(bp, x, c, pos, kind, cfg, dims, policy=policy,
                            block_tables=block_tables, cache_cfg=cache_cfg, pre=pre, ctx=ctx)

    x, pre = _layers(params, cache, fn, x, cfg)
    return _head(params, x, cfg, dims, policy, pre, ctx)[:, 0], cache


def _decode_step_chunk(params, token, cache, pos, nvalid, cfg, *, policy=None,
                       dtype=torch.bfloat16, block_tables=None, cache_cfg=None, ndraft=None,
                       n_logits=1, embeds=None, embed_mask=None, ctx=NO_CTX):
    dims = model_dims(cfg, ctx.tp)
    pos = pos.to(torch.int32)
    nvalid = nvalid.to(torch.int32)
    x = _override(_embed(params, token, dtype, ctx=ctx), embeds, embed_mask)  # [B, C, D]

    def fn(kind, bp, x, c, pre):   # attention layers, one per repeat: no addends
        return (*block_decode_chunk(bp, x, c, pos, nvalid, kind, cfg, dims, policy=policy,
                                    block_tables=block_tables, cache_cfg=cache_cfg,
                                    ctx=ctx), None)

    x, _ = _layers(params, cache, fn, x, cfg)
    # logits only at each slot's last valid token, or its last ndraft + 1
    C = token.shape[1]
    if n_logits > 1:
        nd = torch.zeros_like(nvalid) if ndraft is None else ndraft.to(torch.int32)
        j = torch.arange(n_logits, dtype=torch.int32, device=x.device)[None, :]
        sel = torch.clamp(nvalid[:, None] - 1 - nd[:, None] + j, 0, C - 1).long()
        x_sel = torch.gather(x, 1, sel[:, :, None].expand(-1, -1, x.shape[2]))  # [B, K+1, D]
        return _head(params, x_sel, cfg, dims, policy, ctx=ctx), cache
    last = torch.clamp(nvalid - 1, 0, C - 1).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]    # [B, 1, D]
    return _head(params, x_last, cfg, dims, policy, ctx=ctx)[:, 0], cache
