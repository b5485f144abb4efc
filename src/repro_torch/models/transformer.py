"""Decoder assembly for dense GQA models (paged or contiguous caches),
absorbed-MLA models (contiguous caches) and Mamba-1 models (contiguous
conv / ssm state caches) (port of the gqa / mla / mamba paths of
src/repro/models/transformer.py): the one-token and ragged decode steps
(Mamba: the one-token step only), and the full-sequence forward
`forward_seq` (prefill with a contiguous cache, and the self drafter's
forward).

Parameters keep the reference's tree: ``embed``, ``layers`` (every leaf
stacked ``[G, ...]`` over layers), ``final_norm``, ``lm_head``. The
reference's ``lax.scan`` over stacked layers is a Python loop over views
``leaf[g]``; the caches (page pools, or contiguous [B, S, ...] slot caches)
are stacked the same way and are written in place (a Mamba block's states
only for slots with ``pos >= 0``: an idle slot's states stay as they
were). Modality prefix embeddings (VLM patches) enter `forward_seq` ahead
of the tokens, and the decode step through its ``embeds`` /
``embed_mask`` override.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map

from . import attention as A
from . import ffn as F
from . import ssm as S
from .common import Dims, apply_linear, make_linear, make_norm, model_dims, rms_norm


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


def check_serving_support(cfg):
    """The port serves dense GQA and absorbed-MLA layers (any FFN
    activation, with or without modality prefix embeds) and Mamba-1
    layers, without sliding windows."""
    pat = layer_pattern(cfg)
    if pat not in (("gqa",), ("mla",), ("mamba",)):
        raise NotImplementedError(
            f"the port serves dense GQA, MLA and Mamba layers only; {cfg.name} has "
            f"{sorted(set(pat))} (MoE blocks, and RG-LRU with its hybrid pattern: "
            "ROADMAP.md, Modules to port)")
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window ring caches are not ported yet "
                                  "(ROADMAP.md, Modules to port)")


def check_support(cfg, cache_cfg=None):
    """The one rule of which layers a cache kind holds: contiguous caches
    (``cache_cfg`` None or contiguous) every layer the port serves, paged
    caches dense GQA layers only (MLA's compressed stream and Mamba's
    recurrent states keep their contiguous layouts, as in the reference)."""
    check_serving_support(cfg)
    if cache_cfg is not None and cache_cfg.paged and layer_pattern(cfg) != ("gqa",):
        raise NotImplementedError(
            f"paged caches serve dense GQA layers only; {cfg.name} has "
            f"{sorted(set(layer_pattern(cfg)))} (MLA streams and recurrent states keep "
            "their contiguous layouts): serve it over a contiguous cache")


def check_chunked_support(cfg):
    """The ragged multi-token step (``prefill_chunk`` > 1, and speculation,
    whose step is ragged) covers the attention layers only, as in the
    reference: a Mamba recurrence integrates its state token by token and
    keeps the one-token step."""
    pat = layer_pattern(cfg)
    bad = [k for k in pat if k not in ("gqa", "mla")]
    if bad:
        raise NotImplementedError(
            f"chunked prefill supports gqa/mla layers only; {cfg.name} has "
            f"{sorted(set(bad))}: serve it with prefill_chunk=1 and no speculation")


def init_block(gen, cfg, dims: Dims, kind: str, *, dtype=torch.float32, device="cpu"):
    if kind not in ("gqa", "mla", "mamba"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    kw = dict(dtype=dtype, device=device)
    if kind == "mamba":
        return {"ln1": make_norm(cfg.d_model, **kw), "mixer": S.init_mamba(gen, cfg, **kw)}
    init_attn = A.init_gqa if kind == "gqa" else A.init_mla
    return {"ln1": make_norm(cfg.d_model, **kw),
            "attn": init_attn(gen, cfg, dims, **kw),
            "ln2": make_norm(cfg.d_model, **kw),
            "ffn": F.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_activation, **kw)}


def init_embed(gen, cfg, dims: Dims, *, dtype=torch.float32, device="cpu"):
    w = torch.randn((dims.V, cfg.d_model), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return {"w": w.to(dtype)}


def init_params(seed: int, cfg, *, dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Full parameter tree from ``torch.Generator(device).manual_seed(seed)``
    (draw order: embed, layer 0..L-1, lm_head). For full-width models on the
    card use `launch.engine.init_serving_params`, which quantizes layer by
    layer from the same draws."""
    check_serving_support(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = model_dims(cfg)
    kind = layer_pattern(cfg)[0]
    embed = init_embed(gen, cfg, dims, dtype=dtype, device=device)
    blocks = [init_block(gen, cfg, dims, kind, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)]
    return {
        "embed": embed,
        "layers": {"sub0": stack_trees(blocks)},
        "final_norm": make_norm(cfg.d_model, dtype=dtype, device=device),
        "lm_head": make_linear(gen, cfg.d_model, dims.V, dtype=dtype, device=device),
    }


def stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def block_cache_shape(cfg, dims: Dims, kind: str, B: int, cap: int, *,
                      dtype=torch.bfloat16, device="cpu", lead=()):
    """Zero contiguous cache leaves of one block kind: ``{"k", "v"}`` [*lead,
    B, cap, kv, hd] for GQA, ``{"kv"}`` [*lead, B, cap, 1, r_kv + dr] (the
    compressed stream) for MLA, ``{"conv"}`` [*lead, B, conv - 1, d_inner]
    in ``dtype`` and ``{"ssm"}`` [*lead, B, d_inner, n] f32 (the recurrent
    states, independent of ``cap``) for Mamba."""
    kw = dict(dtype=dtype, device=device)
    if kind == "mamba":
        return {"conv": torch.zeros((*lead, B, cfg.ssm_conv - 1, cfg.d_inner), **kw),
                "ssm": torch.zeros((*lead, B, cfg.d_inner, cfg.ssm_state),
                                   dtype=torch.float32, device=device)}
    if kind == "mla":
        c = cfg.kv_lora_rank + cfg.qk_rope_dim
        return {"kv": torch.zeros((*lead, B, cap, 1, c), **kw)}
    shape = (*lead, B, cap, dims.kv, dims.hd)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def make_cache(cfg, B: int = 0, cap: int = 0, *, cache_cfg=None, dtype=torch.bfloat16,
               device="cpu"):
    """Zero caches for every layer, stacked over layers: page pools (bf16 or
    AMS planes, [G, P, page, kv, ...]) for a paged ``cache_cfg``, else the
    fixed [G, B, cap, ...] slot layout."""
    check_support(cfg, cache_cfg)
    dims = model_dims(cfg)
    if cache_cfg is not None and cache_cfg.paged:
        from repro_torch.cache import make_gqa_page_pool
        return {"layers": {"sub0": make_gqa_page_pool(cache_cfg, dims.kv, dims.hd,
                                                      device=device,
                                                      lead=(cfg.num_layers,))}}
    if B < 1 or cap < 1:
        raise ValueError(f"a contiguous cache needs slots and capacity >= 1, got {B}, {cap}")
    return {"layers": {"sub0": block_cache_shape(cfg, dims, layer_pattern(cfg)[0], B, cap,
                                                 dtype=dtype, device=device,
                                                 lead=(cfg.num_layers,))}}


def reset_cache_slot(cache, slot: int):
    """Zero batch row ``slot`` of every contiguous cache leaf in place (slot
    reuse in the engine; stacked leaves carry the batch at axis 1)."""
    for leaf in tree_leaves(cache["layers"]):
        leaf[:, slot].zero_()
    return cache


def residual_norm(x, out, g, eps):
    """(x + out, rms_norm(x + out)): the norm reads the sum of the two bf16
    operands unrounded in f32, as in the reference's compiled step (XLA
    fuses the add into the norm's f32 convert); the residual stream keeps
    the sum rounded to x.dtype."""
    xf = x.to(torch.float32) + out.to(torch.float32)
    return x + out, rms_norm(xf, g, eps).to(x.dtype)


def _attn_impl(cache_cfg) -> str:
    """Contiguous-cache attention lowering (``ref`` | ``kernel``)."""
    return cache_cfg.impl if cache_cfg is not None else "ref"


def block_decode(p, x, cache, pos, kind, cfg, dims, *, policy, block_tables, cache_cfg):
    """x [B, 1, D] through one block: MLA over its compressed stream, GQA
    over a page pool or a contiguous cache, Mamba over its conv / ssm
    states (all written in place; Mamba's only where ``pos >= 0``). Returns
    (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mamba":
        out, (conv, ssm) = S.mamba_decode(p["mixer"], h, cache["conv"], cache["ssm"], cfg,
                                          policy=policy, live=pos >= 0)
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        return x + out, cache
    if kind == "mla":
        out, ckv = A.mla_attn_decode(p["attn"], h, cache["kv"], pos, cfg, dims, policy=policy,
                                     attn_impl=_attn_impl(cache_cfg))
        cache = {"kv": ckv}
    elif cache_cfg is not None and cache_cfg.paged:
        out, cache = A.gqa_attn_decode_paged(p["attn"], h, cache, pos, block_tables, cfg,
                                             dims, policy=policy, cache_cfg=cache_cfg)
    else:
        out, (ck, cv) = A.gqa_attn_decode(p["attn"], h, cache["k"], cache["v"], pos, cfg,
                                          dims, policy=policy,
                                          attn_impl=_attn_impl(cache_cfg))
        cache = {"k": ck, "v": cv}
    x, h2 = residual_norm(x, out, p["ln2"], cfg.norm_eps)
    return x + F.ffn_apply(p["ffn"], h2, cfg.ffn_activation, policy), cache


def block_decode_chunk(p, x, cache, pos, nvalid, kind, cfg, dims, *, policy, block_tables,
                       cache_cfg):
    """Ragged analogue of `block_decode`: x [B, c, D] (attention layers
    only, `check_chunked_support`)."""
    if kind not in ("gqa", "mla"):
        raise NotImplementedError(f"chunked decode does not support {kind!r} blocks")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        out, ckv = A.mla_attn_decode_chunk(p["attn"], h, cache["kv"], pos, nvalid, cfg, dims,
                                           policy=policy, attn_impl=_attn_impl(cache_cfg))
        cache = {"kv": ckv}
    elif cache_cfg is not None and cache_cfg.paged:
        out, cache = A.gqa_attn_decode_paged_chunk(p["attn"], h, cache, pos, nvalid,
                                                   block_tables, cfg, dims, policy=policy,
                                                   cache_cfg=cache_cfg)
    else:
        out, (ck, cv) = A.gqa_attn_decode_chunk(p["attn"], h, cache["k"], cache["v"], pos,
                                                nvalid, cfg, dims, policy=policy,
                                                attn_impl=_attn_impl(cache_cfg))
        cache = {"k": ck, "v": cv}
    x, h2 = residual_norm(x, out, p["ln2"], cfg.norm_eps)
    return x + F.ffn_apply(p["ffn"], h2, cfg.ffn_activation, policy), cache


def _embed(params, tokens, dtype=torch.bfloat16, prefix_embeds=None):
    x = params["embed"]["w"].to(dtype)[tokens.long()]
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


def _head(params, x, cfg, dims, policy=None):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = apply_linear(params["lm_head"], x, policy)
    return logits.to(torch.float32) + dims.vocab_mask_bias(x.device)[None, None, :]


def _layers(params, cache, fn, x):
    """Run ``fn(layer_params, x, layer_cache)`` over the stacked layers."""
    G = tree_leaves(params["layers"])[0].shape[0]
    for g in range(G):
        gp = tree_map(lambda t: t[g], params["layers"]["sub0"])
        gc = tree_map(lambda t: t[g], cache["layers"]["sub0"])
        x, _ = fn(gp, x, gc)
    return x


def block_seq(p, x, kind, cfg, dims, *, policy=None, block_kv=1024, prefix_len=0,
              want_cache=False):
    """x [B, S, D] through one block over the whole sequence. Returns (x,
    cache or None): GQA's ``{"k", "v"}`` [B, S, kv, hd], MLA's ``{"kv"}``
    [B, S, 1, r_kv + dr], Mamba's final ``{"conv", "ssm"}`` states."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mamba":
        out, (conv, ssm) = S.mamba_train(p["mixer"], h, cfg, policy=policy)
        return x + out, ({"conv": conv, "ssm": ssm} if want_cache else None)
    if kind == "mla":
        out, kv = A.mla_attn_train(p["attn"], h, cfg, dims, policy=policy, block_kv=block_kv,
                                   prefix_len=prefix_len)
        cache = {"kv": kv[:, :, None, :]} if want_cache else None
    else:
        out, (k, v) = A.gqa_attn_train(p["attn"], h, cfg, dims, policy=policy,
                                       block_kv=block_kv, prefix_len=prefix_len)
        cache = {"k": k, "v": v} if want_cache else None
    x, h2 = residual_norm(x, out, p["ln2"], cfg.norm_eps)
    return x + F.ffn_apply(p["ffn"], h2, cfg.ffn_activation, policy), cache


def forward_seq(params, tokens, cfg, *, policy=None, block_kv=1024, prefix_embeds=None,
                want_cache=False, dtype=torch.bfloat16):
    """Full-sequence forward: tokens [B, S] (after ``prefix_embeds`` [B, P,
    D], which attend to each other both ways). Returns (logits [B, P + S, V]
    f32, aux, cache or None): aux is the reference's auxiliary loss (0 for
    dense layers); ``want_cache`` returns the contiguous cache the sequence
    leaves, leaves stacked [G, B, P + S, ...] as `make_cache` lays them out,
    from which `decode_step` continues (copied into a cache of larger
    capacity; a Mamba model's are its final conv / ssm states [G, B, ...],
    which `decode_step` takes as they are)."""
    check_serving_support(cfg)
    dims = model_dims(cfg)
    kind = layer_pattern(cfg)[0]
    prefix_len = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    x = _embed(params, tokens, dtype, prefix_embeds)
    caches = []
    G = tree_leaves(params["layers"])[0].shape[0]
    for g in range(G):
        gp = tree_map(lambda t: t[g], params["layers"]["sub0"])
        x, c = block_seq(gp, x, kind, cfg, dims, policy=policy, block_kv=block_kv,
                         prefix_len=prefix_len, want_cache=want_cache)
        caches.append(c)
    cache = {"layers": {"sub0": stack_trees(caches)}} if want_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg, dims, policy), aux, cache


def decode_step(params, token, cache, pos, cfg, *, policy=None, dtype=torch.bfloat16,
                block_tables=None, cache_cfg=None, nvalid=None, ndraft=None, n_logits=1,
                embeds=None, embed_mask=None):
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
    way during prefill."""
    if token.dim() == 2:
        return _decode_step_chunk(params, token, cache, pos, nvalid, cfg, policy=policy,
                                  dtype=dtype, block_tables=block_tables,
                                  cache_cfg=cache_cfg, ndraft=ndraft, n_logits=n_logits,
                                  embeds=embeds, embed_mask=embed_mask)
    if n_logits != 1:
        raise ValueError("n_logits > 1 requires the ragged [B, C] step")
    dims = model_dims(cfg)
    kind = layer_pattern(cfg)[0]
    pos = pos.to(torch.int32)
    x = _override(_embed(params, token[:, None], dtype), embeds, embed_mask)

    def fn(gp, x, c):
        return block_decode(gp, x, c, pos, kind, cfg, dims, policy=policy,
                            block_tables=block_tables, cache_cfg=cache_cfg)

    x = _layers(params, cache, fn, x)
    return _head(params, x, cfg, dims, policy)[:, 0], cache


def _decode_step_chunk(params, token, cache, pos, nvalid, cfg, *, policy=None,
                       dtype=torch.bfloat16, block_tables=None, cache_cfg=None, ndraft=None,
                       n_logits=1, embeds=None, embed_mask=None):
    dims = model_dims(cfg)
    kind = layer_pattern(cfg)[0]
    pos = pos.to(torch.int32)
    nvalid = nvalid.to(torch.int32)
    x = _override(_embed(params, token, dtype), embeds, embed_mask)  # [B, C, D]

    def fn(gp, x, c):
        return block_decode_chunk(gp, x, c, pos, nvalid, kind, cfg, dims, policy=policy,
                                  block_tables=block_tables, cache_cfg=cache_cfg)

    x = _layers(params, cache, fn, x)
    # logits only at each slot's last valid token, or its last ndraft + 1
    C = token.shape[1]
    if n_logits > 1:
        nd = torch.zeros_like(nvalid) if ndraft is None else ndraft.to(torch.int32)
        j = torch.arange(n_logits, dtype=torch.int32, device=x.device)[None, :]
        sel = torch.clamp(nvalid[:, None] - 1 - nd[:, None] + j, 0, C - 1).long()
        x_sel = torch.gather(x, 1, sel[:, :, None].expand(-1, -1, x.shape[2]))  # [B, K+1, D]
        return _head(params, x_sel, cfg, dims, policy), cache
    last = torch.clamp(nvalid - 1, 0, C - 1).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]    # [B, 1, D]
    return _head(params, x_last, cfg, dims, policy)[:, 0], cache
