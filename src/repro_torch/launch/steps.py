"""The continuous-batching engine step (port of
src/repro/launch/steps.py: build_engine_step and engine_step_signature).

The reference jits one slot-masked program per engine; PyTorch runs
eagerly, so the step is a plain function with the same arguments:

    step(params, token [B] | [B, C], pos [B], cache, sampling, *,
         nvalid [B] = None, block_tables [B, MP] = None)
        -> (next_token [B], done [B], cache)

``pos`` holds each slot's start position (negative = idle slot, its cache
write suppressed); with ``chunk`` = C > 1 every slot feeds a ragged block of
up to C tokens and ``nvalid`` its valid count; ``block_tables`` is taken by
paged caches only. The epilogue is the greedy draw with in-step termination
(`sampling.sample_tokens`). The caches are written in place and returned.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import decode_step

from .sampling import sample_tokens


def build_engine_step(cfg: ModelConfig, rcfg: RunConfig, cache_cfg):
    """Returns the step function for this (model, run, cache); one function
    serves one-token and chunked ticks (`decode_step` reads the token's
    shape). Which layers the cache holds was checked where the cache was
    made (`models.make_cache`)."""
    policy = rcfg.quant if rcfg.quantized else None

    def step(params, token, pos, cache, sampling, *, nvalid=None, block_tables=None):
        logits, cache = decode_step(params, token, cache, pos, cfg, policy=policy,
                                    block_tables=block_tables, cache_cfg=cache_cfg,
                                    nvalid=nvalid)
        next_token, done = sample_tokens(logits, sampling)
        return next_token, done, cache

    return step


def engine_step_signature(cfg: ModelConfig, rcfg: RunConfig, cache_cfg=None,
                          chunk: int = 1) -> dict:
    """Identity of one engine step: cache mode x attention impl x chunk x
    weight scheme x slot count (tensor parallelism is not ported: tp = 1)."""
    return dict(
        arch=cfg.name,
        scheme=rcfg.quant.scheme if rcfg.quantized else "fp16",
        cache=cache_cfg.kind if cache_cfg is not None else "contiguous",
        kv_scheme=(cache_cfg.kv_scheme
                   if cache_cfg is not None and cache_cfg.quantized else "bf16"),
        impl=cache_cfg.impl if cache_cfg is not None else "ref",
        slots=rcfg.global_batch,
        chunk=chunk,
        speculate_k=0,
        tp=1,
    )
