"""The continuous-batching engine step (port of
src/repro/launch/steps.py: build_engine_step and engine_step_signature).

The reference jits one slot-masked program per engine and donates the
cache to it. The port's step is a plain function with the same arguments:

    step(params, token [B] | [B, C], pos [B], cache, sampling, *,
         nvalid [B] = None, block_tables [B, MP] = None)
        -> (next_token [B], done [B], cache)

``pos`` holds each slot's start position (negative = idle slot, its cache
write suppressed); with ``chunk`` = C > 1 every slot feeds a ragged block of
up to C tokens and ``nvalid`` its valid count; ``block_tables`` is taken by
paged caches only. The epilogue is the greedy draw with in-step termination
(`sampling.sample_tokens`). The caches are written in place and returned.
Nothing in the step waits on the device or copies from host memory.

The engine feeds it from `StepInputs`, one set of static buffers staged in
one host buffer (pinned on the card) and sent with one copy per tick. On
CUDA tensors `GraphedStep` replays the step as CUDA graphs, one per chunk
width, the counterpart of the reference's compiled program: the caches and
inputs are the graphs' static memory, written in place. On CPU tensors the
engine calls the same step eagerly at the same widths.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.build import add_counts, recorded_counts
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


class StepInputs:
    """The step's static inputs: token [B, C], pos [B], nvalid [B],
    block_tables [B, MP] (paged caches only) and the sampling row ngen [B],
    all int32 views of one device buffer (``dev``), staged through numpy
    views of one host buffer (``host``, pinned on CUDA). `send` copies the
    host buffer over in one non-blocking copy: the host writes the next
    tick's inputs only after the tick's outputs were read, so the copy has
    landed by then."""

    def __init__(self, slots: int, chunk: int, max_pages: int, device: torch.device):
        shapes = {"token": (slots, chunk), "pos": (slots,), "nvalid": (slots,)}
        if max_pages:
            shapes["block_tables"] = (slots, max_pages)
        shapes["ngen"] = (slots,)
        n = sum(math.prod(sh) for sh in shapes.values())
        pinned = device.type == "cuda"
        self.host_buf = torch.zeros(n, dtype=torch.int32, pin_memory=pinned)
        self.dev_buf = torch.zeros(n, dtype=torch.int32, device=device)
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        off = 0
        for name, sh in shapes.items():
            size = math.prod(sh)
            self.host[name] = self.host_buf[off:off + size].numpy().reshape(sh)
            self.dev[name] = self.dev_buf[off:off + size].view(sh)
            off += size
        self.chunked = chunk > 1

    def send(self) -> None:
        self.dev_buf.copy_(self.host_buf, non_blocking=True)

    def set_idle(self) -> None:
        """Every slot idle: nothing is written, every cache byte stays."""
        self.host["token"][:] = 0
        self.host["pos"][:] = -1
        self.host["nvalid"][:] = 0

    def step_args(self, width: int):
        """(token, pos, nvalid, block_tables) device views for a tick of
        ``width`` tokens per slot: token [B] and no nvalid on a one-token
        engine, token [B, width] on a chunked one."""
        d = self.dev
        token = d["token"][:, :width] if self.chunked else d["token"][:, 0]
        return (token, d["pos"], d["nvalid"] if self.chunked else None,
                d.get("block_tables"))


def run_step(step, params, cache, inputs: StepInputs, sampling, width: int) -> torch.Tensor:
    """The eager step on the static inputs: [2, B] int32 (next token, done)."""
    token, pos, nvalid, bt = inputs.step_args(width)
    next_token, done, _ = step(params, token, pos, cache, sampling, nvalid=nvalid,
                               block_tables=bt)
    return torch.stack([next_token, done.to(torch.int32)])


class GraphedStep:
    """The engine step as CUDA graphs, one per chunk width, captured at the
    width's first use: one warm-up run with every slot idle on the capture
    stream (it builds the kernels and libraries, sets the kernels'
    shared-memory limits, fills the constant tables and leaves every cache
    byte as it was), then the capture. All graphs of one engine share one
    memory pool; their replays never overlap. A failed capture raises.

    A replay runs no kernel wrapper, so the launch counts the capture moved
    (`kernels.build.recorded_counts`) are added once per replay."""

    def __init__(self, step, params, cache, inputs: StepInputs, sampling):
        self._run = lambda width: run_step(step, params, cache, inputs, sampling, width)
        self.inputs = inputs
        self.device = inputs.dev_buf.device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: Dict[int, tuple] = {}             # width -> (graph, out, moved)
        self.capture_seconds: Dict[int, float] = {}
        self.pool_bytes = 0

    def capture(self, width: int) -> None:
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
        self.graphs[width] = (graph, out, moved)
        self.capture_seconds[width] = time.perf_counter() - t0

    def __call__(self, width: int) -> torch.Tensor:
        """Send the staged inputs and replay the graph of ``width`` (captured
        first if new) on the current stream: the static [2, B] output."""
        if width not in self.graphs:
            self.capture(width)
        graph, out, moved = self.graphs[width]
        self.inputs.send()
        graph.replay()
        add_counts(moved)
        return out


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
