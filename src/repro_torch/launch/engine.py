"""Continuous-batching serving engine over the AMS-quantized model (port of
src/repro/launch/engine.py, greedy path).

Weights are AMS-quantized and packed ahead of time (``scheme="fp16"`` keeps
them bf16: the FP16 baseline); one slot-masked engine step
(`steps.build_engine_step`) then serves every in-flight request per tick,
with prefill chunked into the decode batch as a ragged multi-token step
under a per-tick token budget. A slot freed by a finished request is
re-admitted the same tick. The KV cache is either

  * contiguous (the default, ``cache=None``): a fixed [slots, capacity]
    bf16 cache per layer (GQA K and V, or MLA's compressed stream);
    admission is by free slot, and a slot is zeroed when a request is placed
    in it;
  * paged (dense GQA): a pool of pages in the packed AMS-e2m2 layout
    (``paged_ams``) or in bf16 (``paged_bf16``), addressed through
    per-request block tables; admission is gated on the free-page budget
    (`cache.PageAllocator`), and completed prompt pages are prefix-cached
    across requests (a request whose prompt shares a cached page-aligned
    prefix references the same physical pages and starts prefill at the
    cached length).

With ``impl="kernel"`` (`QuantPolicy.impl`) every quantized projection runs
through kernel K1 (fp5.33) or K1b (the other schemes), and with
``CacheConfig(impl="kernel")`` attention runs kernel K4 (contiguous GQA
cache), K5 (MLA stream), K2 (AMS pages) or K3 (bf16 pages).

Not ported yet, and refused with NotImplementedError: seeded sampling
(temperature > 0), speculative decoding, priorities and preemption, the
host spill tier, meshes, prefix embeds, obs cost accounting, and the async
front end (`step_begin`/`step_end`).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache import (
    PageAllocator,
    compression_vs_bf16,
    pool_bytes_per_token,
    prefix_page_hashes,
)
from repro_torch.configs.base import RunConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import make_cache, model_dims, quantize_params, reset_cache_slot
from repro_torch.models.common import make_linear, make_norm
from repro_torch.models.transformer import (
    check_serving_support,
    check_support,
    init_block,
    init_embed,
    layer_pattern,
    tree_map,
)
from repro_torch.obs import NULL_REGISTRY, MetricsRegistry, TraceRecorder
from repro_torch.obs.metrics import COUNT_BUCKETS, TIME_BUCKETS

from .config import EngineConfig
from .sampling import (
    GREEDY,
    SAMPLING_TODO,
    SamplingParams,
    clear_slot,
    fill_slot,
    slot_batch,
)
from .scheduler import DECODE, FINISHED, PREFILL, FIFOScheduler, Request
from .steps import GraphedStep, StepInputs, build_engine_step, engine_step_signature, run_step


def resolve_device(device: str) -> torch.device:
    """The engine's device; ``cuda`` without a usable card raises (the port
    never carries on on the CPU unless asked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


def _to_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def prepare_params(params, quant: Optional[QuantPolicy]):
    """The reference engine's weight preparation (engine.py:336-343): every
    floating leaf of ndim >= 2 to bf16 (stacked per-layer norms and biases
    included, as in the reference's stacked tree), 1-D leaves kept, then PTQ
    with the policy. Linears that arrive packed (``{'hi', 'lsb', 'scale'}``)
    are kept as they are."""
    def visit(node):
        if isinstance(node, dict):
            if "hi" in node:
                return node
            return {k: visit(v) for k, v in node.items()}
        return _to_bf16(node) if node.dim() >= 2 else node

    params = visit(params)
    if quant is not None:
        params = quantize_params(params, quant)
    return params


def init_serving_params(cfg, quant: Optional[QuantPolicy], seed: int, device):
    """Serving params from ``torch.Generator(device).manual_seed(seed)``,
    initialised and quantized one layer at a time so a full-width model never
    exists in f32 (Qwen2-7B would need about 30 GB). Same draws, same result
    as ``prepare_params(init_params(seed, cfg), quant)``."""
    check_serving_support(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = model_dims(cfg)
    kind = layer_pattern(cfg)[0]
    embed = {"w": init_embed(gen, cfg, dims, device=device)["w"].to(torch.bfloat16)}
    L = cfg.num_layers
    layers = None
    for g in range(L):
        blk = tree_map(_to_bf16, init_block(gen, cfg, dims, kind, device=device))
        if quant is not None:
            blk = quantize_params(blk, quant, prefix="/layers/sub0")
        if layers is None:
            layers = tree_map(lambda t: torch.empty((L, *t.shape), dtype=t.dtype,
                                                    device=device), blk)

        def put(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    put(dst[k], src[k])
            else:
                dst[g].copy_(src)

        put(layers, blk)
        del blk
    lm_head = make_linear(gen, cfg.d_model, dims.V, device=device)
    lm_head = {k: _to_bf16(v) if v.dim() >= 2 else v for k, v in lm_head.items()}
    params = {"embed": embed, "layers": {"sub0": layers},
              "final_norm": make_norm(cfg.d_model, device=device),
              "lm_head": lm_head}
    if quant is not None:   # only lm_head/embed can still be eligible
        params["lm_head"] = quantize_params({"lm_head": lm_head}, quant)["lm_head"]
    return params


class RequestHandle:
    """Client-facing view of a submitted request: ``.status``, ``.result()``;
    other attribute reads forward to the underlying `Request`."""

    __slots__ = ("_req", "_eng")

    def __init__(self, req: Request, engine: "ServeEngine"):
        object.__setattr__(self, "_req", req)
        object.__setattr__(self, "_eng", engine)

    @property
    def status(self) -> str:
        return self._req.status

    @property
    def done(self) -> bool:
        return self._req.done

    def result(self, max_ticks: int = 1_000_000) -> List[int]:
        """Drive the engine until this request finishes; return its tokens."""
        eng, req = self._eng, self._req
        for _ in range(max_ticks):
            if req.done or not eng.has_work:
                break
            eng.step()
        return list(req.tokens)

    def __getattr__(self, name):
        return getattr(self._req, name)

    def __repr__(self):
        r = self._req
        return f"RequestHandle(rid={r.rid}, status={r.status!r}, tokens={len(r.tokens)})"


class ServeEngine:
    """Slot-based continuous-batching engine (see module docstring)."""

    def __init__(self, config: EngineConfig, *, params=None):
        if not isinstance(config, EngineConfig):
            raise TypeError("ServeEngine takes an EngineConfig (the reference's legacy "
                            "keyword constructor is not ported)")
        ec = self.config = config
        self.device = resolve_device(ec.device)
        cfg = ec.model_config()
        ccfg = self.cache_cfg = ec.sized_cache()
        check_support(cfg, ccfg)            # before the weights are made
        self.cfg = cfg
        self.scheme = ec.scheme
        self.slots = slots = ec.slots
        self.capacity = ec.capacity
        self.chunk = ec.prefill_chunk
        self.step_chunk = ec.step_chunk
        self.token_budget = ec.resolved_token_budget
        self.obs = ec.obs
        self.metrics = MetricsRegistry() if self.obs.enabled else NULL_REGISTRY
        self.trace = TraceRecorder(enabled=self.obs.trace_on)
        self.trace.thread(0, "engine")
        quant = None
        if ec.scheme != "fp16":
            quant = QuantPolicy(scheme=ec.scheme, strategy=ec.strategy, impl=ec.impl,
                                min_elements=1 << 10)
        self.rcfg = RunConfig(model=cfg, seq_len=ec.capacity, global_batch=slots,
                              mode="decode", quant=quant)

        t0 = time.perf_counter()
        if params is None:
            params = init_serving_params(cfg, quant, ec.seed, self.device)
        else:
            params = prepare_params(tree_map(lambda t: t.to(self.device), params), quant)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.quantize_seconds = time.perf_counter() - t0
        if ec.verbose:
            print(f"[ptq] {ec.scheme} ({ec.strategy}) in {self.quantize_seconds:.1f}s",
                  flush=True)
        self.params = params
        self.cache = make_cache(cfg, slots, ec.capacity, cache_cfg=ccfg, device=self.device)
        self._step = build_engine_step(cfg, self.rcfg, ccfg)

        if ccfg.paged:
            self.alloc: Optional[PageAllocator] = PageAllocator(
                ccfg.num_pages, ccfg.page_size, metrics=self.metrics)
            self.block_tables = np.zeros((slots, ccfg.max_pages_per_seq), np.int32)
            # a request can never outgrow its block-table row or the pool
            eff_cap = min(ccfg.max_pages_per_seq, ccfg.num_pages) * ccfg.page_size
        else:
            self.alloc = None
            self.block_tables = None
            eff_cap = ec.capacity
        self.sched = FIFOScheduler(eff_cap, max_queue=ec.max_queue, metrics=self.metrics)
        self.active: List[Optional[Request]] = [None] * slots
        self.fed = np.zeros(slots, np.int32)
        self.last_token = np.zeros(slots, np.int32)
        self.inputs = StepInputs(slots, self.step_chunk,
                                 ccfg.max_pages_per_seq if ccfg.paged else 0, self.device)
        self.samp = slot_batch(slots, self.device, rows={"ngen": self.inputs.dev["ngen"]})
        # on the card every tick replays a CUDA graph of the step
        self.graphs: Optional[GraphedStep] = None
        if self.device.type == "cuda":
            self.graphs = GraphedStep(self._step, self.params, self.cache, self.inputs,
                                      self.samp)
            self._out_host = torch.empty((2, slots), dtype=torch.int32, pin_memory=True)
        self.tick = 0
        self.finished: List[Request] = []
        self._rid = itertools.count()

        m = self.metrics
        self.signature = engine_step_signature(cfg, self.rcfg, cache_cfg=ccfg,
                                               chunk=self.step_chunk)
        m.gauge("serve_step_signature_info", "engine-step signature (value is always 1)",
                tuple(self.signature)).labels(**self.signature).set(1)
        self._m_tick_s = m.histogram("serve_tick_seconds",
                                     "wall seconds per served (non-idle) tick",
                                     buckets=TIME_BUCKETS)
        self._m_tick_tok = m.histogram("serve_tick_tokens", "tokens emitted per served tick",
                                       buckets=COUNT_BUCKETS)
        self._m_idle = m.counter("serve_idle_ticks_total", "ticks with no active slot")
        self._m_steps = m.counter("serve_device_steps_total", "engine-step invocations")
        self._m_fed = m.counter("serve_tokens_fed_total", "input positions fed through the step")
        self._m_chunk = m.histogram("serve_chunk_tokens", "tokens fed per active slot per tick",
                                    buckets=COUNT_BUCKETS, keep_raw=False)
        self._m_finished = m.counter("serve_requests_finished_total",
                                     "finished requests, by reason", ("reason",))
        self._m_fin_stop = self._m_finished.labels(reason="stop")
        self._m_fin_len = self._m_finished.labels(reason="length")
        self._m_prompt = m.counter("serve_prompt_tokens_total", "prompt positions admitted")
        self._m_cached = m.counter("serve_cached_prompt_tokens_total",
                                   "prompt positions served from shared pages")
        self._m_emit = m.counter("serve_emit_rounds_total", "slot-rounds that emitted tokens")
        self._m_ttft = m.histogram("serve_request_ttft_ticks", "submit -> first token, ticks",
                                   buckets=COUNT_BUCKETS)
        self._m_lat = m.histogram("serve_request_latency_ticks", "submit -> finish, ticks",
                                  buckets=COUNT_BUCKETS)
        self._m_glen = m.histogram("serve_request_gen_tokens",
                                   "tokens generated per finished request",
                                   buckets=COUNT_BUCKETS)
        self._m_active = m.gauge("serve_active_slots", "slots serving a request")
        m.gauge("serve_queue_depth", "requests waiting for a slot",
                fn=lambda: self.sched.queue_depth)

    # ------------------------------------------------------------- frontend
    def submit(self, prompt, max_tokens: Optional[int] = None, prefix_embeds=None,
               sampling: Optional[SamplingParams] = None, priority: int = 0) -> RequestHandle:
        """Enqueue a request and return its `RequestHandle`. ``max_tokens`` is
        the length cap (``sampling.max_tokens`` wins when both are given)."""
        sp = sampling if sampling is not None else GREEDY
        if prefix_embeds is not None:
            raise NotImplementedError("prefix embeds are not ported yet "
                                      "(ROADMAP.md, Modules to port)")
        if priority != 0:
            raise NotImplementedError("priorities and preemption are not ported yet "
                                      "(preemption with host spill: ROADMAP.md, Modules to port)")
        if not sp.greedy:
            raise NotImplementedError(SAMPLING_TODO)
        if sp.max_tokens is not None:
            max_tokens = sp.max_tokens
        if max_tokens is None:
            raise ValueError("max_tokens required (argument or SamplingParams.max_tokens)")
        rid = next(self._rid)
        req = Request(rid=rid, prompt=prompt, max_tokens=max_tokens, sampling=sp)
        ccfg = self.cache_cfg
        if ccfg.paged and ccfg.prefix_cache:
            req.page_hashes = prefix_page_hashes(req.prompt, ccfg.page_size, ccfg.content_key)
        self.sched.submit(req, self.tick)
        if self.trace.enabled:
            self.trace.thread(rid + 1, f"req {rid}")
            self.trace.begin(rid + 1, "request",
                             args={"prompt_len": req.prompt_len, "max_tokens": max_tokens})
            self.trace.begin(rid + 1, "queued")
        return RequestHandle(req, self)

    @property
    def has_work(self) -> bool:
        return any(r is not None for r in self.active) or len(self.sched) > 0

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.active)

    # ------------------------------------------------------------ admission
    def _admit(self) -> int:
        """Admit queued requests into free slots, under the per-tick token
        budget. Paged: gated on the cache-aware free-page budget (only
        uncached pages charge it), and the slot gets the request's
        block-table row. Contiguous: the slot's cache rows are zeroed.
        Returns the count placed."""
        paged = self.cache_cfg.paged
        ps = self.cache_cfg.page_size

        def fits(r):
            need = self.alloc.pages_needed(r.kv_need)
            # always re-feed the last prompt token (its logits give the first
            # generated token), so the matchable prefix stops one short
            hashes = r.page_hashes[: (r.prompt_len - 1) // ps]
            if not self.alloc.can_alloc(need, hashes):
                return False
            r.pages, shared = self.alloc.alloc(r.rid, need, hashes)
            r.cached_len = shared * ps
            r.published = shared
            return True

        free = [s for s, r in enumerate(self.active) if r is None]
        room = self.token_budget - self.active_count
        placed = self.sched.admit(free, self.tick, fits=fits if paged else None,
                                  max_admit=max(0, room))
        for slot, req in placed:
            if paged:
                self.block_tables[slot] = self.alloc.block_table_row(
                    req.rid, self.block_tables.shape[1])
                self._m_cached.inc(req.cached_len)
            else:
                reset_cache_slot(self.cache, slot)
            self._m_prompt.inc(req.prompt_len)
            if self.trace.enabled:
                self.trace.end(req.rid + 1, "queued",
                               args={"slot": slot, "cached_len": req.cached_len})
                self.trace.begin(req.rid + 1, "prefill")
            self.active[slot] = req
            self.fed[slot] = req.cached_len       # prefill skip
            fill_slot(self.samp, slot, req.sampling, req.max_tokens)
            req.status = PREFILL
        return len(placed)

    # ----------------------------------------------------------------- tick
    def device_step(self, width: int, *, eager: bool = False) -> np.ndarray:
        """Run the step on the staged inputs at ``width`` tokens per slot and
        return (next token, done) [2, B] int32 on the host. CUDA tensors
        replay the width's graph unless ``eager`` asks for the step function
        itself (comparisons); CPU tensors always run the step function.
        One copy to pinned memory and one synchronisation read the result."""
        if self.graphs is not None and not eager:
            out = self.graphs(width)
        else:
            self.inputs.send()
            out = run_step(self._step, self.params, self.cache, self.inputs, self.samp, width)
        if not out.is_cuda:
            return out.numpy()
        self._out_host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out_host.numpy()

    def step(self, *, eager: bool = False) -> Dict[str, object]:
        """One engine tick: admit, run the ragged step, advance slots by their
        consumed chunk lengths, finish and re-admit. ``eager`` runs the step
        function instead of its CUDA graph (`device_step`).

        Returns {"finished": [Request], "generated": int, "active": int}."""
        t0 = time.perf_counter()
        PC = self.chunk
        tracing = self.trace.enabled
        if tracing:
            self.trace.begin(0, "tick", args={"tick": self.tick})
            self.trace.begin(0, "admit")
        self._admit()
        if tracing:
            self.trace.end(0, "admit")
        if self.active_count == 0:
            self.tick += 1
            self._m_idle.inc()
            if tracing:
                self.trace.end(0, "tick", args={"idle": True})
            return {"finished": [], "generated": 0, "active": 0}
        self._m_active.set(self.active_count)

        # chunk sizing under the token budget: every active slot gets 1 token,
        # prefilling slots grow toward the prefill chunk from the leftover
        nvalid = np.zeros(self.slots, np.int32)
        leftover = self.token_budget - self.active_count
        for s, req in enumerate(self.active):
            if req is None:
                continue
            n = 1
            rem = req.prompt_len - int(self.fed[s])
            if PC > 1 and rem > 1:
                extra = min(min(PC, rem) - 1, leftover)
                n += max(0, extra)
                leftover -= n - 1
            nvalid[s] = n

        # as the reference's compiled step, a tick that prefills runs the
        # full [B, step_chunk] block (rows past a slot's nvalid are
        # discarded); pure-decode ticks run [B, 1]: one graph per width
        C = self.step_chunk if nvalid.max() > 1 else 1
        h = self.inputs.host
        h["token"][:] = 0
        h["pos"][:] = -1                                  # idle: write-suppressed
        h["nvalid"][:] = nvalid
        for s, req in enumerate(self.active):
            if req is None:
                continue
            i = int(self.fed[s])
            assert i >= req.cached_len, (
                f"slot {s}: insert at {i} would write a shared page "
                f"(cached prefix {req.cached_len})")
            if req.first_step_tick < 0:
                req.first_step_tick = self.tick
            h["pos"][s] = i
            for j in range(int(nvalid[s])):
                idx = i + j
                h["token"][s, j] = (req.prompt[idx] if idx < req.prompt_len
                                    else self.last_token[s])
        if self.block_tables is not None:
            h["block_tables"][:] = self.block_tables
        h["ngen"][:] = self.samp["ngen"]

        fed = int(nvalid.sum())
        self._m_steps.inc()
        self._m_fed.inc(fed)
        for s in range(self.slots):
            if self.active[s] is not None:
                self._m_chunk.observe(int(nvalid[s]))
        if tracing:
            self.trace.begin(0, "device_step", args={"tokens_fed": fed,
                                                     "active": self.active_count})
        next_tok, done = self.device_step(C, eager=eager)
        if tracing:
            self.trace.end(0, "device_step")

        finished, generated = [], 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            i, n = int(self.fed[s]), int(nvalid[s])
            self.fed[s] = i + n
            if req.page_hashes:
                # publish full prompt pages as prefill crosses their ends
                filled = min(int(self.fed[s]), req.prompt_len)
                while (req.published + 1) * self.cache_cfg.page_size <= filled:
                    j = req.published
                    self.alloc.publish(req.rid, req.page_hashes[j], req.pages[j])
                    req.published = j + 1
            if i + n - 1 < req.prompt_len - 1:
                continue                                  # still prefilling
            tok = int(next_tok[s])
            was_first = not req.tokens
            req.tokens.append(tok)
            self.last_token[s] = tok
            self.samp["ngen"][s] = len(req.tokens)
            generated += 1
            self._m_emit.inc()
            if was_first:
                req.first_token_tick = self.tick
                req.status = DECODE
                if tracing:
                    self.trace.end(req.rid + 1, "prefill")
                    self.trace.begin(req.rid + 1, "decode")
            if bool(done[s]):
                req.finish_tick = self.tick
                req.status = FINISHED
                req.finish_reason = "stop" if tok in req.sampling.stop_token_ids else "length"
                self.finished.append(req)
                finished.append(req)
                self.active[s] = None
                clear_slot(self.samp, s)
                if self.alloc is not None:
                    self.alloc.free(req.rid)
                    self.block_tables[s] = 0
                (self._m_fin_stop if req.finish_reason == "stop" else self._m_fin_len).inc()
                self._m_ttft.observe(req.ttft_ticks)
                self._m_lat.observe(req.latency_ticks)
                self._m_glen.observe(req.n_generated)
                if tracing:
                    self.trace.end(req.rid + 1, "decode")
                    self.trace.instant(req.rid + 1, "finished",
                                       args={"reason": req.finish_reason,
                                             "tokens": req.n_generated})
                    self.trace.end(req.rid + 1, "request")
        # freed capacity becomes admission headroom the same tick
        if finished:
            if tracing:
                self.trace.begin(0, "admit")
            self._admit()
            if tracing:
                self.trace.end(0, "admit")
        self.tick += 1
        self._m_tick_s.observe(time.perf_counter() - t0)
        self._m_tick_tok.observe(generated)
        if tracing:
            self.trace.counter("engine", {"active": self.active_count,
                                          "queue": self.sched.queue_depth})
            self.trace.end(0, "tick", args={"generated": generated})
        return {"finished": finished, "generated": generated, "active": self.active_count}

    def run(self, max_ticks: int = 1_000_000) -> Dict[str, Any]:
        """Drive up to ``max_ticks`` ticks, stopping once queue and slots
        drain. Returns `stats()`."""
        for _ in range(max_ticks):
            if not self.has_work:
                break
            self.step()
        return self.stats()

    # ----------------------------------------------------------- accounting
    def kv_bytes_per_token(self) -> int:
        """Cache bytes one token occupies across all layers, by the
        reference's formula (bf16 K and V of kv x hd per layer, or the
        packed AMS planes; an MLA model is counted by its kv heads x head_dim
        as well, as the reference counts it)."""
        dims = model_dims(self.cfg)
        return self.cfg.num_layers * pool_bytes_per_token(dims.kv, dims.hd, self.cache_cfg)

    def kv_compression_vs_bf16(self) -> float:
        dims = model_dims(self.cfg)
        return compression_vs_bf16(dims.kv, dims.hd, self.cache_cfg)

    def stats(self) -> Dict[str, Any]:
        """Aggregate serving stats, computed from the metrics registry (the
        reference's keys, less speculation, preemption and cost)."""
        raw_s = self._m_tick_s.raw_values()
        raw_t = self._m_tick_tok.raw_values()
        tick_s = np.asarray(raw_s) if raw_s else np.zeros(1)
        tok = np.asarray(raw_t) if raw_t else np.zeros(1)
        total_s = float(tick_s.sum())
        decode_ticks = tick_s[tok > 0]
        ttft = np.asarray(self._m_ttft.raw_values(), np.float64)
        e2e = np.asarray(self._m_lat.raw_values(), np.float64)
        glen = np.asarray(self._m_glen.raw_values(), np.float64)

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else 0.0

        out = {
            "ticks": len(raw_s),
            "requests_finished": int(self._m_finished.total),
            "tokens_generated": int(tok.sum()),
            "tokens_per_s": float(tok.sum() / total_s) if total_s else 0.0,
            "decode_ms_median": (1e3 * float(np.median(decode_ticks))
                                 if decode_ticks.size else 0.0),
            "decode_ms_p99": (1e3 * float(np.percentile(decode_ticks, 99))
                              if decode_ticks.size else 0.0),
            "ttft_ticks_mean": float(ttft.mean()) if ttft.size else 0.0,
            "ttft_ticks_p50": pct(ttft, 50),
            "ttft_ticks_p99": pct(ttft, 99),
            "latency_ticks_mean": float(e2e.mean()) if e2e.size else 0.0,
            "latency_ticks_p50": pct(e2e, 50),
            "latency_ticks_p99": pct(e2e, 99),
            "gen_tokens_mean": float(glen.mean()) if glen.size else 0.0,
            "stopped_early": int(self._m_fin_stop.value),
            "queue_depth": self.sched.queue_depth,
            "kv_bytes_per_token": self.kv_bytes_per_token(),
            "kv_compression_vs_bf16": self.kv_compression_vs_bf16(),
        }
        if self.alloc is not None:
            out["free_pages"] = self.alloc.free_pages
            out.update(self.alloc.stats())
            prompt_toks = self._m_prompt.value
            out["cached_token_frac"] = (self._m_cached.value / prompt_toks
                                        if prompt_toks else 0.0)
        return out
