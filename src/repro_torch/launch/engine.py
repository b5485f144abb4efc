"""Continuous-batching serving engine over the AMS-quantized model (port of
src/repro/launch/engine.py).

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
  * paged (GQA, dense or MoE): a pool of pages in the packed AMS-e2m2 layout
    (``paged_ams``) or in bf16 (``paged_bf16``), addressed through
    per-request block tables; admission is gated on the free-page budget
    (`cache.PageAllocator`), and completed prompt pages are prefix-cached
    across requests (a request whose prompt shares a cached page-aligned
    prefix references the same physical pages and starts prefill at the
    cached length).

Each request carries a `SamplingParams` (greedy argmax, or seeded
temperature / top-k / top-p draws through the port's threefry keys, which
fold only the request id and the token index, never the slot or tick) and
a ``priority``. On paged caches with ``EngineConfig.preempt`` a blocked
queue head of strictly higher priority preempts the lowest-priority active
request (the latest admitted first): its private pages' packed content
spills to host memory (`cache.extract_pages`), its shared prefix pages stay
pinned, and on re-admission the content is restored into fresh pages in
place (`cache.restore_pages`) and the stream resumes at the exact spilled
position, bit-equal to an uninterrupted one. Below eviction sits the
optional host spill tier (`CacheConfig.host_spill_pages`): evicted
published pages move to host memory and come back on a later prefix hit.
With ``speculate_k`` = k, pure-decode rounds feed up to k drafts per slot
(the n-gram drafter, or the self drafters, which run the engine's own
first layer or whole stack through `models.forward_seq` on the host side
of `step_begin`, outside every CUDA graph) and the step verifies them and
rolls the rejected ones back (`launch.speculative`); greedy streams are
those of plain decoding
wherever a row's bits do not depend on the tick's width: on the CPU, and
on the card on the paged AMS paths (K1's and K2's splits follow the row,
`models.common.row_sum` the norm's and the sampling softmax's sums).

With ``impl="kernel"`` (`QuantPolicy.impl`) every quantized projection runs
through kernel K1 (fp5.33) or K1b (the other schemes), and with
``CacheConfig(impl="kernel")`` attention runs kernel K4 (contiguous GQA
cache), K5 (MLA stream), K2 (AMS pages) or K3 (bf16 pages).

A tick is ``step_end(step_begin())``: `step_begin` admits, stages and
launches the step (on the card it replays the graph and starts the copy of
the output block to pinned memory, then returns without synchronising),
`step_end` waits for that copy and does the host bookkeeping. The async
HTTP/SSE front end (`launch.frontend`) parks its driver between the two
halves; `RequestHandle.result` and `.stream` then wait on the engine's tick
signal. Every CUDA call stays on the thread that steps the engine:
`submit` is host-only, and `capture_graphs` captures every graph before a
front end serves. With ``ObsConfig(cost=True)`` (the default) the engine
accumulates the roofline floors of `obs.cost` per tick and per request, on
the host, outside the graph.

A request may carry modality prefix embeddings (``submit(prefix_embeds=
[n, d_model])``, configs with ``num_prefix_embeds > 0``): they are fed
ahead of the prompt through the step's embeds override (a static f32
buffer inside every CUDA graph), attended both ways, and such a request
skips the prefix cache (its prefix is request-local floats).

A Mamba model (falcon-mamba-7b) is served over its contiguous conv / ssm
state caches on the one-token step, as in the reference: its recurrence
advances one token per slot per tick, so a ragged step (``prefill_chunk``
> 1, or speculation) and paged caches are refused before any weight is
made. So is the RG-LRU hybrid (recurrentgemma-9b), over its conv /
recurrent states and, for its ``attn`` blocks, rings of the last
``sliding_window`` keys. Admission zeroes the slot's states and ring rows,
outside the step; the step writes a slot's states only while it is live
(``pos >= 0``), so the idle warm-up of a graph capture leaves live
requests' states as they were.

Tensor-parallel serving (``EngineConfig(mesh=make_serving_mesh(tp))`` on
every rank, one process per rank, `launch.mesh`): the weights are the
rank's N-shards of every linear (vocab rows of the embedding, E / tp
experts; `launch.sharding`), the page pools hold the rank's kv heads, MoE
decodes expert-parallel (`models.moe.moe_ep`), and the residual stream and
the logits are replicated. Every rank runs the same host scheduler on the
same submissions in the same order, so the ranks stay in lockstep and emit
the streams of the tp = 1 engine. The step runs eagerly (no CUDA graphs:
`capture_graphs` raises, ``stats()["graphs"]`` is False); the KV and cost
accounting is per device, as in the reference. Contiguous caches (GQA,
rings, the MLA stream) are sequence-sharded: a rank holds capacity / tp
rows of every slot (window / tp ring slots), the owner of a position
inserts it, and the ranks merge their partial softmaxes; Mamba and RG-LRU
layers keep the rank's d_inner / tp channels of their states. Each rank
zeroes its own shard at admission; contiguous caches never preempt.
Meshes with data axes are refused (`EngineConfig`), with
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.cache import (
    PageAllocator,
    compression_vs_bf16,
    extract_pages,
    host_bytes,
    pool_bytes_per_token,
    prefix_page_hashes,
    restore_pages,
)
from repro_torch.configs.base import RunConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.tree import tree_map
from repro_torch.models import make_cache, model_dims, quantize_params, reset_cache_slot
from repro_torch.models.common import make_linear, make_norm
from repro_torch.models.parallel import NO_CTX, ParallelCtx, heads_split
from repro_torch.models.transformer import (
    check_chunked_support,
    check_serving_support,
    check_support,
    init_block,
    init_embed,
    layer_pattern,
    pattern_counts,
)
from repro_torch.obs import NULL_REGISTRY, MetricsRegistry, TraceRecorder, build_cost_model
from repro_torch.obs.metrics import COUNT_BUCKETS, TIME_BUCKETS

from .config import EngineConfig
from .mesh import dp_axes, tp_axis
from .sharding import serve_shard_dim, shard_params, shard_tree
from .sampling import (
    GREEDY,
    SamplingParams,
    any_sampled,
    clear_slot,
    fill_slot,
    request_key,
    slot_batch,
)
from .scheduler import (
    DECODE,
    FINISHED,
    PREEMPTED,
    PREFILL,
    FIFOScheduler,
    Request,
    SpilledState,
)
from .speculative import Drafter, make_drafter
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


def _cast(node, min_dim: int):
    """Every floating leaf of ndim >= ``min_dim`` to bf16; linears that are
    packed already (``{'hi', 'lsb', 'scale'}``) stay as they are."""
    if isinstance(node, dict):
        return node if "hi" in node else {k: _cast(v, min_dim) for k, v in node.items()}
    return _to_bf16(node) if node.dim() >= min_dim else node


def prepare_params(params, quant: Optional[QuantPolicy]):
    """The reference engine's weight preparation (engine.py:336-343): every
    floating leaf of ndim >= 2 to bf16 (stacked per-layer norms and biases
    included, as in the reference's stacked tree), 1-D leaves kept, then PTQ
    with the policy. Linears that arrive packed (``{'hi', 'lsb', 'scale'}``)
    are kept as they are."""
    params = _cast(params, min_dim=2)
    if quant is not None:
        params = quantize_params(params, quant)
    return params


def init_serving_params(cfg, quant: Optional[QuantPolicy], seed: int, device,
                        ctx: ParallelCtx = NO_CTX):
    """Serving params from ``torch.Generator(device).manual_seed(seed)``,
    initialised and quantized one layer at a time so a full-width model never
    exists in f32 (Qwen2-7B would need about 30 GB). Same draws, same result
    as ``prepare_params(init_params(seed, cfg), quant)``: embed, the layers
    in model order (each into its ``layers/sub{i}`` stack, every floating
    leaf bf16 as the stacked tree casts it), the tail (``tail/sub{i}``,
    leaves of ndim >= 2 bf16), lm_head; each block quantized under its own
    path. A MoE block's experts are quantized one at a time as they are
    drawn (`moe.init_moe`'s ``expert_fn``), so no more than one expert's
    FFN exists in f32 (a full-width Llama-4-Scout block is 8.8 GB in
    f32).

    Under a ``ctx`` of tp > 1 every rank makes the same draws (``dims``
    padded for tp, `models.model_dims`), slices each bf16 block to its
    shard (`launch.sharding.shard_tree`) and quantizes only that, each
    linear judged eligible at its whole size; of a MoE block it quantizes
    and keeps only its own experts. These are the shards of the tp = 1
    tree where tp pads nothing (quantizing a weight and slicing its planes
    equals quantizing the slice: AMS groups run along K, the scale is per
    column)."""
    check_serving_support(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = model_dims(cfg, ctx.tp)
    pat = layer_pattern(cfg)
    G, R = pattern_counts(cfg)
    # a rank's N-shard of a linear holds 1 / tp of its elements; a linear the
    # rank holds whole (`serve_shard_dim` None) is judged at its own size
    shard_quant = quant if quant is None or ctx.tp == 1 else dataclasses.replace(
        quant, min_elements=-(-quant.min_elements // ctx.tp))

    def policy_of(path: str, w):
        names = [n for n in path.split("/") if n] + ["w"]
        return quant if serve_shard_dim(names, w) is None else shard_quant

    def prep(tree, prefix: str, min_dim: int):
        tree = _cast(tree, min_dim)
        moe = tree.get("moe")
        keys = list(moe or ())
        experts = moe.pop("experts") if moe is not None else None    # the rank's, prepared
        tree = shard_tree(tree, ctx.rank, ctx.tp, [n for n in prefix.split("/") if n],
                          n_stack=0)
        if quant is not None:
            tree = quantize_params(tree, quant, prefix=prefix, policy_of=policy_of)
        if experts is not None:         # back in its place: the tree keeps init_moe's order
            tree["moe"] = {k: experts if k == "experts" else tree["moe"][k] for k in keys}
        return tree

    def local_experts(prefix: str, min_dim: int):
        """`init_moe`'s expert_fn: the rank's E / tp experts prepared, the
        others left out."""
        e_loc = cfg.num_experts // ctx.tp
        drawn = itertools.count()
        return lambda ep: (_prep_expert(ep, quant, prefix, min_dim)
                           if next(drawn) // e_loc == ctx.rank else None)

    embed = shard_tree({"w": init_embed(gen, cfg, dims, device=device)["w"].to(torch.bfloat16)},
                       ctx.rank, ctx.tp, ["embed"])
    layers: Dict[str, Any] = {}
    for l in range(G * len(pat)):
        g, i = divmod(l, len(pat))
        experts = local_experts(f"/layers/sub{i}/moe/experts", 0)
        blk = prep(init_block(gen, cfg, dims, pat[i], device=device, expert_fn=experts),
                   f"/layers/sub{i}", 0)
        if g == 0:
            layers[f"sub{i}"] = tree_map(lambda t: torch.empty((G, *t.shape), dtype=t.dtype,
                                                               device=device), blk)

        def put(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    put(dst[k], src[k])
            else:
                dst[g].copy_(src)

        put(layers[f"sub{i}"], blk)
        del blk
    tail = {}
    for i in range(R):
        experts = local_experts(f"/tail/sub{i}/moe/experts", 2)
        tail[f"sub{i}"] = prep(init_block(gen, cfg, dims, pat[i], device=device,
                                          expert_fn=experts), f"/tail/sub{i}", 2)
    lm_head = make_linear(gen, cfg.d_model, dims.V, device=device)
    lm_head = {k: _to_bf16(v) if v.dim() >= 2 else v for k, v in lm_head.items()}
    # only lm_head / embed can still be eligible
    lm_head = prep({"lm_head": lm_head}, "", 2)["lm_head"]
    params = {"embed": embed, "layers": layers,
              "final_norm": make_norm(cfg.d_model, device=device),
              "lm_head": lm_head}
    if R:
        params["tail"] = tail
    return params


def _prep_expert(tree, quant: Optional[QuantPolicy], prefix: str, min_dim: int):
    """One expert as the serving tree holds it: cast, quantized under its
    path."""
    tree = _cast(tree, min_dim)
    return quantize_params(tree, quant, prefix=prefix) if quant is not None else tree


class RequestHandle:
    """Client-facing view of a submitted request: ``.status``,
    ``.tokens_so_far()``, ``.result()``, async ``.stream()``; other
    attribute reads forward to the underlying `Request`."""

    __slots__ = ("_req", "_eng")

    def __init__(self, req: Request, engine: "ServeEngine"):
        object.__setattr__(self, "_req", req)
        object.__setattr__(self, "_eng", engine)

    @property
    def request(self) -> Request:
        """The underlying scheduler record."""
        return self._req

    @property
    def status(self) -> str:
        return self._req.status

    @property
    def done(self) -> bool:
        return self._req.done

    def tokens_so_far(self) -> List[int]:
        """Snapshot of the tokens generated so far (a copy)."""
        return list(self._req.tokens)

    def result(self, max_ticks: int = 1_000_000) -> List[int]:
        """Block until this request finishes and return its tokens: drive
        the engine when no driver runs, else (``engine.driver_active``, the
        front end) wait on the engine's tick signal."""
        eng, req = self._eng, self._req
        for _ in range(max_ticks):
            if req.done:
                break
            if eng.driver_active:
                eng.wait_tick(eng.tick)
            elif eng.has_work:
                eng.step()
            else:
                break
        return list(req.tokens)

    async def stream(self):
        """Async token stream (the SSE feed): yields each generated token
        id as it lands and ends with the request. Steps the engine from a
        worker thread when no driver runs, else waits on the tick signal,
        so any number of streams ride one driver."""
        import asyncio
        eng, req = self._eng, self._req
        sent = 0
        while True:
            while sent < len(req.tokens):
                tok = int(req.tokens[sent])
                sent += 1
                yield tok
            if req.done:
                return
            if eng.driver_active:
                await asyncio.to_thread(eng.wait_tick, eng.tick)
            else:
                await asyncio.to_thread(eng.step)

    def __getattr__(self, name):
        return getattr(self._req, name)

    def __repr__(self):
        r = self._req
        return f"RequestHandle(rid={r.rid}, status={r.status!r}, tokens={len(r.tokens)})"


@dataclasses.dataclass
class _PendingStep:
    """The step in flight between `step_begin` and `step_end`."""

    nvalid: Optional[np.ndarray]
    ndraft: Optional[np.ndarray]
    t0: float
    fed: int
    tracing: bool
    out: Any = None          # the output block (CPU tensors) or its copy's event
    idle: bool = False
    result: Optional[Dict[str, object]] = None   # idle ticks resolve early


class ServeEngine:
    """Slot-based continuous-batching engine (see module docstring)."""

    def __init__(self, config: EngineConfig, *, params=None):
        if not isinstance(config, EngineConfig):
            raise TypeError("ServeEngine takes an EngineConfig (the reference's legacy "
                            "keyword constructor is not ported)")
        ec = self.config = config
        cfg = ec.model_config()
        ccfg = self.cache_cfg = ec.sized_cache()
        # the rank's model axis (NO_CTX on one device); a rank runs on its
        # mesh's device; a contiguous cache is sequence-sharded over it
        self.ctx = ctx = (ParallelCtx(mesh=ec.mesh, dp_axes=dp_axes(ec.mesh),
                                      tp_axis=tp_axis(ec.mesh), seq_shard=not ccfg.paged)
                          if ec.tp > 1 else NO_CTX)
        self.tp = tp = ctx.tp
        self.device = ec.mesh.device if tp > 1 else resolve_device(ec.device)
        check_support(cfg, ccfg)            # before the weights are made
        if ec.step_chunk > 1:
            check_chunked_support(cfg)      # a ragged step: attention layers only
        self.cfg = cfg
        self.scheme = ec.scheme
        self.slots = slots = ec.slots
        self.capacity = ec.capacity
        self.chunk = ec.prefill_chunk
        self.speculate_k = k = ec.speculate_k
        # the step's chunk width holds 1 fed token + k drafts per slot
        self.step_chunk = ec.step_chunk
        self.token_budget = ec.resolved_token_budget
        # preemption needs pages to spill: contiguous caches never preempt
        self.preempt_enabled = bool(ec.preempt and ccfg.paged)
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
            params = init_serving_params(cfg, quant, ec.seed, self.device, ctx)
        else:
            params = shard_params(
                prepare_params(tree_map(lambda t: t.to(self.device), params), quant), ctx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.quantize_seconds = time.perf_counter() - t0
        if ec.verbose:
            print(f"[ptq] {ec.scheme} ({ec.strategy}) in {self.quantize_seconds:.1f}s",
                  flush=True)
        self.params = params
        self.cache = make_cache(cfg, slots, ec.capacity, cache_cfg=ccfg, device=self.device,
                                tp=tp)
        # per-device KV: a head-sharded pool holds kv / tp heads of every
        # page, a sequence-sharded contiguous cache 1 / tp of every slot's
        # positions (and of the recurrent states' channels)
        kv_split = ccfg.paged and heads_split(model_dims(cfg, tp).kv, tp)
        self._kv_shards = tp if kv_split else 1
        self._seq_shards = tp if ctx.seq_shard else 1
        self._step = build_engine_step(cfg, self.rcfg, ccfg, speculate_k=k,
                                       ctx=ctx)
        self.drafter: Optional[Drafter] = None
        if k:
            # the self drafters propose from the engine's own (quantized) params
            drafter = (make_drafter(ec.drafter, params=self.params, cfg=cfg,
                                    capacity=ec.capacity, policy=quant)
                       if isinstance(ec.drafter, str) else ec.drafter)
            if not isinstance(drafter, Drafter):
                raise TypeError(f"drafter must be a Drafter or name, got "
                                f"{type(drafter).__name__}")
            self.drafter = drafter
            drafter.bind_metrics(self.metrics)

        if ccfg.paged:
            self.alloc: Optional[PageAllocator] = PageAllocator(
                ccfg.num_pages, ccfg.page_size, metrics=self.metrics,
                host_spill_pages=ccfg.host_spill_pages)
            # the eviction spill: the evicted page's packed planes to the host
            self.alloc.spill_fn = lambda page: extract_pages(self.cache, [page])
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
                                 ccfg.max_pages_per_seq if ccfg.paged else 0, self.device,
                                 speculative=bool(k),
                                 d_embed=cfg.d_model if cfg.num_prefix_embeds else 0)
        self.samp = slot_batch(slots, self.device, rows={"ngen": self.inputs.dev["ngen"]})
        # on the card every tick replays a CUDA graph of the step, but at
        # tp > 1, whose collectives no graph can capture: there it runs eagerly
        self.graphs: Optional[GraphedStep] = None
        if self.device.type == "cuda":
            if tp == 1:
                self.graphs = GraphedStep(self._step, self.params, self.cache, self.inputs,
                                          self.samp)
            shape = (slots, k + 4) if k else (2, slots)
            self._out_host = torch.empty(shape, dtype=torch.int32, pin_memory=True)
            self._out_ready = torch.cuda.Event()     # recorded after the copy to _out_host
        self.tick = 0
        self.finished: List[Request] = []
        self._rid = itertools.count()
        # preemption accounting (plain ints, like the allocator's counters)
        self.preemptions = 0       # requests preempted (spilled out)
        self.resumes = 0           # preempted requests re-admitted
        self.spill_pages = 0       # pages whose content spilled host-side
        self.spill_bytes = 0       # host bytes those spills occupied
        self.restored_pages = 0    # pages restored from the host (resumes, host tier)
        # the split step: at most one step in flight (the pinned output block
        # is shared); the tick signal for handles waiting under a driver; the
        # queue lock serialises a front end's submit against admission
        self._pending: Optional[_PendingStep] = None
        self._tick_cv = threading.Condition()
        self.driver_active = False
        self._queue_lock = threading.RLock()

        m = self.metrics
        self.signature = engine_step_signature(cfg, self.rcfg, cache_cfg=ccfg,
                                               chunk=self.step_chunk, speculate_k=k, tp=tp)
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
        self._m_preempt = m.counter("serve_preemptions_total",
                                    "requests preempted (pages spilled)")
        self._m_resume = m.counter("serve_resumes_total", "preempted requests re-admitted")
        self._m_spill_pages = m.counter("serve_spill_pages_total",
                                        "private pages spilled host-side at preemption")
        self._m_restore_pages = m.counter("serve_restore_pages_total",
                                          "spilled pages restored into fresh device pages")
        self._m_spill_bytes = m.counter("serve_spill_bytes_total",
                                        "host bytes occupied by preemption spills")
        self._m_spec_prop = m.counter("serve_spec_proposed_total",
                                      "draft tokens scored by the step")
        self._m_spec_acc = m.counter("serve_spec_accepted_total",
                                     "draft tokens accepted by the verify")
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

        # roofline attribution (obs.cost): analytic floors for this step
        # signature, accumulated in step_end on the host
        self.cost_model = None
        if self.obs.cost_on:
            dims = model_dims(cfg, tp)
            self.cost_model = build_cost_model(cfg, ec.scheme, ccfg, kv=dims.kv, hd=dims.hd,
                                               tp=tp, kv_shards=self._kv_shards,
                                               seq_shards=self._seq_shards,
                                               signature=self.signature)
            self._kv_bpt = float(self.kv_bytes_per_token())
            self._m_floor_b = m.counter("serve_floor_hbm_bytes_total",
                                        "analytic floor HBM bytes (weights + causal KV)")
            self._m_floor_f = m.counter("serve_floor_flops_total", "analytic floor FLOPs")
            self._m_kv_floor = m.counter("serve_kv_floor_bytes_total",
                                         "causal-floor KV bytes (writes + attended reads)")
            self._m_kv_ach = m.counter("serve_kv_achieved_bytes_total",
                                       "KV bytes the cache implementation touches")

    # ------------------------------------------------------------- frontend
    def submit(self, prompt, max_tokens: Optional[int] = None, prefix_embeds=None,
               sampling: Optional[SamplingParams] = None, priority: int = 0) -> RequestHandle:
        """Enqueue a request and return its `RequestHandle`. ``max_tokens`` is
        the length cap (``sampling.max_tokens`` wins when both are given);
        ``sampling`` the per-request draw (greedy when omitted); ``priority``
        (higher = more urgent) orders the queue and, on paged caches with
        ``EngineConfig.preempt``, lets a blocked head preempt a running
        request of strictly lower priority. ``prefix_embeds`` [n, d_model]
        (configs with a modality front end) are fed ahead of the prompt."""
        sp = sampling if sampling is not None else GREEDY
        if sp.max_tokens is not None:
            max_tokens = sp.max_tokens
        if max_tokens is None:
            raise ValueError("max_tokens required (argument or SamplingParams.max_tokens)")
        if prefix_embeds is not None:
            prefix_embeds = np.asarray(prefix_embeds, np.float32)
            if self.cfg.num_prefix_embeds == 0:
                raise ValueError(f"{self.cfg.name} has no modality frontend; "
                                 "prefix_embeds unsupported")
            if prefix_embeds.ndim != 2 or prefix_embeds.shape[1] != self.cfg.d_model:
                raise ValueError(f"prefix_embeds must be [n, d_model={self.cfg.d_model}], "
                                 f"got {prefix_embeds.shape}")
        # host work only (a front end calls this beside the stepping thread,
        # whose CUDA graphs must see no CUDA call from another thread); the
        # queue lock serialises it against the driver's admission pass
        with self._queue_lock:
            rid = next(self._rid)
            # the request-level key folds the seed and the request id (never
            # the slot or tick), so seeded streams replay across restarts
            req = Request(rid=rid, prompt=prompt, max_tokens=max_tokens,
                          prefix_embeds=prefix_embeds, sampling=sp,
                          key_data=request_key(sp.seed, rid), priority=priority)
            ccfg = self.cache_cfg
            # a modality prefix is request-local floats, not hashable pages
            if ccfg.paged and ccfg.prefix_cache and prefix_embeds is None:
                req.page_hashes = prefix_page_hashes(req.prompt, ccfg.page_size,
                                                     ccfg.content_key)
            self.sched.submit(req, self.tick)        # raises when the queue is full
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
        budget; returns the count placed. Paged: gated on the cache-aware
        free-page budget (only uncached pages charge it; a resumed request
        charges only its extension), and the slot gets the request's
        block-table row. Contiguous: the slot's cache rows are zeroed.

        Preemption (paged + ``EngineConfig.preempt``): after admission,
        while the queue head strictly outranks the lowest-priority active
        request and stays blocked, that victim (ties: the latest admitted)
        is preempted and admission runs again. Strictness means a requeued
        request never evicts its own priority class."""
        with self._queue_lock:
            return self._admit_locked()

    def _admit_locked(self) -> int:
        fits = None
        if self.cache_cfg.paged:
            ps = self.cache_cfg.page_size

            def fits(r):
                need = self.alloc.pages_needed(r.kv_need)
                if r.spill is not None:
                    # resume: the kept shared prefix is still pinned, so only
                    # the extension charges; its content is restored after
                    if not self.alloc.can_resume(r.rid, need):
                        return False
                    r.pages = r.pages + self.alloc.resume(r.rid, need)
                    return True
                # always re-feed the last prompt token (its logits give the
                # first generated token), so the matchable prefix stops one short
                hashes = r.page_hashes[: (r.n_prefix + r.prompt_len - 1) // ps]
                if not self.alloc.can_alloc(need, hashes):
                    return False
                r.pages, shared = self.alloc.alloc(r.rid, need, hashes)
                r.cached_len = shared * ps
                r.published = shared
                return True

        def admit_now():
            free = [s for s, r in enumerate(self.active) if r is None]
            room = self.token_budget - self.active_count
            return self.sched.admit(free, self.tick, fits=fits, max_admit=max(0, room))

        n = self._place(admit_now())
        while self.preempt_enabled:
            head = self.sched.head
            victims = [(r.priority, -r.admit_tick, s) for s, r in enumerate(self.active)
                       if r is not None]
            if head is None or not victims:
                break
            pri, _, victim = min(victims)
            if head.priority <= pri:
                break                   # strict: equals never evict each other
            self.preempt(victim)
            n += self._place(admit_now())
        return n

    def _place(self, placed) -> int:
        """Bookkeeping for `sched.admit`'s placements: the host tier's
        pending restores, block-table row or slot reset, sampling row, and
        for a resumed request its spilled state's restore."""
        paged = self.cache_cfg.paged
        if paged and self.alloc.pending_restores:
            # host-tier prefix hits: the matched pages' packed content goes
            # back into fresh pages before any of them is read
            pr, self.alloc.pending_restores = self.alloc.pending_restores, []
            host = tree_map(lambda *ts: torch.cat(ts, dim=ts[0].dim() - 4), *(c for _, c in pr))
            restore_pages(self.cache, [p for p, _ in pr], host)
            self._m_restore_pages.inc(len(pr))
            self.restored_pages += len(pr)
        for slot, req in placed:
            resumed = req.spill is not None
            if paged:
                self.block_tables[slot] = self.alloc.block_table_row(
                    req.rid, self.block_tables.shape[1])
                if not resumed:
                    self._m_cached.inc(req.cached_len)
            else:
                reset_cache_slot(self.cache, slot)
            if not resumed:
                self._m_prompt.inc(req.n_prefix + req.prompt_len)
            if self.trace.enabled:
                self.trace.end(req.rid + 1, "preempted" if resumed else "queued",
                               args={"slot": slot, "cached_len": req.cached_len})
                self.trace.begin(req.rid + 1,
                                 "decode" if (resumed and req.tokens) else "prefill")
            self.active[slot] = req
            self.fed[slot] = req.cached_len       # prefill skip
            fill_slot(self.samp, slot, req.sampling, req.key_data, req.max_tokens)
            req.status = PREFILL
            if resumed:
                self._restore_slot(slot, req)
        return len(placed)

    def _restore_slot(self, slot: int, req: Request) -> None:
        """Write a resumed request's spilled pages into its fresh pages (in
        place, byte-exact) and rewind the slot to the exact spilled
        position: ``fed``, ``last_token`` and the sampling row's ``ngen``,
        so the continued stream equals one never preempted, and nothing is
        prefilled again."""
        sp = req.spill
        if sp.n_pages:
            restore_pages(self.cache, req.pages[sp.n_keep:sp.n_keep + sp.n_pages], sp.content)
            self._m_restore_pages.inc(sp.n_pages)
            self.restored_pages += sp.n_pages
        self.fed[slot] = sp.fed
        self.last_token[slot] = sp.last_token
        self.samp["ngen"][slot] = req.n_generated
        # re-publish restored prompt pages from the kept prefix on: a no-op
        # wherever the original page is still resident
        req.published = sp.n_keep
        req.status = DECODE if req.tokens else PREFILL
        req.spill = None
        self.resumes += 1
        self._m_resume.inc()

    def preempt(self, slot: int) -> Request:
        """Preempt the request in ``slot``: copy its private pages' packed
        content to the host (`cache.extract_pages`), release those pages
        (the shared prefix stays pinned), clear the slot and requeue the
        request ahead of its priority class. Public, so a caller can force a
        preemption at any stream position; the engine's policy calls it
        from `_admit`. Runs between ticks."""
        req = self.active[slot]
        if req is None:
            raise ValueError(f"slot {slot} is idle")
        if not self.cache_cfg.paged:
            raise RuntimeError("preemption requires a paged cache")
        ps = self.cache_cfg.page_size
        fed = int(self.fed[slot])
        n_keep = req.cached_len // ps            # shared prefix: pinned
        n_touched = -(-fed // ps)                # pages holding content
        spill_ids = req.pages[n_keep:n_touched]
        # copy before the release: a released page may be reused at once
        content = extract_pages(self.cache, spill_ids) if spill_ids else None
        nbytes = host_bytes(content) if spill_ids else 0
        self.alloc.preempt(req.rid, n_keep)
        req.pages = req.pages[:n_keep]
        req.spill = SpilledState(fed=fed, last_token=int(self.last_token[slot]),
                                 content=content, n_pages=len(spill_ids), n_keep=n_keep,
                                 nbytes=nbytes)
        req.preemptions += 1
        req.status = PREEMPTED
        req.slot = -1
        self.active[slot] = None
        clear_slot(self.samp, slot)
        self.block_tables[slot] = 0
        self.fed[slot] = 0
        self.last_token[slot] = 0
        self.preemptions += 1
        self.spill_pages += len(spill_ids)
        self.spill_bytes += nbytes
        self._m_preempt.inc()
        self._m_spill_pages.inc(len(spill_ids))
        self._m_spill_bytes.inc(nbytes)
        if self.trace.enabled:
            self.trace.end(req.rid + 1, "decode" if req.tokens else "prefill")
            self.trace.begin(req.rid + 1, "preempted",
                             args={"spill_pages": len(spill_ids), "fed": fed})
        with self._queue_lock:
            self.sched.requeue(req)
        return req

    # ----------------------------------------------------------------- tick
    def _launch(self, width: int, eager: bool = False):
        """Run the step on the staged inputs at ``width`` tokens per slot.
        CUDA tensors replay the graph of (width, sampled) unless ``eager``
        asks for the step function itself (comparisons), start the copy of
        the output block to pinned memory and record an event after it:
        nothing waits here. CPU tensors run the step function and return
        the output block."""
        if self.graphs is not None and not eager:
            out = self.graphs(width, any_sampled(self.samp))
        else:
            self.inputs.send()
            out = run_step(self._step, self.params, self.cache, self.inputs, self.samp, width)
        if not out.is_cuda:
            return out.numpy()
        self._out_host.copy_(out, non_blocking=True)
        self._out_ready.record(torch.cuda.current_stream(self.device))
        return self._out_ready

    def _read(self, launched) -> np.ndarray:
        """The output block of a `_launch`: waits for its event on CUDA."""
        if isinstance(launched, np.ndarray):
            return launched
        launched.synchronize()
        return self._out_host.numpy()

    def device_step(self, width: int, *, eager: bool = False) -> np.ndarray:
        """Run the step on the staged inputs at ``width`` tokens per slot and
        return its output block on the host: [2, B] int32 (next token,
        done), or [B, K+4] for a speculative engine (tokens [B, K+1],
        n_emit, accepted, done). One copy to pinned memory and one wait
        read the result (`_launch`, `_read`)."""
        return self._read(self._launch(width, eager))

    def step(self, *, eager: bool = False) -> Dict[str, object]:
        """One engine tick, exactly ``step_end(step_begin())``: admit (and
        preempt), run the ragged step, advance slots by their consumed chunk
        lengths, emit, roll back rejected drafts, finish and re-admit.
        ``eager`` runs the step function instead of its CUDA graph.

        Returns {"finished": [Request], "generated": int, "active": int}."""
        return self.step_end(self.step_begin(eager=eager))

    def step_begin(self, *, eager: bool = False) -> _PendingStep:
        """First half of a tick: admission (and preemption) under the queue
        lock, chunk sizing, drafting and staging, then the step's launch. On
        the card the graph replays and the output block's copy to pinned
        memory starts; this returns without synchronising, so the host is
        free while the device computes (the front end serves HTTP there).
        CPU tensors run the step function here. Raises if a step is already
        in flight."""
        if self._pending is not None:
            raise RuntimeError("step already in flight (step_end not called)")
        t0 = time.perf_counter()
        PC = self.chunk
        K = self.speculate_k
        tracing = self.trace.enabled
        if tracing:
            self.trace.begin(0, "tick", args={"tick": self.tick})
            self.trace.begin(0, "admit")
        self._admit()
        if tracing:
            self.trace.end(0, "admit")
        if self.active_count == 0:
            # idle ticks still advance the clock (open-loop drivers gate
            # arrivals on it)
            self.tick += 1
            self._m_idle.inc()
            if tracing:
                self.trace.end(0, "tick", args={"idle": True})
            with self._tick_cv:
                self._tick_cv.notify_all()
            return _PendingStep(nvalid=None, ndraft=None, t0=t0, fed=0, tracing=tracing,
                                idle=True, result={"finished": [], "generated": 0, "active": 0})
        self._m_active.set(self.active_count)

        # chunk sizing under the token budget: every active slot gets 1 token;
        # prefilling slots grow toward the prefill chunk, decoding slots of a
        # speculative engine append up to k drafts, both from the leftover
        nvalid = np.zeros(self.slots, np.int32)
        ndraft = np.zeros(self.slots, np.int32)
        proposals: Dict[int, np.ndarray] = {}
        leftover = self.token_budget - self.active_count
        for s, req in enumerate(self.active):
            if req is None:
                continue
            n = 1
            rem = req.n_prefix + req.prompt_len - int(self.fed[s])
            if PC > 1 and rem > 1:
                extra = min(min(PC, rem) - 1, leftover)
                n += max(0, extra)
                leftover -= n - 1
            elif K and rem <= 0:
                # drafts past the length cap could write past the slot's
                # reserved positions, so the cap bounds the draft count too
                k_cap = min(K, req.max_tokens - 1 - req.n_generated, leftover)
                if k_cap > 0:
                    hist = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
                    d = np.asarray(self.drafter.propose(hist, int(k_cap)),
                                   np.int32).reshape(-1)[:k_cap]
                    if d.size:
                        self.drafter.record_proposal(int(d.size))
                        proposals[s] = d
                        ndraft[s] = d.size
                        n += int(d.size)
                        leftover -= int(d.size)
            nvalid[s] = n

        # as the reference's compiled step, a tick that prefills or drafts
        # runs the full [B, step_chunk] block (rows past a slot's nvalid are
        # discarded); the other ticks run [B, 1]: one graph per width
        C = self.step_chunk if nvalid.max() > 1 else 1
        h = self.inputs.host
        h["token"][:] = 0
        h["pos"][:] = -1                                  # idle: write-suppressed
        h["nvalid"][:] = nvalid
        if K:
            h["ndraft"][:] = ndraft
        if "embed_mask" in h:
            h["embed_mask"][:] = 0
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
            npre = req.n_prefix
            if i < npre:                                  # modality prefix rows
                m = min(int(nvalid[s]), npre - i)
                h["embeds"][s, :m] = req.prefix_embeds[i:i + m]
                h["embed_mask"][s, :m] = 1
            for j in range(int(nvalid[s])):
                idx = i + j
                if idx < npre:
                    continue
                if idx < npre + req.prompt_len:
                    h["token"][s, j] = req.prompt[idx - npre]
                elif j == 0 or s not in proposals:
                    h["token"][s, j] = self.last_token[s]
                else:                                     # this round's drafts
                    h["token"][s, j] = proposals[s][j - 1]
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
        p = _PendingStep(nvalid=nvalid, ndraft=ndraft, t0=t0, fed=fed, tracing=tracing)
        if self.device.type == "cuda":
            p.out = self._launch(C, eager)
        else:
            p.out = self.device_step(C, eager=eager)
        self._pending = p
        return p

    def step_end(self, pending: Optional[_PendingStep] = None) -> Dict[str, object]:
        """Second half of a tick: wait for the step's output block, then
        advance slot state by the consumed chunk lengths, publish pages,
        emit, finish or roll back drafts, account the roofline floors,
        re-admit the same tick and signal the tick's waiters. Takes the
        handle of `step_begin` (or the stored one)."""
        p = self._pending if pending is None else pending
        if p is None:
            raise RuntimeError("no step in flight (call step_begin first)")
        self._pending = None
        if p.idle:
            return p.result
        t0, tracing, nvalid, ndraft = p.t0, p.tracing, p.nvalid, p.ndraft
        K = self.speculate_k
        out = self._read(p.out)
        if tracing:
            self.trace.end(0, "device_step")
        if K:
            out_tok, n_emit, acc, done = out[:, :K + 1], out[:, K + 1], out[:, K + 2], out[:, K + 3]
        else:
            out_tok, done = out[0][:, None], out[1]
            n_emit = np.ones(self.slots, np.int32)

        cm = self.cost_model
        ccfg = self.cache_cfg
        finished, generated = [], 0
        tick_reads, tick_ach = 0, 0.0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            i, n = int(self.fed[s]), int(nvalid[s])
            self.fed[s] = i + n
            if cm is not None:
                # causal floor: fed token j attends positions [0, i + j] and
                # writes its own; achieved: what the cache impl moves (dense
                # capacity for a contiguous cache, the whole block-table row
                # for the paged ref gather, causal whole pages for K2 / K3)
                reads = n * i + n * (n + 1) // 2
                ach = cm.achieved_kv_bytes(i, n, cache_kind=ccfg.kind, impl=ccfg.impl,
                                           capacity=self.capacity, page_size=ccfg.page_size,
                                           max_pages=ccfg.max_pages_per_seq,
                                           bytes_per_token=self._kv_bpt)
                req.kv_floor_bytes += (n + reads) * cm.kv_bytes_per_token
                req.kv_achieved_bytes += ach
                tick_reads += reads
                tick_ach += ach
            if req.page_hashes:
                # publish full prompt pages as prefill crosses their ends
                filled = min(int(self.fed[s]), req.prompt_len)
                while (req.published + 1) * ccfg.page_size <= filled:
                    j = req.published
                    self.alloc.publish(req.rid, req.page_hashes[j], req.pages[j])
                    req.published = j + 1
            if i + n - 1 < req.n_prefix + req.prompt_len - 1:
                continue                                  # still prefilling
            # a speculative round emits its accepted drafts and the bonus or
            # corrective draw in one go
            k_s = int(ndraft[s])
            emitted = [int(t) for t in out_tok[s, :int(n_emit[s])]]
            if k_s:
                a = int(acc[s])
                self._m_spec_prop.inc(k_s)
                self._m_spec_acc.inc(a)
                req.drafted += k_s
                req.accepted_drafts += a
            was_first = not req.tokens
            req.tokens.extend(emitted)
            tok = emitted[-1]
            self.last_token[s] = tok
            self.samp["ngen"][s] = len(req.tokens)
            generated += len(emitted)
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
            elif k_s:
                # rollback: the step zeroed the rejected drafts' cache rows
                # (positions i + 1 + a .. i + k_s); rewind the feed position so
                # the next round inserts there again. Drafting starts after
                # the prompt, so the rewind never reaches a shared page
                new_fed = i + 1 + a
                end = req.n_prefix + req.prompt_len
                assert new_fed >= end and new_fed > req.cached_len - 1, (
                    f"slot {s}: speculative rewind to {new_fed} would cross the "
                    f"shared/prompt boundary (cached {req.cached_len}, prompt end {end})")
                self.fed[s] = new_fed
        if cm is not None:
            self._m_floor_b.inc(cm.tick_floor_bytes(p.fed, tick_reads))
            self._m_floor_f.inc(cm.tick_floor_flops(p.fed, tick_reads))
            self._m_kv_floor.inc((p.fed + tick_reads) * cm.kv_bytes_per_token)
            self._m_kv_ach.inc(tick_ach)
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
        with self._tick_cv:
            self._tick_cv.notify_all()
        return {"finished": finished, "generated": generated, "active": self.active_count}

    def wait_tick(self, tick: int, timeout: float = 0.5) -> None:
        """Block until the engine clock passes ``tick`` (handles wait here
        while a driver owns the stepping); the timeout bounds the wait in
        case that driver stops."""
        with self._tick_cv:
            self._tick_cv.wait_for(lambda: self.tick > tick or not self.driver_active,
                                   timeout=timeout)

    def capture_graphs(self) -> None:
        """Capture every CUDA graph the engine replays, widths 1 and the step
        chunk, greedy and sampled, with every slot idle. A capture must see
        no CUDA call from another thread, so a front end calls this on its
        stepping thread before it accepts connections (a graph is otherwise
        captured at its first use). No-op on CPU tensors; at tp > 1, whose
        step runs eagerly, it raises."""
        if self.tp > 1:
            raise NotImplementedError(
                "CUDA graphs of the tp > 1 step: its collectives (gloo, staged through the host "
                "when ranks share a card) cannot be captured; NCCL-captured ticks wait for a "
                "machine with a card per rank (ROADMAP.md, Modules to port)")
        if self.graphs is None:
            return
        if self._pending is not None or self.has_work:
            raise RuntimeError("capture_graphs needs an engine with no work")
        for sampled in (False, True):
            if sampled:      # a sampled row in an idle slot selects the epilogue
                fill_slot(self.samp, 0, SamplingParams(temperature=1.0), request_key(0, 0), 1)
            try:
                for width in sorted({1, self.step_chunk}):
                    if (width, sampled) not in self.graphs.graphs:
                        self.graphs.capture(width, sampled)
            finally:
                if sampled:
                    clear_slot(self.samp, 0)

    def run(self, max_ticks: int = 1_000_000) -> Dict[str, Any]:
        """Drive up to ``max_ticks`` ticks, stopping once queue and slots
        drain. Returns `stats()`."""
        for _ in range(max_ticks):
            if not self.has_work:
                break
            self.step()
        return self.stats()

    def reset_metrics(self) -> None:
        """Drop accumulated timing and counter state (after a warm-up)
        without touching in-flight requests or the cache; registrations and
        callback gauges survive, only values zero."""
        self.finished = []
        self.preemptions = self.resumes = 0
        self.spill_pages = self.spill_bytes = self.restored_pages = 0
        self.metrics.reset()
        if self.alloc is not None:
            self.alloc.reset_stats()

    # ----------------------------------------------------------- accounting
    def kv_bytes_per_token(self) -> int:
        """Cache bytes one token occupies across all layers, by the
        reference's formula (bf16 K and V of kv x hd per layer, or the
        packed AMS planes; an MLA model is counted by its kv heads x head_dim
        as well, as the reference counts it, and so is a Mamba model, which
        keeps no KV at all: falcon-mamba-7b's num_kv_heads 1 x head_dim 64,
        and a hybrid's rec layers beside its attn layers' rings). Per device:
        a head-sharded tp > 1 pool holds kv / tp heads of every page, so this
        scales as 1 / tp, as in the reference; so does a sequence-sharded
        contiguous cache, whose rank holds 1 / tp of every slot's positions
        (the reference counts it whole there)."""
        dims = model_dims(self.cfg, self.tp)
        return self.cfg.num_layers * pool_bytes_per_token(
            dims.kv // self._kv_shards, dims.hd, self.cache_cfg) // self._seq_shards

    def kv_compression_vs_bf16(self) -> float:
        dims = model_dims(self.cfg, self.tp)
        return compression_vs_bf16(dims.kv, dims.hd, self.cache_cfg)

    def stats(self) -> Dict[str, Any]:
        """Aggregate serving stats, computed from the metrics registry (the
        reference's keys; the cost keys with ``ObsConfig(cost=True)``)."""
        raw_s = self._m_tick_s.raw_values()
        raw_t = self._m_tick_tok.raw_values()
        tick_s = np.asarray(raw_s) if raw_s else np.zeros(1)
        tok = np.asarray(raw_t) if raw_t else np.zeros(1)
        total_s = float(tick_s.sum())
        decode_ticks = tick_s[tok > 0]
        ttft = np.asarray(self._m_ttft.raw_values(), np.float64)
        e2e = np.asarray(self._m_lat.raw_values(), np.float64)
        glen = np.asarray(self._m_glen.raw_values(), np.float64)
        spec_prop = int(self._m_spec_prop.value)
        spec_acc = int(self._m_spec_acc.value)
        emit_rounds = int(self._m_emit.value)

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
            # speculative decoding: drafts scored / accepted, and tokens per
            # emitting slot-round (1.0 without speculation)
            "spec_proposed": spec_prop,
            "spec_accepted": spec_acc,
            "accept_rate": spec_acc / spec_prop if spec_prop else 0.0,
            "tokens_per_step": float(tok.sum()) / emit_rounds if emit_rounds else 0.0,
            # preemption (plain ints: real even with ObsConfig(enabled=False))
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "spill_pages": self.spill_pages,
            "spill_bytes": self.spill_bytes,
            "restored_pages": self.restored_pages,
            # whether ticks replay CUDA graphs (not on CPU tensors, nor at tp > 1)
            "graphs": self.graphs is not None,
        }
        if self.alloc is not None:
            out["free_pages"] = self.alloc.free_pages
            out.update(self.alloc.stats())
            prompt_toks = self._m_prompt.value
            out["cached_token_frac"] = (self._m_cached.value / prompt_toks
                                        if prompt_toks else 0.0)
        if self.cost_model is not None:
            # roofline attribution (obs.cost; full report: obs.attribution)
            cm = self.cost_model
            measured = float(out["kv_bytes_per_token"])
            kv_floor = self._m_kv_floor.value
            kv_ach = self._m_kv_ach.value
            out["kv_bytes_per_token_floor"] = cm.kv_bytes_per_token
            out["kv_bytes_per_token_ideal"] = cm.kv_ideal_bytes_per_token
            out["kv_floor_ratio"] = measured / cm.kv_bytes_per_token
            out["kv_vs_ideal_floor"] = measured / cm.kv_ideal_bytes_per_token
            out["kv_achieved_vs_floor"] = kv_ach / kv_floor if kv_floor else 0.0
            out["floor_hbm_bytes"] = self._m_floor_b.value
            out["floor_flops"] = self._m_floor_f.value
        return out
