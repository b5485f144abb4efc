# Port of src/repro/launch/scheduler.py: a copy with its imports rewired to repro_torch.
"""Request queue + slot admission for the continuous-batching engine.

The scheduler owns the *host-side* half of serving state: a priority queue
of pending requests and the mapping of requests into free slots of the
fixed-capacity KV cache. Admission is capacity-safe by construction — a
request is only accepted at submit time if its full footprint (prefix
embeddings + prompt + generated tokens) fits one cache slot.

Policy: priority classes over strict arrival order. Every request carries
an integer ``priority`` (higher = more urgent, default 0); the queue is
ordered by (priority desc, arrival order asc), so an all-default workload
degenerates to EXACTLY the strict FIFO of PRs 1–9 (pinned by the existing
engine tests). A preempted request re-enters via ``requeue`` AHEAD of every
waiting request of its priority class (it already consumed service, and it
holds spilled state that should drain quickly), but still behind any
strictly-higher class.

For the paged KV cache the engine passes ``admit(..., fits=...)`` — the
CACHE-AWARE free-page budget check: it matches the request's prompt-page
hashes against the allocator's prefix index (longest resident prefix) and
charges only the UNCACHED page count against the free budget, so a request
whose prompt is mostly cached admits even under page pressure. Queue order
is preserved by head-of-line blocking (a queue head that doesn't fit stops
admission rather than being jumped); under the engine's preemption policy
(`EngineConfig.preempt`) a blocked head of strictly higher priority
triggers victim preemption in the ENGINE, which spills the victim's pages
host-side and calls ``requeue`` — the scheduler itself never touches device
state. Because ``fits`` returning True guarantees admission, the engine's
check allocates pages directly — the matched prefix is pinned
(refcount += 1) and recorded as ``cached_len`` so the engine can skip
prefilling it.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.launch.sampling import GREEDY, SamplingParams
from repro_torch.obs.metrics import NULL_REGISTRY

# Request.status lifecycle values (RequestHandle.status re-exports these):
#   queued -> prefill -> decode -> finished
#                 \______ preempted ______/   (back via requeue -> prefill)
QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
PREEMPTED = "preempted"
FINISHED = "finished"
REQUEST_STATUSES = (QUEUED, PREFILL, DECODE, PREEMPTED, FINISHED)


@dataclasses.dataclass
class SpilledState:
    """Host-side snapshot of a preempted request's in-flight state: exactly
    what the engine needs to resume it bit-identically — the device resume
    point, the next input token, and the released pages' content in the
    pool's PACKED storage layout (`cache.pool.extract_pages`), so AMS
    planes round-trip byte-exactly."""

    fed: int                 # cache positions already inserted (resume point)
    last_token: int          # next input token id to feed at position `fed`
    content: Any             # extract_pages pytree of the released pages
    n_pages: int             # released page count (page axis of `content`)
    n_keep: int              # shared-prefix pages that stayed pinned
    nbytes: int = 0          # host bytes the snapshot occupies (accounting)


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle inside the engine."""

    rid: int
    prompt: np.ndarray                    # [P] int32 token ids
    max_tokens: int                       # length CAP (stop tokens may end
    #                                       the stream earlier)
    prefix_embeds: Optional[np.ndarray] = None  # [n_prefix, D] f32 (VLM/audio)
    sampling: SamplingParams = GREEDY     # per-request sampling config
    key_data: Optional[np.ndarray] = None  # uint32[2] request-level PRNG key
    #                                        (fold_in(PRNGKey(seed), rid);
    #                                        engine-filled at submit)
    priority: int = 0                     # higher = more urgent; default 0
    #                                       everywhere = strict FIFO

    # lifecycle, filled by the scheduler/engine (tick = engine step index).
    # admit_tick can precede the first served tick by one: a slot freed by
    # an early-terminating request re-admits the SAME tick it frees (after
    # that tick's step already ran), so the admitted request's first chunk
    # runs at admit_tick + 1 — `first_step_tick` records the tick that
    # actually served it.
    submit_tick: int = -1
    admit_tick: int = -1
    first_step_tick: int = -1             # first tick whose step served us
    first_token_tick: int = -1            # tick that produced tokens[0]
    finish_tick: int = -1
    finish_reason: str = ""               # "stop" (EOS/stop id) | "length"
    slot: int = -1
    status: str = QUEUED                  # lifecycle (REQUEST_STATUSES)
    tokens: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)  # paged mode

    # preemption (engine-filled; paged modes only):
    preemptions: int = 0                  # times this request was preempted
    spill: Optional[SpilledState] = None  # host snapshot while PREEMPTED

    # speculative decoding accounting (engine-filled; see launch.speculative)
    drafted: int = 0           # draft tokens scored for this request
    accepted_drafts: int = 0   # ... accepted by the verify rule

    # prefix caching (paged modes, engine-filled — see cache.allocator):
    page_hashes: Tuple[bytes, ...] = ()   # chain hash per FULL prompt page
    cached_len: int = 0    # positions served from shared pages at admission;
    #                        prefill starts at this position (prefill skip)
    published: int = 0     # prompt pages published to the prefix index so far

    # roofline attribution (engine-filled when ObsConfig.cost — see
    # repro.obs.cost): KV bytes this request's served tokens account for,
    # at the analytic floor vs what the cache implementation touches
    kv_floor_bytes: float = 0.0
    kv_achieved_bytes: float = 0.0

    def __post_init__(self):
        # the [P] int32 contract above is load-bearing: the engine feeds
        # prompt tokens straight into an int32 device buffer
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)

    @property
    def n_prefix(self) -> int:
        return 0 if self.prefix_embeds is None else self.prefix_embeds.shape[0]

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def kv_need(self) -> int:
        """WORST-CASE cache positions this request writes: every fed input
        inserts one KV entry; the last generated token is never fed back.
        Admission reserves this; a stop-token hit frees the unused tail
        early (the request ends before the length cap)."""
        return self.n_prefix + self.prompt_len + self.max_tokens - 1

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def done(self) -> bool:
        return self.finish_tick >= 0

    @property
    def ttft_ticks(self) -> int:
        """Submit -> first generated token, in engine ticks (-1 if none yet).
        This is the headline number chunked prefill moves: prompt positions
        consumed per tick go from 1 to the chunk size."""
        if self.first_token_tick < 0:
            return -1
        return self.first_token_tick - self.submit_tick

    @property
    def prefill_ticks(self) -> int:
        """Ticks spent consuming the (uncached) prompt before the first
        generated token: ceil(uncached_prompt / chunk) by construction.
        Computed from the first SERVED tick, so it is invariant to whether
        admission happened at tick start or in the same-tick post-finish
        pass (-1 before the first token)."""
        if self.first_token_tick < 0:
            return -1
        return self.first_token_tick - self.first_step_tick + 1

    @property
    def kv_vs_floor(self) -> float:
        """KV read/write amplification for this request: bytes the cache
        implementation touched over the causal floor (0.0 until served
        with cost accounting on)."""
        if self.kv_floor_bytes <= 0:
            return 0.0
        return self.kv_achieved_bytes / self.kv_floor_bytes

    @property
    def latency_ticks(self) -> int:
        """Submit -> finish, in engine ticks (queueing included; -1 while
        in flight)."""
        if self.finish_tick < 0:
            return -1
        return self.finish_tick - self.submit_tick


class FIFOScheduler:
    """Priority admission into free KV-cache slots — (priority desc,
    arrival asc) order, which with all-default priorities is EXACTLY the
    strict FIFO this class shipped as in PRs 1–9 (hence the name).

    ``capacity`` is the per-slot sequence capacity of the engine's KV cache;
    ``max_queue`` (optional) bounds the pending queue — past it, ``submit``
    raises, which is the backpressure signal the frontend surfaces as 429.
    """

    def __init__(self, capacity: int, max_queue: Optional[int] = None,
                 metrics=None):
        self.capacity = capacity
        self.max_queue = max_queue
        # min-heap of (-priority, order, Request): order is a monotonic
        # submit counter, so equal priorities pop in arrival order; requeued
        # (preempted) requests take DECREASING negative orders, so they pop
        # ahead of every waiting request of their class
        self._queue: List[Tuple[int, int, Request]] = []
        self._order = 0
        self._rorder = 0
        # telemetry (repro.obs): the engine passes its registry; a bare
        # scheduler gets the shared no-op instruments
        m = metrics if metrics is not None else NULL_REGISTRY
        self._m_submitted = m.counter(
            "sched_requests_submitted_total", "requests accepted into the queue")
        self._m_rejected = m.counter(
            "sched_requests_rejected_total",
            "queue-full backpressure rejections (submit raised)")
        self._m_admitted = m.counter(
            "sched_requests_admitted_total", "requests placed into slots")
        self._m_blocked = m.counter(
            "sched_admit_blocked_total",
            "head-of-line blocks: the queue head failed the fits() gate")
        self._m_requeued = m.counter(
            "sched_requests_requeued_total",
            "preempted requests returned to the queue head")

    def submit(self, req: Request, tick: int) -> Request:
        if req.max_tokens < 1:
            raise ValueError(f"request {req.rid}: max_tokens must be >= 1")
        if req.prompt_len < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.kv_need > self.capacity:
            raise ValueError(
                f"request {req.rid} needs {req.kv_need} cache positions "
                f"(prefix {req.n_prefix} + prompt {req.prompt_len} + "
                f"{req.max_tokens} tokens - 1) but slot capacity is "
                f"{self.capacity}")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._m_rejected.inc()
            raise RuntimeError(
                f"queue full ({self.max_queue}); request {req.rid} rejected")
        req.submit_tick = tick
        req.status = QUEUED
        self._order += 1
        heapq.heappush(self._queue, (-req.priority, self._order, req))
        self._m_submitted.inc()
        return req

    def requeue(self, req: Request) -> Request:
        """Return a PREEMPTED request to the queue, ahead of every waiting
        request of its priority class (it already consumed service and
        holds spilled pages that should drain) but behind any strictly
        higher class. Not subject to ``max_queue`` — rejecting a request
        we already accepted and part-served is not backpressure, it is
        data loss."""
        self._rorder -= 1
        heapq.heappush(self._queue, (-req.priority, self._rorder, req))
        self._m_requeued.inc()
        return req

    @property
    def head(self) -> Optional[Request]:
        """The request `admit` would place next (None when idle) — the
        engine's preemption policy compares its priority against the
        active slots'."""
        return self._queue[0][2] if self._queue else None

    def admit(self, free_slots: List[int], tick: int,
              fits: Optional[Callable[[Request], bool]] = None,
              max_admit: Optional[int] = None,
              ) -> List[Tuple[int, Request]]:
        """Assign queued requests to free slots, FIFO order. Returns
        (slot, request) pairs; the engine resets each slot's cache row
        before the request's first token is fed.

        ``fits(req)`` (optional) is an extra admission gate — the paged
        engine passes its cache-aware free-page budget check (longest
        resident prefix matched, only uncached pages charged; returning
        True also performs the page allocation, which is safe because True
        here guarantees the request is admitted). A queue head that does
        not fit BLOCKS admission (strict FIFO, no overtaking).

        ``max_admit`` (optional) caps admissions this tick — the chunked
        engine passes its remaining TOKEN budget headroom
        (token_budget - active slots), so the number of active slots never
        exceeds the per-tick token budget and every slot (decode slots
        included) is guaranteed to advance at least one token per tick no
        matter how many long prefills are chunking."""
        placed = []
        for slot in free_slots:
            if not self._queue:
                break
            if max_admit is not None and len(placed) >= max_admit:
                break
            if fits is not None and not fits(self._queue[0][2]):
                self._m_blocked.inc()
                break
            req = heapq.heappop(self._queue)[2]
            req.admit_tick = tick
            req.slot = slot
            placed.append((slot, req))
        self._m_admitted.inc(len(placed))
        return placed

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def __len__(self) -> int:
        return len(self._queue)
