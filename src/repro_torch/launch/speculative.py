"""Speculative decoding through the ragged engine step (port of
src/repro/launch/speculative.py).

A drafter proposes up to k tokens per decoding slot on the host; the engine
feeds ``[last_token, d_1 .. d_k]`` through the same ragged step chunked
prefill uses (`steps.build_engine_step(speculate_k=k)`), so one pass scores
every draft. `verify_tokens` then decides, on the device, the longest
accepted draft prefix and the one extra token every round emits, and
`truncate_cache` zeroes the rejected entries' cache rows in the same step.

Acceptance (drafts are point masses): a greedy row accepts draft j+1 iff it
equals the argmax at position j, so greedy streams equal non-speculative
ones wherever a row's logits do not depend on the tick's width (see
`launch.engine`); a sampled row accepts draft j with probability p_j(d_j) and, on
rejection, draws from p_j with d_j masked out. The key for the decisions at
stream index n is ``fold_in(request_key, n)``, with the accept uniform on
its sub-fold 1 and the draw on sub-fold 2 (`launch.prng`).

Drafters: prompt-lookup n-grams (`NgramDrafter`), and early-exit self
drafting (`SelfDrafter`): greedy proposals from the serving model's first
layer (``"self"``) or whole stack (``"self-full"``) through
`models.forward_seq`, run eagerly on the host side of the engine's
`step_begin`, outside every CUDA graph (it reads one token back per
proposal, as the reference's does).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

from . import prng
from .sampling import any_sampled, log_softmax, masked_logits, tempered

# ---------------------------------------------------------------------------
# drafters (host-side, deterministic proposals)
# ---------------------------------------------------------------------------
class Drafter:
    """Proposal interface: ``propose(history, k)`` returns up to k draft
    tokens (np.int32 [<=k]) continuing ``history`` (prompt + generated so
    far). Proposals must be deterministic functions of the history."""

    name = "drafter"
    _m_proposed = None

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError

    def bind_metrics(self, registry) -> None:
        """Count proposals per drafter name in an `obs.MetricsRegistry`."""
        self._m_proposed = registry.counter(
            "spec_drafter_proposed_total", "draft tokens proposed, by drafter",
            ("drafter",)).labels(drafter=self.name)

    def record_proposal(self, n: int) -> None:
        if self._m_proposed is not None:
            self._m_proposed.inc(n)


class NgramDrafter(Drafter):
    """Prompt-lookup decoding: match the longest trailing n-gram of the
    history against its earlier occurrences and propose the tokens that
    followed the most recent match."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32)
        L = h.shape[0]
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pattern = h[L - n:]
            # earlier occurrences must end before the trailing n-gram starts
            windows = np.lib.stride_tricks.sliding_window_view(h[:L - 1], n)
            hits = np.flatnonzero(np.all(windows == pattern[None, :], axis=1))
            if hits.size:
                p = int(hits[-1])                    # most recent occurrence
                return h[p + n: p + n + k].copy()
        return np.zeros(0, np.int32)


class SelfDrafter(Drafter):
    """Early-exit self drafting: greedy proposals from the first
    ``draft_groups`` stacked layers of the serving model itself (the same,
    possibly quantized, weights, embedding and head; ``None`` keeps the
    whole stack, the accept-rate ceiling). Each proposal runs
    `models.forward_seq` over a fixed ``capacity``-token buffer (causal
    masking makes the padding inert) and reads the argmax at the last
    filled position."""

    name = "self"

    def __init__(self, params, cfg, capacity: int, *, draft_groups: Optional[int] = 1,
                 policy=None):
        import dataclasses

        n_groups = tree_leaves(params["layers"])[0].shape[0]
        g = n_groups if draft_groups is None else draft_groups
        if not 1 <= g <= n_groups:
            raise ValueError(f"draft_groups must be in [1, {n_groups}], got {g}")
        self.draft_params = dict(params, layers=tree_map(lambda t: t[:g], params["layers"]))
        self.draft_cfg = dataclasses.replace(cfg, num_layers=g)
        self.capacity = capacity
        self.policy = policy

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        from repro_torch.models import forward_seq

        h = np.asarray(history, np.int32)
        # the most recent context that leaves room for k drafts in the buffer
        h = h[max(0, h.shape[0] - (self.capacity - k)):]
        L = h.shape[0]
        dev = tree_leaves(self.draft_params["embed"])[0].device
        buf = torch.zeros((1, self.capacity), dtype=torch.int32, device=dev)
        buf[0, :L] = torch.from_numpy(h).to(dev)
        out = []
        for j in range(k):
            logits, _, _ = forward_seq(self.draft_params, buf, self.draft_cfg,
                                       policy=self.policy)
            nxt = int(torch.argmax(logits[0, L + j - 1]))
            buf[0, L + j] = nxt
            out.append(nxt)
        return np.asarray(out, np.int32)


DRAFTERS = ("ngram", "self", "self-full")


def make_drafter(name: str, *, params=None, cfg=None, capacity: int = 0,
                 policy=None) -> Drafter:
    """Engine-facing factory: ``"ngram"`` needs nothing; ``"self"`` binds the
    first stacked layer of the engine's own params and config, ``"self-full"``
    the whole stack."""
    if name == "ngram":
        return NgramDrafter()
    if name in ("self", "self-full"):
        if params is None or cfg is None or capacity < 1:
            raise ValueError(f"the {name!r} drafter needs the engine's params, config and "
                             "capacity")
        return SelfDrafter(params, cfg, capacity, policy=policy,
                           draft_groups=None if name == "self-full" else 1)
    raise ValueError(f"unknown drafter {name!r} (expected one of {DRAFTERS})")


# ---------------------------------------------------------------------------
# on-device verify: accept / resample / terminate
# ---------------------------------------------------------------------------
def _accepted(ok: torch.Tensor) -> torch.Tensor:
    """Length of the leading run of True per row of [B, K] (0 for K = 0)."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def _rows_greedy(logits, drafts, ndraft):
    """Temperature 0: accepted = the longest draft prefix matching the
    running argmax; the candidate at every position is the argmax
    (the reference's `_row_greedy`, for all rows at once)."""
    cand = torch.argmax(logits, dim=-1).to(torch.int32)                # [B, K+1]
    jj = torch.arange(drafts.shape[1], device=drafts.device)[None, :]
    return _accepted((drafts == cand[:, :-1]) & (jj < ndraft[:, None])), cand


def _rows_sampled(logits, drafts, ndraft, rows):
    """Temperature > 0: the rejection rule against point-mass proposals
    (the reference's `_row_sampled`, for all rows at once). Position j uses
    ``fold_in(key, ngen + j)``, the accept uniform its sub-fold 1, the draw
    its sub-fold 2. The residual draw at j < ndraft and the plain draw share
    their Gumbel noise (one key), as the reference's two categoricals do."""
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    masked = masked_logits(tempered(logits, rows["temperature"]),
                           rows["top_k"][:, None].expand(B, K1),
                           rows["top_p"][:, None].expand(B, K1))       # [B, K+1, V]
    logp = log_softmax(masked)
    jj = torch.arange(K1, device=dev)
    keys = prng.fold_in(rows["key"][:, None, :], rows["ngen"][:, None] + jj[None, :])
    k_accept, k_draw = prng.fold_in(keys, 1), prng.fold_in(keys, 2)    # [B, K+1, 2]
    d = drafts.long()[..., None]
    p_d = torch.exp(torch.gather(logp[:, :K], 2, d)[..., 0])
    u = prng.uniform(k_accept[:, :K])
    live = jj[None, :K] < ndraft[:, None]
    acc = _accepted((u < p_d) & live)
    noise = prng.gumbel(k_draw, (V,))
    plain = torch.argmax(noise + masked, dim=-1)
    excl = masked[:, :K].scatter(2, d, -torch.inf)
    resampled = torch.argmax(noise[:, :K] + excl, dim=-1)
    cand = torch.cat([torch.where(live, resampled, plain[:, :K]), plain[:, K:]], dim=1)
    return acc, cand.to(torch.int32)


def verify_tokens(logits, token, nvalid, ndraft, sampling: dict, k_max: int):
    """The speculative step's epilogue: accept drafts, emit, terminate.

    logits   [B, K+1, V]  target logits at the last ndraft+1 fed positions
                          (row j scores the token after draft j)
    token    [B, C]       the fed chunk; drafts sit at nvalid-ndraft .. nvalid-1
    nvalid, ndraft [B]    fed and draft counts per slot
    sampling              the `slot_batch` rows (the branch from the host's
                          numpy temperatures, the draws from the device rows)

    Returns (out_tokens [B, K+1], n_emit [B], accepted [B], done [B]):
    ``out_tokens[:, :n_emit]`` are the round's emitted tokens, truncated at
    the first stop-token or length-cap hit; ``accepted`` counts accepted
    drafts before truncation. Rows with ndraft == 0 emit one token, the
    greedy argmax or the sub-fold-2 draw."""
    B, C = token.shape
    rows = sampling["device"]
    dev = token.device
    dstart = nvalid - ndraft
    didx = torch.clamp(dstart[:, None] + torch.arange(k_max, device=dev)[None, :], 0, C - 1)
    drafts = torch.gather(token, 1, didx.long()).to(torch.int32)         # [B, K]
    lg = logits.to(torch.float32)
    acc, cand = _rows_greedy(lg, drafts, ndraft)
    if any_sampled(sampling):
        acc_s, cand_s = _rows_sampled(lg, drafts, ndraft, rows)
        sampled = rows["temperature"] > 0
        acc = torch.where(sampled, acc_s, acc)
        cand = torch.where(sampled[:, None], cand_s, cand)

    final = torch.gather(cand, 1, acc.long()[:, None])                   # [B, 1]
    jj = torch.arange(k_max + 1, device=dev)[None, :]
    dpad = torch.nn.functional.pad(drafts, (0, 1))
    out = torch.where(jj < acc[:, None], dpad,
                      torch.where(jj == acc[:, None], final, 0)).to(torch.int32)
    stop_hit = (out[:, :, None] == rows["stop_ids"][:, None, :]).any(dim=-1)
    len_hit = rows["ngen"][:, None] + jj + 1 >= rows["max_tokens"][:, None]
    end = (stop_hit | len_hit) & (jj <= acc[:, None])
    done = end.any(dim=1)
    n_emit = torch.where(done, torch.argmax(end.to(torch.int32), dim=1) + 1, acc + 1)
    return out, n_emit.to(torch.int32), acc, done


# ---------------------------------------------------------------------------
# in-step rollback: rejected positions back to the cache's initial zeros
# ---------------------------------------------------------------------------
def truncate_cache(cache, start, count, c_max: int, cache_cfg=None, block_tables=None,
                   ctx=None):
    """Zero ``count`` cache positions from ``start`` (per slot) in every
    layer's leaves, in place: page pools through the block tables
    (`cache.pool.paged_truncate`), contiguous caches by (slot, row)
    (`models.attention.cache_truncate_chunk`; under a sequence-sharded
    ``ctx`` the rank zeroes the positions its shard holds). Slots with
    count == 0 or start < 0 keep every byte. ``c_max`` bounds the per-slot
    width (the step's draft count). Returns ``cache``."""
    if cache_cfg is not None and cache_cfg.paged:
        from repro_torch.cache.pool import paged_truncate
        for pool in cache["layers"].values():
            paged_truncate(pool, start, count, block_tables, cache_cfg, c_max)
        return cache
    from repro_torch.models.attention import cache_truncate_chunk
    for leaf in tree_leaves(cache["layers"]):
        for g in range(leaf.shape[0]):
            cache_truncate_chunk(leaf[g], start, count, c_max, ctx)
    return cache
