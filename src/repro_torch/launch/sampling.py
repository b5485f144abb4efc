"""Per-request sampling parameters and the greedy step epilogue (port of
src/repro/launch/sampling.py).

The port carries the greedy path only: ``temperature == 0`` is an exact
argmax (first maximal index, as ``jnp.argmax``), and termination is decided
in-step: ``done = stop_token_hit | (n_generated + 1 >= max_tokens)``. Seeded
sampling (``temperature > 0``) replays the reference's streams only through
a port of JAX's threefry keys (``request_key``, ``sampling.py:104``), which
is not done yet (ROADMAP.md, Modules to port): it raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# fixed width of the per-slot stop-id row the step consumes
MAX_STOP_IDS = 8

# pad value for unused stop-id lanes: no token is ever negative
_NO_STOP = -1
_NO_LIMIT = np.iinfo(np.int32).max

# the rows `sample_tokens` reads on the device
DEVICE_ROWS = ("ngen", "max_tokens", "stop_ids")

SAMPLING_TODO = ("temperature > 0 needs the threefry port of the reference's "
                 "PRNG keys (ROADMAP.md, Modules to port)")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling + termination configuration.

    temperature  0.0 = greedy argmax (exact; top_k/top_p ignored)
    top_k        keep the k highest logits (0 = disabled)
    top_p        nucleus: keep the smallest prefix of the sorted
                 distribution with cumulative mass >= top_p (1.0 = off)
    seed         request-level PRNG seed (folded with the request id)
    max_tokens   length cap; None = resolved from the submit() argument
    stop_token_ids  sampling one of these ends the request (EOS lives
                 here); the stop token is included in the output stream
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_tokens: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        ids = tuple(int(t) for t in self.stop_token_ids)
        if len(ids) > MAX_STOP_IDS:
            raise ValueError(
                f"at most {MAX_STOP_IDS} stop_token_ids supported, got {len(ids)}")
        if any(t < 0 for t in ids):
            raise ValueError(f"stop_token_ids must be non-negative, got {ids}")
        object.__setattr__(self, "stop_token_ids", ids)

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def slot_batch(n_slots: int, device="cpu", rows: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Per-slot sampling state: numpy rows on the host (``ngen``,
    ``temperature``, ``max_tokens``, ``stop_ids``) and, under ``"device"``,
    the rows the step reads (``ngen``, ``max_tokens``, ``stop_ids``) as
    int32 tensors on ``device``. ``rows`` may give some of those tensors
    (the engine's ``ngen`` is a view of its static step inputs, refreshed
    by the tick's staging copy); the others are made here. Idle rows are
    harmless defaults (greedy, never stopping)."""
    batch = {
        "ngen": np.zeros(n_slots, np.int32),
        "temperature": np.zeros(n_slots, np.float32),
        "max_tokens": np.full(n_slots, _NO_LIMIT, np.int32),
        "stop_ids": np.full((n_slots, MAX_STOP_IDS), _NO_STOP, np.int32),
    }
    batch["device"] = {}
    for name in DEVICE_ROWS:
        t = (rows or {}).get(name)
        if t is None:
            t = torch.empty(batch[name].shape, dtype=torch.int32, device=device)
        t.copy_(torch.from_numpy(batch[name]))
        batch["device"][name] = t
    return batch


def _send_row(batch: dict, slot: int) -> None:
    """Copy one slot's host rows to the device rows (at admission and
    release, between ticks: never inside the step)."""
    for name in DEVICE_ROWS:
        batch["device"][name][slot].copy_(torch.from_numpy(np.asarray(batch[name][slot])))


def fill_slot(batch: dict, slot: int, params: SamplingParams, max_tokens: int) -> None:
    """Write one request's resolved sampling state into its slot row."""
    if not params.greedy:
        raise NotImplementedError(SAMPLING_TODO)
    batch["ngen"][slot] = 0
    batch["temperature"][slot] = params.temperature
    batch["max_tokens"][slot] = max_tokens
    batch["stop_ids"][slot] = _NO_STOP
    if params.stop_token_ids:
        batch["stop_ids"][slot, :len(params.stop_token_ids)] = params.stop_token_ids
    _send_row(batch, slot)


def clear_slot(batch: dict, slot: int) -> None:
    """Reset a freed slot row to the idle defaults."""
    batch["ngen"][slot] = 0
    batch["temperature"][slot] = 0.0
    batch["max_tokens"][slot] = _NO_LIMIT
    batch["stop_ids"][slot] = _NO_STOP
    _send_row(batch, slot)


def sample_tokens(logits: torch.Tensor, sampling: dict):
    """The step's epilogue: per-slot greedy draw + in-step termination.

    logits [B, V]; ``sampling`` the `slot_batch` rows: the host check of the
    temperatures reads numpy, the draw only the device rows, so the epilogue
    copies nothing from the host. Returns (next_token [B] int32, done [B]
    bool) on the logits' device."""
    if np.any(sampling["temperature"] > 0):
        raise NotImplementedError(SAMPLING_TODO)
    rows = sampling["device"]
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    stop_hit = (next_token[:, None] == rows["stop_ids"]).any(dim=-1)
    return next_token, stop_hit | (rows["ngen"] + 1 >= rows["max_tokens"])
