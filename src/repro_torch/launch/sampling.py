"""Per-request sampling parameters and the step's sampling epilogue (port of
src/repro/launch/sampling.py).

The reference's three contracts hold:

  * ``temperature == 0`` is greedy: the exact argmax (first maximal index,
    as ``jnp.argmax``), top_k / top_p ignored. An all-greedy batch runs
    only the argmax. The reference picks that branch with a ``lax.cond``
    on the device; the port picks it on the host from its numpy
    ``temperature`` rows (`any_sampled`), and the card replays a separate
    CUDA graph for each branch.
  * Key discipline: each draw uses ``fold_in(fold_in(PRNGKey(seed), rid),
    ngen)`` through the port's threefry (`launch.prng`). The request-level
    half (`request_key`) is folded on the host at submit, the per-draw half
    in the step from the slot's generated count, so a seeded stream
    replays across restarts, slot counts and prefill chunking. On the card
    that holds where every step of a row gives it the same bits at any tick
    width and slot count: on the paged AMS paths (K1 and K2 split a row's
    work by its own shape, this epilogue's sums by part), which
    ``chip_smoke.py`` checks; the contiguous and bf16 paths are not held
    to it.
  * Termination is decided in-step: ``done = stop_token_hit |
    (n_generated + 1 >= max_tokens)``.

Transform order per row: scale by temperature, mask to top-k, mask to top-p
(on the tempered distribution, one descending sort for both), Gumbel-max
categorical draw.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import row_sum

from . import prng

# fixed width of the per-slot stop-id row the step consumes
MAX_STOP_IDS = 8

# pad value for unused stop-id lanes: no token is ever negative
_NO_STOP = -1
_NO_LIMIT = np.iinfo(np.int32).max

# the rows the step reads on the device, with their device dtypes (keys are
# uint32 pairs held in int64, as `launch.prng` computes on them)
DEVICE_ROWS = {"key": torch.int64, "ngen": torch.int32, "temperature": torch.float32,
               "top_k": torch.int32, "top_p": torch.float32, "max_tokens": torch.int32,
               "stop_ids": torch.int32}


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


def request_key(seed: int, rid: int) -> np.ndarray:
    """Host-side request-level key: fold_in(PRNGKey(seed), rid) as raw
    uint32[2] data. Computed once at submit; the per-draw fold happens
    in-step from the generated-token count."""
    return prng.key_data(prng.fold_in(prng.PRNGKey(seed), rid))


def slot_batch(n_slots: int, device="cpu", rows: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Per-slot sampling state: the reference's numpy rows on the host
    (``key``, ``ngen``, ``temperature``, ``top_k``, ``top_p``,
    ``max_tokens``, ``stop_ids``) and, under ``"device"``, each as a tensor
    on ``device`` (`DEVICE_ROWS`). ``rows`` may give some of those tensors
    (the engine's ``ngen`` is a view of its static step inputs, refreshed
    by the tick's staging copy); the others are made here. Idle rows are
    harmless defaults (greedy, never stopping, zero key)."""
    batch = {
        "key": np.zeros((n_slots, 2), np.uint32),
        "ngen": np.zeros(n_slots, np.int32),
        "temperature": np.zeros(n_slots, np.float32),
        "top_k": np.zeros(n_slots, np.int32),
        "top_p": np.ones(n_slots, np.float32),
        "max_tokens": np.full(n_slots, _NO_LIMIT, np.int32),
        "stop_ids": np.full((n_slots, MAX_STOP_IDS), _NO_STOP, np.int32),
    }
    batch["device"] = {}
    for name, dtype in DEVICE_ROWS.items():
        t = (rows or {}).get(name)
        if t is None:
            t = torch.empty(batch[name].shape, dtype=dtype, device=device)
        t.copy_(_host_row(batch, name))
        batch["device"][name] = t
    return batch


def _host_row(batch: dict, name: str, slot=slice(None)) -> torch.Tensor:
    a = np.asarray(batch[name][slot])
    return torch.from_numpy(a.astype(np.int64) if name == "key" else a.copy())


def _send_row(batch: dict, slot: int) -> None:
    """Copy one slot's host rows to the device rows (at admission, release
    and resume, between ticks: never inside the step)."""
    for name in DEVICE_ROWS:
        batch["device"][name][slot].copy_(_host_row(batch, name, slot))


def fill_slot(batch: dict, slot: int, params: SamplingParams,
              key_data: Optional[np.ndarray] = None, max_tokens: int = _NO_LIMIT) -> None:
    """Write one request's resolved sampling state into its slot row
    (``key_data`` None: the zero key, as a greedy row never draws)."""
    batch["key"][slot] = 0 if key_data is None else key_data
    batch["ngen"][slot] = 0
    batch["temperature"][slot] = params.temperature
    batch["top_k"][slot] = params.top_k
    batch["top_p"][slot] = params.top_p
    batch["max_tokens"][slot] = max_tokens
    batch["stop_ids"][slot] = _NO_STOP
    if params.stop_token_ids:
        batch["stop_ids"][slot, :len(params.stop_token_ids)] = params.stop_token_ids
    _send_row(batch, slot)


def clear_slot(batch: dict, slot: int) -> None:
    """Reset a freed slot row to the idle defaults."""
    batch["key"][slot] = 0
    batch["ngen"][slot] = 0
    batch["temperature"][slot] = 0.0
    batch["top_k"][slot] = 0
    batch["top_p"][slot] = 1.0
    batch["max_tokens"][slot] = _NO_LIMIT
    batch["stop_ids"][slot] = _NO_STOP
    _send_row(batch, slot)


def any_sampled(batch: dict) -> bool:
    """Whether any slot samples (temperature > 0): the host's choice of the
    epilogue, read from the numpy rows."""
    return bool(np.any(batch["temperature"] > 0))


# ---------------------------------------------------------------------------
# device-side transforms
# ---------------------------------------------------------------------------
def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum over the last axis. On CUDA torch scans a single row
    with another algorithm than two or more (other bits), so one row is
    scanned as two."""
    if x.is_cuda and x.numel() == x.shape[-1]:
        return torch.cumsum(x.reshape(1, -1).expand(2, -1), dim=-1)[:1].reshape(x.shape)
    return torch.cumsum(x, dim=-1)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / row_sum(e)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis: shifted - log(sum(exp(shifted)))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(row_sum(torch.exp(shifted)))


def _row_value(sorted_desc: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(sorted_desc, -1, idx.long()[..., None])[..., 0]


def mask_top_k(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Top-k mask per row of [..., V] (the reference's `_mask_top_k`): keep
    the k highest logits, ties at the cutoff included; k <= 0 disables."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = _row_value(sorted_desc, torch.clamp(k, 1, v) - 1)
    kth = torch.where(k > 0, kth, -torch.inf)
    return torch.where(logits >= kth[..., None], logits, -torch.inf)


def mask_top_p(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask per row (the reference's `_mask_top_p`): keep the
    smallest prefix of the descending sort whose mass reaches p (the top
    token always survives, ties at the cutoff included); p >= 1 disables."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = _softmax(sorted_desc)
    keep = (_row_cumsum(probs) - probs) < p[..., None]
    n_keep = torch.clamp_min(keep.sum(dim=-1), 1)
    cutoff = torch.where(p >= 1.0, -torch.inf, _row_value(sorted_desc, n_keep - 1))
    return torch.where(logits >= cutoff[..., None], logits, -torch.inf)


def masked_logits(scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Top-k and top-p together from one descending sort (the reference's
    `_masked_logits`): a mask at max(top-k cutoff, top-p cutoff), the
    nucleus taken over the k-prefix. scaled [..., V]; top_k, top_p [...]."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = _row_value(sorted_desc, torch.clamp(top_k, 1, v) - 1)
    kth = torch.where(top_k > 0, kth, -torch.inf)
    n_k = (sorted_desc >= kth[..., None]).sum(dim=-1)            # k-prefix (ties incl.)
    pos = torch.arange(v, device=scaled.device)
    probs = _softmax(torch.where(pos < n_k[..., None], sorted_desc, -torch.inf))
    keep = (_row_cumsum(probs) - probs) < top_p[..., None]
    n_keep = torch.clamp_min(keep.sum(dim=-1), 1)
    p_cut = torch.where(top_p >= 1.0, -torch.inf, _row_value(sorted_desc, n_keep - 1))
    return torch.where(scaled >= torch.maximum(kth, p_cut)[..., None], scaled, -torch.inf)


def tempered(logits: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    """logits [B, ..., V] in f32 over each row's temperature (1 where 0)."""
    t = torch.where(temperature > 0, temperature, 1.0)
    return logits.to(torch.float32) / t.reshape(-1, *([1] * (logits.dim() - 1)))


def sample_tokens(logits: torch.Tensor, sampling: dict):
    """The step's epilogue: per-slot token draw + in-step termination.

    logits [B, V]; ``sampling`` the `slot_batch` rows: the host's choice of
    the branch reads numpy (`any_sampled`), the draw only the device rows,
    so the epilogue copies nothing from the host. Sampled rows draw
    ``categorical(fold_in(key, ngen), masked(logits / temperature))``,
    greedy rows of the same batch the exact argmax. Returns (next_token [B]
    int32, done [B] bool) on the logits' device."""
    rows = sampling["device"]
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    if any_sampled(sampling):
        keys = prng.fold_in(rows["key"], rows["ngen"])
        masked = masked_logits(tempered(logits, rows["temperature"]), rows["top_k"],
                               rows["top_p"])
        drawn = prng.categorical(keys, masked).to(torch.int32)
        next_token = torch.where(rows["temperature"] > 0, drawn, next_token)
    stop_hit = (next_token[:, None] == rows["stop_ids"]).any(dim=-1)
    return next_token, stop_hit | (rows["ngen"] + 1 >= rows["max_tokens"])
