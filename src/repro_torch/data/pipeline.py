"""Deterministic synthetic LM data pipeline (port of
src/repro/data/pipeline.py, numpy only: the port keeps its own copy, and
its batches are the reference's bit for bit).

Produces reproducible pseudo-text token streams with Zipfian unigram
statistics plus planted short-range structure (bigram copies), so a small
model trained on it shows a real, monotonically improving loss — enough for
the end-to-end training driver and the format-accuracy benchmark proxy.

The pipeline is sharded: each data-parallel host slice draws only its own
batch shard (host_id, num_hosts), with a seekable stateless index -> batch
mapping (step, shard) -> tokens, which is what makes checkpoint/restart and
elastic re-sharding exact: no iterator state to save beyond the step.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    copy_prob: float = 0.3     # planted structure: token repeats 8 back
    copy_dist: int = 8


class SyntheticLM:
    """Stateless, seekable synthetic corpus."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed Zipf-ish unigram distribution over the true vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self._p = (p / p.sum()).astype(np.float64)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Return (tokens, targets) for one step/shard: [B_loc, S] int32."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b_loc = cfg.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        toks = rng.choice(cfg.vocab_size, size=(b_loc, cfg.seq_len + 1),
                          p=self._p).astype(np.int32)
        # plant copy structure: with prob copy_prob, token t = token t-d
        d = cfg.copy_dist
        mask = rng.random((b_loc, cfg.seq_len + 1)) < cfg.copy_prob
        mask[:, :d] = False
        idx = np.arange(cfg.seq_len + 1)
        toks = np.where(mask, toks[:, idx - d], toks)
        return toks[:, :-1], toks[:, 1:]

    def iterate(self, start_step: int = 0, shard: int = 0,
                num_shards: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, shard, num_shards)
            step += 1


def prefix_embeds_stub(cfg_model, batch: int, seed: int = 0) -> Optional[np.ndarray]:
    """Deterministic frontend stub: precomputed frame/patch embeddings."""
    if not cfg_model.num_prefix_embeds:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, cfg_model.num_prefix_embeds, cfg_model.d_model)
    ).astype(np.float32)
