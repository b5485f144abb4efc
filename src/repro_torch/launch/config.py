"""EngineConfig: the constructor surface of the serving engine (port of
src/repro/launch/config.py).

One frozen dataclass carries every constructor-time validation, so a bad
config fails in one place before any device work. The port adds
``device`` (default ``"cuda"``) and serves contiguous caches (the default,
``cache=None``; GQA, MoE-GQA and MLA) and paged caches (AMS or bf16
pages; GQA and MoE-GQA), with seeded sampling, priorities and preemption
with host spill (paged caches), and speculative decoding with the n-gram
or the self drafters, and tensor-parallel serving over a (1, tp) mesh
(`launch.mesh.make_serving_mesh`: every served layer kind, over
head-sharded page pools or sequence-sharded contiguous caches; every rank
builds the same config and submits the same requests in the same order).
Other meshes raise NotImplementedError here, naming their ROADMAP item.

    cfg = EngineConfig(arch="qwen2-7b", reduced=False, impl="kernel",
                       slots=8, capacity=1024, prefill_chunk=16,
                       cache=CacheConfig(kind="contiguous", impl="kernel"))
    eng = ServeEngine(cfg)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.cache import CacheConfig
from repro_torch.obs import ObsConfig

IMPLS = ("ref", "fused_ref", "kernel")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything a `ServeEngine` needs, in one frozen value.

    arch / reduced / scheme / strategy / seed   model and weights
    depth         serve only the first ``depth`` layers of the arch at full
                  width (None = all); smoke runs cut depth this way
    impl          packed-matmul lowering: ref | fused_ref | kernel (K1 for
                  fp5.33, K1b for the other schemes; "fp16" weights stay
                  bf16 and multiply with torch.matmul)
    slots / capacity / max_queue / prefill_chunk / token_budget
                  as in the reference's EngineConfig
    cache         `CacheConfig(kind="contiguous" | "paged_ams" | "paged_bf16",
                  ...)`; None = the contiguous default. Its ``impl``
                  selects the attention lowering: ref | kernel (K4 for a
                  contiguous GQA cache, K5 for the MLA stream, K2 for AMS
                  pages, K3 for bf16 pages)
    obs           `ObsConfig` telemetry switchboard
    device        "cuda" (default) or "cpu"; "cuda" without a card raises
    speculate_k   score up to k draft tokens per decode round (0 = off)
    drafter       "ngram", "self", "self-full" or a `speculative.Drafter`; a
                  name is checked here and the drafter built by the engine
                  (the self drafters from its own params)
    mesh          None (one device) or a (1, tp) `launch.mesh.Mesh` from
                  ``make_serving_mesh(tp)`` built on every rank: weights
                  N-sharded, page pools head-sharded, contiguous caches
                  sequence-sharded (capacity, window and inner widths must
                  divide by tp), Mamba / RG-LRU states on the rank's inner
                  width, expert-parallel MoE at decode; at tp > 1 the step
                  runs eagerly (no CUDA graphs), and the self drafters raise
                  NotImplementedError
    """

    arch: str = "qwen2-7b"
    reduced: bool = True
    depth: Optional[int] = None
    scheme: str = "fp5.33-e2m3"
    strategy: str = "set_lsb"
    impl: str = "ref"
    seed: int = 0

    slots: int = 4
    capacity: int = 128
    max_queue: Optional[int] = None
    prefill_chunk: int = 1
    token_budget: Optional[int] = None
    preempt: bool = True

    cache: Optional[CacheConfig] = None
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    mesh: Any = None
    speculate_k: int = 0
    drafter: Any = "ngram"
    device: str = "cuda"

    verbose: bool = False

    def __post_init__(self):
        from repro_torch.configs import get_config, list_archs
        try:
            get_config(self.arch)
        except KeyError:
            raise ValueError(f"unknown arch {self.arch!r}; one of "
                             f"{list_archs(assigned_only=False)}") from None
        if self.depth is not None and self.depth < 1:
            raise ValueError(f"depth must be >= 1 (or None), got {self.depth}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; one of {IMPLS}")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.token_budget is not None and self.token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {self.token_budget}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (or None), got {self.max_queue}")
        if self.device not in ("cuda", "cpu") and not self.device.startswith("cuda:"):
            raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu', got {self.device!r}")
        if self.cache is not None and not isinstance(self.cache, CacheConfig):
            raise TypeError(f"cache must be a CacheConfig, got {type(self.cache).__name__}")
        if not isinstance(self.obs, ObsConfig):
            raise TypeError(f"obs must be an ObsConfig, got {type(self.obs).__name__}")
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {self.speculate_k}")
        if self.speculate_k and isinstance(self.drafter, str):
            from .speculative import DRAFTERS
            if self.drafter not in DRAFTERS:
                raise ValueError(f"unknown drafter {self.drafter!r} (expected one of "
                                 f"{DRAFTERS})")
        if self.mesh is not None:
            self._check_mesh()

    def _check_mesh(self):
        from .mesh import Mesh
        if not isinstance(self.mesh, Mesh):
            raise NotImplementedError(
                f"only the (1, tp) serving meshes of launch.mesh.make_serving_mesh are ported; "
                f"other meshes ({type(self.mesh).__name__}) are not (ROADMAP.md, Modules to "
                "port)")
        if "model" not in self.mesh.axis_names:
            raise ValueError("ServeEngine mesh needs a 'model' axis")
        if any(n > 1 for a, n in self.mesh.shape.items() if a != "model"):
            raise NotImplementedError(f"mesh {self.mesh.shape}: data axes > 1 are not ported "
                                      "yet (ROADMAP.md, Modules to port)")
        if self.tp == 1:
            return
        if torch.device(self.device).type != self.mesh.device.type:
            raise ValueError(f"device {self.device!r} but the mesh's rank runs on "
                             f"{self.mesh.device}")
        from repro_torch.models.transformer import check_tp_support
        check_tp_support(self.model_config(), self.sized_cache(), self.tp, self.capacity)
        if self.speculate_k and isinstance(self.drafter, str) and self.drafter != "ngram":
            raise NotImplementedError(f"the {self.drafter!r} drafter runs the sequence forward "
                                      "on sharded weights, which is not ported yet (ROADMAP.md, "
                                      "Modules to port)")

    @property
    def tp(self) -> int:
        """The model axis's size (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.shape["model"]

    @property
    def step_chunk(self) -> int:
        """Token-buffer width of the step: the prefill chunk, widened to hold
        1 fed token + k drafts per slot when speculating."""
        if self.speculate_k:
            return max(self.prefill_chunk, self.speculate_k + 1)
        return self.prefill_chunk

    @property
    def resolved_token_budget(self) -> int:
        """The per-tick token budget enforced (default: every slot can fill
        its chunk)."""
        if self.token_budget is not None:
            return self.token_budget
        return self.slots * self.step_chunk

    def model_config(self):
        """The served ModelConfig: the arch, reduced and/or cut in depth."""
        from repro_torch.configs import get_config
        cfg = get_config(self.arch)
        if self.reduced:
            cfg = cfg.reduced()
        if self.depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=min(self.depth, cfg.num_layers))
        return cfg

    def sized_cache(self) -> CacheConfig:
        """The composed CacheConfig (or the contiguous default), with pool
        sizes derived from (slots, capacity) for paged kinds."""
        ccfg = self.cache if self.cache is not None else CacheConfig()
        return ccfg.sized(capacity=self.capacity, slots=self.slots) if ccfg.paged else ccfg
