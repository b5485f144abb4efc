"""Stable serving facade of the port: the supported import surface for users
(port of src/repro/serving.py).

    from repro_torch.serving import CacheConfig, EngineConfig, ServeEngine

    eng = ServeEngine(EngineConfig(cache=CacheConfig(kind="paged_ams")))
    handle = eng.submit(prompt_ids, max_tokens=64, priority=1)
    tokens = handle.result()            # or: async for t in handle.stream()

The names below are covered by the port's API tests
(tests/test_torch_frontend.py); internals under ``repro_torch.launch.*``
and ``repro_torch.cache.*`` may move, these names will not.
"""

from __future__ import annotations

from repro_torch.cache.config import CacheConfig
from repro_torch.launch.config import EngineConfig
from repro_torch.launch.engine import RequestHandle, ServeEngine
from repro_torch.launch.frontend import ServeFrontend, serve
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import Request, SpilledState
from repro_torch.obs import ObsConfig

__all__ = [
    "CacheConfig",
    "EngineConfig",
    "ObsConfig",
    "Request",
    "RequestHandle",
    "SamplingParams",
    "ServeEngine",
    "ServeFrontend",
    "SpilledState",
    "serve",
]
