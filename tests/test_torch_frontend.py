"""Port parity of the serving surface: the `repro_torch.serving` facade,
`RequestHandle` (``tokens_so_far``, ``result``, async ``stream``), the split
step (`step_begin` / `step_end`) and the async HTTP/SSE front end
(`repro_torch.launch.frontend`), against the JAX package's engine on the CPU.

Mirrors tests/test_engine_api.py (`TestRequestHandle`, `test_facade_exports`,
`TestFrontend`) on reduced qwen2-7b with FP5.33 weights over AMS-e2m2 pages,
the same numpy weights on both sides (`models.convert.params_from_numpy`).
Token streams are compared exactly; the port's kernel impls on CPU tensors
run their plain versions and match the JAX engine's ``fused_ref`` matmuls
(as tests/test_torch_sampling.py pins).
"""

import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.cache import CacheConfig as JCacheConfig  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import sampling as JS  # noqa: E402
from repro.launch.config import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ObsConfig,
    RequestHandle,
    SamplingParams,
    ServeEngine,
    ServeFrontend,
)

PAGE, CAP = 8, 48
PROMPT = list(range(1, 11))


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), get_config("qwen2-7b").reduced())


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree.map(np.asarray, jax_params)


def port_engine(np_params, **kw):
    base = dict(arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl="kernel", slots=2,
                capacity=CAP, device="cpu",
                cache=CacheConfig(kind="paged_ams", page_size=PAGE, impl="kernel"))
    base.update(kw)
    return ServeEngine(EngineConfig(**base), params=params_from_numpy(np_params))


def jax_result(jax_params, prompt, max_tokens, sampling=None, **kw):
    eng = JServeEngine(JEngineConfig(
        arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3", impl="fused_ref", slots=2,
        capacity=CAP, cache=JCacheConfig(kind="paged_ams", page_size=PAGE), **kw),
        params=jax_params)
    return eng.submit(np.asarray(prompt, np.int32), max_tokens=max_tokens,
                      sampling=sampling).result()


# =============================================================== RequestHandle
class TestRequestHandle:
    def test_lifecycle_matches_trace_spans(self, np_params):
        """`.status` walks queued -> prefill -> decode -> finished, the
        request's trace spans in the same order."""
        from repro_torch.obs.trace import validate_events
        eng = port_engine(np_params, slots=1, obs=ObsConfig(trace=True))
        h1 = eng.submit(np.arange(1, 10, dtype=np.int32), max_tokens=4)
        h2 = eng.submit(np.arange(2, 11, dtype=np.int32), max_tokens=4)
        assert (h1.status, h2.status) == ("queued", "queued")
        seen = {h1.status, h2.status}
        while eng.has_work:
            eng.step()
            seen.update((h1.status, h2.status))
        assert h1.status == h2.status == "finished"
        assert seen == {"queued", "prefill", "decode", "finished"}
        spans = validate_events(eng.trace.events())
        for h in (h1, h2):
            assert [n for n, _, _, _ in spans[h.request.rid + 1]] == [
                "queued", "prefill", "decode", "request"]

    def test_result_and_tokens_so_far(self, np_params, jax_params):
        eng = port_engine(np_params)
        h = eng.submit(np.arange(1, 8, dtype=np.int32), max_tokens=5)
        assert isinstance(h, RequestHandle)
        assert h.tokens_so_far() == [] and not h.done
        out = h.result()                  # drives the engine itself (no driver)
        assert out == jax_result(jax_params, np.arange(1, 8), 5)
        assert h.done and h.tokens_so_far() == out
        assert h.request.finish_reason in ("stop", "length")

    def test_async_stream_yields_every_token(self, np_params, jax_params):
        h = port_engine(np_params).submit(np.arange(1, 8, dtype=np.int32), max_tokens=5)

        async def collect():
            return [t async for t in h.stream()]

        assert asyncio.run(collect()) == jax_result(jax_params, np.arange(1, 8), 5)

    def test_seeded_sampling_replays(self, np_params, jax_params):
        kw = dict(temperature=0.8, top_k=16, seed=7)
        outs = [port_engine(np_params).submit(np.arange(1, 9, dtype=np.int32), max_tokens=6,
                                              sampling=SamplingParams(**kw)).result()
                for _ in range(2)]
        assert outs[0] == outs[1] == jax_result(jax_params, np.arange(1, 9), 6,
                                                JS.SamplingParams(**kw))

    def test_result_waits_on_the_tick_signal_under_a_driver(self, np_params):
        """With ``driver_active`` another thread owns the stepping: result()
        waits on the tick signal and never steps the engine itself."""
        import threading
        eng = port_engine(np_params)
        want = port_engine(np_params).submit(np.arange(1, 8, dtype=np.int32), 5).result()
        h = eng.submit(np.arange(1, 8, dtype=np.int32), max_tokens=5)
        stepped = []
        eng.driver_active = True

        def drive():
            while eng.has_work:
                stepped.append(eng.step_end(eng.step_begin()))
            eng.driver_active = False

        t = threading.Thread(target=drive)
        t.start()
        assert h.result() == want
        t.join()
        assert len(stepped) == eng.tick


# ====================================================================== facade
def test_facade_exports():
    import repro.serving as jserving
    import repro_torch.serving as serving
    assert serving.__all__ == jserving.__all__
    for name in serving.__all__:
        assert getattr(serving, name) is not None
    # the facade re-exports the same objects, not copies
    from repro_torch.launch.engine import ServeEngine as inner
    from repro_torch.launch.frontend import ServeFrontend as inner_fe
    assert serving.ServeEngine is inner and serving.ServeFrontend is inner_fe


# ================================================================== split step
def _cache_bytes(eng):
    return [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]


@pytest.mark.parametrize("feature", ["greedy", "sampled", "speculative"])
def test_split_step_is_bit_equal_to_step(np_params, feature):
    """Two engines serve the same requests in lockstep, one through
    ``step()``, one through ``step_end(step_begin())`` (prefill, decode,
    sampled and speculative ticks, and idle ones): tick results, tokens,
    stats and every cache byte equal."""
    kw = dict(prefill_chunk=4)
    if feature == "speculative":
        kw["speculate_k"] = 3
    a, b = port_engine(np_params, **kw), port_engine(np_params, **kw)
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(1, 512, 4), 4).astype(np.int32) for _ in range(3)]
    samp = [SamplingParams(temperature=0.9, top_k=20, seed=i) if feature == "sampled" and i != 1
            else None for i in range(3)]
    for eng in (a, b):
        for p, sp in zip(prompts, samp):
            eng.submit(p, 9, sampling=sp)
    for _ in range(60):
        ra, rb = a.step(), b.step_end(b.step_begin())
        assert ([r.rid for r in ra["finished"]], ra["generated"], ra["active"]) == \
            ([r.rid for r in rb["finished"]], rb["generated"], rb["active"])
        assert [r and r.tokens for r in a.active] == [r and r.tokens for r in b.active]
    assert not a.has_work and a.tick == b.tick
    assert [r.tokens for r in a.finished] == [r.tokens for r in b.finished]
    assert all(torch.equal(x, y) for x, y in zip(_cache_bytes(a), _cache_bytes(b)))
    sa, sb = a.stats(), b.stats()
    sa.pop("tokens_per_s"), sb.pop("tokens_per_s")
    for k in ("decode_ms_median", "decode_ms_p99"):
        sa.pop(k), sb.pop(k)
    assert sa == sb
    if feature == "speculative":
        assert sa["spec_proposed"] > 0


def test_second_step_begin_raises(np_params):
    eng = port_engine(np_params)
    with pytest.raises(RuntimeError, match="no step in flight"):
        eng.step_end()
    eng.submit(np.arange(1, 6, dtype=np.int32), 3)
    pending = eng.step_begin()
    with pytest.raises(RuntimeError, match="already in flight"):
        eng.step_begin()
    eng.step_end(pending)
    eng.run()
    assert eng.finished[0].n_generated == 3


def test_reset_metrics_keeps_requests_and_cache(np_params):
    eng = port_engine(np_params)
    h = eng.submit(np.arange(1, 9, dtype=np.int32), 6)
    for _ in range(4):
        eng.step()
    eng.reset_metrics()
    st = eng.stats()
    assert st["ticks"] == 0 and st["tokens_generated"] == 0 and st["floor_hbm_bytes"] == 0
    h.result()
    assert h.done and eng.stats()["requests_finished"] == 1


# ==================================================================== frontend
class TestFrontend:
    @pytest.fixture()
    def served(self, np_params):
        eng = port_engine(np_params, max_queue=4)
        fe = ServeFrontend(eng)
        loop = asyncio.new_event_loop()
        loop.run_until_complete(fe.start())
        yield fe, loop
        loop.run_until_complete(fe.stop())
        loop.close()

    def _roundtrip(self, fe, loop, method, path, payload=None):
        async def go():
            r, w = await asyncio.open_connection("127.0.0.1", fe.port)
            body = json.dumps(payload).encode() if payload is not None else b""
            w.write(f"{method} {path} HTTP/1.1\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await w.drain()
            raw = (await r.read()).decode()
            w.close()
            return raw
        return loop.run_until_complete(go())

    def test_generate_matches_the_jax_engine(self, served, jax_params):
        fe, loop = served
        raw = self._roundtrip(fe, loop, "POST", "/v1/generate",
                              {"prompt": PROMPT, "max_tokens": 6})
        head, _, payload = raw.partition("\r\n\r\n")
        assert "200 OK" in head
        assert json.loads(payload)["tokens"] == jax_result(jax_params, PROMPT, 6)
        assert fe.driver_ticks > 0

    def test_sse_stream_matches_the_jax_engine(self, served, jax_params):
        fe, loop = served
        raw = self._roundtrip(fe, loop, "POST", "/v1/generate",
                              {"prompt": PROMPT, "max_tokens": 6, "stream": True,
                               "temperature": 0.8, "top_k": 16, "seed": 5})
        assert "text/event-stream" in raw and "event: done" in raw
        toks = [json.loads(ln[6:])["token"] for ln in raw.splitlines()
                if ln.startswith("data: {\"token\"")]
        assert toks == jax_result(jax_params, PROMPT, 6,
                                  JS.SamplingParams(temperature=0.8, top_k=16, seed=5))

    def test_healthz_metrics_and_errors(self, served):
        fe, loop = served
        assert '"ok": true' in self._roundtrip(fe, loop, "GET", "/healthz")
        m = self._roundtrip(fe, loop, "GET", "/metrics")
        assert "serve_requests_finished_total" in m and "serve_floor_hbm_bytes_total" in m
        assert "400" in self._roundtrip(fe, loop, "POST", "/v1/generate",
                                        {"prompt": "not-token-ids"})
        assert "404" in self._roundtrip(fe, loop, "GET", "/nope")
        assert "405" in self._roundtrip(fe, loop, "GET", "/v1/generate")

    def test_queue_full_returns_429(self, served):
        fe, loop = served

        async def burst():
            async def one(i):
                r, w = await asyncio.open_connection("127.0.0.1", fe.port)
                body = json.dumps({"prompt": [1 + i, 2, 3], "max_tokens": 8}).encode()
                w.write(b"POST /v1/generate HTTP/1.1\r\n"
                        b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
                await w.drain()
                raw = (await r.read()).decode()
                w.close()
                return raw
            return await asyncio.gather(*[one(i) for i in range(12)])

        results = loop.run_until_complete(burst())
        codes = [r.split(" ", 2)[1] for r in results]
        # max_queue=4 + 2 slots: the burst sheds load with 429s and serves
        # every accepted request to completion
        assert codes.count("429") >= 1
        assert codes.count("200") >= 4
        assert codes.count("200") + codes.count("429") == len(codes)
        for r in results:
            if r.startswith("HTTP/1.1 200"):
                assert len(json.loads(r.partition("\r\n\r\n")[2])["tokens"]) == 8
