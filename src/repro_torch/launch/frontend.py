"""Async serving front end: stdlib-only HTTP/1.1 + SSE over the engine (port
of src/repro/launch/frontend.py).

One asyncio event loop owns both sides of the server:

  * connection handlers parse requests and enqueue work through
    ``ServeEngine.submit`` (token-id prompts in, token streams out; host
    work only), and
  * a driver task ticks the engine through the split step on one dedicated
    worker thread: ``step_begin`` stages tick t and launches it (on the card
    a CUDA-graph replay and the output block's copy, without a sync), the
    driver yields once to the loop, then ``step_end`` waits for the output
    and does the bookkeeping. While the device computes tick t the loop
    serves HTTP reads, SSE writes and new submissions, so tick t+1's work
    is queued before t's same-tick re-admit runs.

Every CUDA call stays on that worker thread: it captures every graph the
engine replays (`ServeEngine.capture_graphs`) before the listener opens, so
no capture ever runs beside a handler.

Endpoints
---------
  POST /v1/generate   {"prompt": [ids], "max_tokens": n, "priority": p,
                       "temperature"/"top_k"/"top_p"/"seed"/"stop": ...,
                       "stream": false}
                      -> JSON {"tokens": [...], "finish_reason": ...}
                      stream=true -> SSE, one data: event per token
  GET  /healthz       -> {"ok": true, "tick": ..., "active": ...}
  GET  /metrics       -> Prometheus text exposition (repro_torch.obs.metrics)

A full queue answers 429, so open-loop load generators see backpressure.

    PYTHONPATH=src python -m repro_torch.launch.frontend --reduced --port 8080 \\
        [--impl kernel] [--device cpu]
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
from typing import Dict, Optional, Tuple

import numpy as np

from .sampling import SamplingParams

_MAX_HEADER = 64 * 1024
_MAX_BODY = 8 * 1024 * 1024


def _http(status: int, body: bytes, ctype: str = "application/json") -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
              429: "Too Many Requests", 500: "Internal Server Error"}.get(status, "OK")
    return (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


def _json_body(status: int, obj) -> bytes:
    return _http(status, json.dumps(obj).encode())


class ServeFrontend:
    """Async HTTP front end over one `ServeEngine`.

    The front end owns the engine's driver loop for its lifetime: it sets
    ``eng.driver_active`` so `RequestHandle` waiters (``result`` /
    ``stream``) park on the tick condition instead of stepping the engine,
    and every engine mutation stays serialised (submit is a locked
    host-side enqueue; the step halves and the graph captures run one at a
    time on one worker thread). ``driver_host_s`` sums the host seconds
    between each ``step_begin``'s return and its ``step_end``'s start (the
    window the loop serves HTTP in), over ``driver_ticks`` ticks.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 idle_poll_s: float = 0.02):
        if getattr(engine, "tp", 1) > 1:
            raise NotImplementedError(
                "the front end over a tensor-parallel engine (every rank must see the same "
                "submissions in the same order) is not ported yet (ROADMAP.md, Modules to port)")
        self.eng = engine
        self.host = host
        self.port = port              # 0 = ephemeral; the real port after start()
        self.idle_poll_s = idle_poll_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._driver_task: Optional[asyncio.Task] = None
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._work = asyncio.Event()
        self._running = False
        self.driver_ticks = 0
        self.driver_host_s = 0.0

    # --------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        """Capture the engine's graphs on the stepping thread, then bind the
        listener and start the driver task."""
        self._running = True
        # one dedicated thread: handler-side to_thread() calls (result()
        # waiters) can fill the default pool, and the driver must never
        # queue behind the waiters it unblocks
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-step")
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._pool, self.eng.capture_graphs)
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._driver_task = asyncio.create_task(self._driver())

    async def stop(self) -> None:
        self._running = False
        self._work.set()
        if self._driver_task is not None:
            await self._driver_task
            self._driver_task = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    async def serve_forever(self) -> None:
        await self.start()
        try:
            async with self._server:
                await self._server.serve_forever()
        finally:
            await self.stop()

    # ------------------------------------------------------------------ driver
    async def _driver(self) -> None:
        """Tick the engine whenever it has work, through the split step; the
        yield between the halves is where tick t+1's HTTP traffic overlaps
        tick t's device compute."""
        eng = self.eng
        eng.driver_active = True
        loop = asyncio.get_running_loop()
        try:
            while self._running:
                if not eng.has_work:
                    self._work.clear()
                    if not eng.has_work:      # re-check after clear: no lost wakeup
                        try:
                            await asyncio.wait_for(self._work.wait(), timeout=self.idle_poll_s)
                        except asyncio.TimeoutError:
                            pass
                        continue
                pending = await loop.run_in_executor(self._pool, eng.step_begin)
                t0 = loop.time()
                await asyncio.sleep(0)
                if not pending.idle:
                    self.driver_host_s += loop.time() - t0
                    self.driver_ticks += 1
                await loop.run_in_executor(self._pool, eng.step_end, pending)
        finally:
            eng.driver_active = False

    # -------------------------------------------------------------------- http
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            method, path, body = await self._read_request(reader)
            if method is None:
                return
            await self._route(method, path, body, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception as e:          # surface handler faults to the client
            try:
                writer.write(_json_body(500, {"error": repr(e)}))
                await writer.drain()
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader) -> Tuple[Optional[str], str, bytes]:
        head = await reader.readuntil(b"\r\n\r\n")
        if len(head) > _MAX_HEADER:
            return None, "", b""
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, path, _ = lines[0].split(" ", 2)
        except ValueError:
            return None, "", b""
        clen = 0
        for ln in lines[1:]:
            if ln.lower().startswith("content-length:"):
                clen = int(ln.split(":", 1)[1].strip())
        if clen > _MAX_BODY:
            return None, "", b""
        body = await reader.readexactly(clen) if clen else b""
        return method, path, body

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        eng = self.eng
        if path == "/healthz" and method == "GET":
            writer.write(_json_body(200, {"ok": True, "tick": eng.tick,
                                          "active": eng.active_count,
                                          "queue_depth": eng.sched.queue_depth}))
        elif path == "/metrics" and method == "GET":
            writer.write(_http(200, eng.metrics.exposition().encode(),
                               ctype="text/plain; version=0.0.4"))
        elif path == "/v1/generate":
            if method != "POST":
                writer.write(_json_body(405, {"error": "POST only"}))
            else:
                await self._generate(body, writer)
                return
        else:
            writer.write(_json_body(404, {"error": f"no route {path}"}))
        await writer.drain()

    # ---------------------------------------------------------------- generate
    def _parse_generate(self, body: bytes):
        req = json.loads(body.decode())
        prompt = req.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError("'prompt' must be a non-empty list of token ids")
        kw: Dict[str, object] = {}
        for k in ("temperature", "top_k", "top_p", "seed"):
            if k in req:
                kw[k] = req[k]
        if "stop" in req:
            kw["stop_token_ids"] = tuple(req["stop"])
        sampling = SamplingParams(**kw)
        return (np.asarray(prompt, np.int32), int(req.get("max_tokens", 16)),
                int(req.get("priority", 0)), bool(req.get("stream", False)), sampling)

    async def _generate(self, body: bytes, writer: asyncio.StreamWriter) -> None:
        eng = self.eng
        try:
            prompt, max_tokens, priority, stream, sampling = self._parse_generate(body)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            writer.write(_json_body(400, {"error": str(e)}))
            await writer.drain()
            return
        try:
            handle = eng.submit(prompt, max_tokens=max_tokens, sampling=sampling,
                                priority=priority)
        except RuntimeError as e:       # admission backpressure: queue full
            writer.write(_json_body(429, {"error": str(e)}))
            await writer.drain()
            self._work.set()
            return
        self._work.set()                # wake the driver for the new request
        if not stream:
            tokens = await asyncio.to_thread(handle.result)
            writer.write(_json_body(200, {
                "rid": handle.request.rid, "tokens": tokens,
                "finish_reason": handle.request.finish_reason,
                "preemptions": handle.request.preemptions}))
            await writer.drain()
            return
        # SSE: one event per generated token, then a done event with the
        # finish reason
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        i = 0
        async for tok in handle.stream():
            writer.write(f"data: {json.dumps({'token': tok, 'index': i})}\n\n".encode())
            await writer.drain()
            i += 1
        done = {"finish_reason": handle.request.finish_reason,
                "n_tokens": len(handle.request.tokens),
                "preemptions": handle.request.preemptions}
        writer.write(f"event: done\ndata: {json.dumps(done)}\n\n".encode())
        await writer.drain()


def serve(config, host: str = "127.0.0.1", port: int = 8000, params=None) -> None:
    """Blocking entry point: build the engine from an `EngineConfig` and
    serve until interrupted."""
    from .engine import ServeEngine
    eng = ServeEngine(config, params=params)
    asyncio.run(ServeFrontend(eng, host=host, port=port).serve_forever())


def main(argv=None) -> None:
    import argparse

    from repro_torch.cache import CacheConfig

    from .config import EngineConfig

    ap = argparse.ArgumentParser(description="HTTP/SSE serving front end over the engine")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scheme", default="fp5.33-e2m3")
    ap.add_argument("--impl", default="ref",
                    help="ref | fused_ref | kernel (kernel: K1 / K1b and the attention kernels)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--cache", default="paged_ams",
                    choices=["contiguous", "paged_bf16", "paged_ams"])
    ap.add_argument("--host-spill-pages", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    attn = "kernel" if a.impl == "kernel" else "ref"
    cache = CacheConfig(kind=a.cache, page_size=a.page_size, impl=attn,
                        host_spill_pages=a.host_spill_pages if a.cache != "contiguous" else 0)
    serve(EngineConfig(arch=a.arch, reduced=a.reduced, scheme=a.scheme, impl=a.impl,
                       slots=a.slots, capacity=a.capacity, prefill_chunk=a.chunk,
                       max_queue=a.max_queue, cache=cache, device=a.device, verbose=True),
          host=a.host, port=a.port)


if __name__ == "__main__":
    main()
