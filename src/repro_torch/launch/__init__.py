"""Serving: scheduler, sampling, the engine step, the engine with its split
step, the async HTTP/SSE front end and the one-shot `serve.generate` (port of
src/repro/launch)."""
