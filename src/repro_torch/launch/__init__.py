"""Serving: scheduler, greedy sampling epilogue, engine step, engine and the
one-shot `serve.generate` (port of src/repro/launch)."""
