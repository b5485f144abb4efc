"""One-shot batched generation through the engine (port of
src/repro/launch/serve.py).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --reduced --impl kernel --attn-impl kernel --tokens 32 --device cuda

The cache is the contiguous default, as in the reference; ``--cache paged``
serves paged caches instead (bf16 pages for ``--scheme fp16``, AMS pages for
the quantized schemes). ``--temperature`` > 0 samples on the device, seeded
by ``--sample-seed`` (with ``--top-k`` / ``--top-p``); ``--speculate K``
scores up to K drafts per decode round (``--drafter ngram | self |
self-full``). A config with a modality front end (``--arch internvl2-1b``)
gets seeded standard-normal prefix embeddings for every request.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.cache import CacheConfig
from repro_torch.configs import get_config

from .config import EngineConfig
from .engine import ServeEngine
from .sampling import SamplingParams


def generate(arch: str, *, reduced=True, scheme="fp5.33-e2m3", strategy="set_lsb",
             impl="ref", attn_impl="ref", batch=2, prompt_len=16, gen_tokens=16, seed=0,
             params=None, capacity=None, prompts=None, sampling=None, prefill_chunk=1,
             cache="contiguous", page_size=16, device="cuda", speculate_k=0, drafter="ngram",
             prefix_embeds=None):
    """Submit ``batch`` requests at tick 0 (prompts drawn from ``seed`` unless
    given as ``prompts`` [batch, prompt_len]) and drain the engine. The
    cache is contiguous by default, as in the reference's ``generate``;
    ``cache="paged"`` pairs bf16 pages with ``scheme="fp16"`` and AMS pages
    with the quantized schemes, as the reference's serving benchmark pairs
    them. ``attn_impl`` selects the attention lowering (ref | kernel);
    ``speculate_k`` / ``drafter`` turn on speculative decoding. A config
    with ``num_prefix_embeds`` > 0 takes ``prefix_embeds`` [batch, n,
    d_model], drawn standard-normal from ``seed`` (after the prompts) when
    not given, and its capacity holds them.
    Returns (tokens [batch, gen_tokens], stats); streams that stop early are
    padded with -1."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    prompts = np.asarray(prompts, np.int32)
    batch, prompt_len = prompts.shape
    cap = capacity or (prompt_len + gen_tokens + cfg.num_prefix_embeds)
    if cfg.num_prefix_embeds and prefix_embeds is None:
        prefix_embeds = rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cache == "contiguous":
        ccfg = CacheConfig(kind="contiguous", impl=attn_impl)
    elif cache == "paged":
        ccfg = CacheConfig(kind="paged_bf16" if scheme == "fp16" else "paged_ams",
                           page_size=page_size, impl=attn_impl)
    else:
        raise ValueError(f"cache must be 'contiguous' or 'paged', got {cache!r}")
    eng = ServeEngine(
        EngineConfig(arch=arch, reduced=reduced, scheme=scheme, strategy=strategy,
                     impl=impl, slots=batch, capacity=cap, seed=seed,
                     prefill_chunk=prefill_chunk, device=device, verbose=True, cache=ccfg,
                     speculate_k=speculate_k, drafter=drafter),
        params=params)
    per_req = sampling if isinstance(sampling, (list, tuple)) else [sampling] * batch
    reqs = [eng.submit(prompts[b], gen_tokens, sampling=per_req[b],
                       prefix_embeds=None if prefix_embeds is None else prefix_embeds[b])
            for b in range(batch)]
    stats = eng.run()
    width = max(r.n_generated for r in reqs)
    toks = np.full((len(reqs), width), -1, np.int32)
    for b, r in enumerate(reqs):
        toks[b, :r.n_generated] = r.tokens
    return toks, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--scheme", default="fp5.33-e2m3")
    ap.add_argument("--strategy", default="set_lsb")
    ap.add_argument("--impl", default="ref", help="matmul: ref | fused_ref | kernel")
    ap.add_argument("--attn-impl", default="ref", help="attention: ref | kernel")
    ap.add_argument("--cache", default="contiguous", choices=("contiguous", "paged"),
                    help="KV cache: contiguous (default) or paged (AMS pages; bf16 "
                         "pages for --scheme fp16)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=1, help="prefill chunk")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default); > 0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--speculate", type=int, default=0,
                    help="score up to K draft tokens per decode round (0 = off)")
    ap.add_argument("--drafter", default="ngram", help="ngram | self | self-full")
    args = ap.parse_args()
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                  top_p=args.top_p, seed=args.sample_seed)
    toks, stats = generate(args.arch, reduced=args.reduced, scheme=args.scheme,
                           strategy=args.strategy, impl=args.impl, attn_impl=args.attn_impl,
                           batch=args.batch, prompt_len=args.prompt, gen_tokens=args.tokens,
                           prefill_chunk=args.chunk, cache=args.cache, device=args.device,
                           sampling=sampling, speculate_k=args.speculate,
                           drafter=args.drafter)
    print("generated tokens:\n", toks)
    print("stats:", stats)


if __name__ == "__main__":
    main()
