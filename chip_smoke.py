#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with the card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from src/repro_torch/kernels/csrc with nvcc
     (one process per source, started together);
  3. K1 (AMS fp533 dequant-matmul) against its plain torch version at every
     Qwen2-7B projection shape, B in {8, 128}: error, kernel / plain / dense
     bf16 torch.matmul times, and the bound from bytes and operations;
  4. K2 (paged AMS-e2m2 flash-decode) against its plain version at kv=4,
     g=7, hd=128, page 16, 8 slots, lengths up to 1024, chunk in {1, 16},
     with an idle slot and masked rows that must come out exactly 0;
  5. the main path: full-width 28-layer Qwen2-7B, FP5.33 weights, paged
     AMS-e2m2 KV, impl "kernel" for matmuls and attention, serving 10
     greedy requests (two share a page-aligned prefix) through the
     continuous-batching engine; launch counts are zeroed just before and
     read just after, and every kernel must have launched;
  6. consistency at cut depth (2 layers, full widths): first-tick logits and
     greedy streams of impl "kernel" against the non-kernel impls
     ("fused_ref" matmuls, "ref" attention) on the same card.

The line before the last is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card the script
exits non-zero and prints no result (``--cpu-rehearsal`` runs the phases on
the CPU at tiny sizes with the plain versions, skips timing, and also exits
non-zero).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
L2_FLUSH_BYTES = 256 << 20      # rotate operand copies past the 50 MB L2

K1_TOL = 1e-4                   # max |kernel - plain| / max |plain|: f32 order
K2_TOL = 1e-4                   # same, K2
LOGIT_TOL = 5e-2                # consistency: max |dlogit| / max |logit|


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def time_graph(torch, fns, reps: int = 5) -> float:
    """Device ms per call of ``fns`` (a list of launches, each on its own
    operand copy), captured once in a CUDA graph and replayed, so host
    overhead is not timed."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for f in fns:           # warm-up outside capture
            f()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for f in fns:
            f()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * len(fns))


def time_loop(torch, fn, iters: int = 5) -> float:
    """ms per call of ``fn`` with CUDA events around a host loop (plain
    versions: their host work is part of what they cost)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


# --------------------------------------------------------------------- K1
def phase_k1(torch, dev, timed: bool, full: bool):
    from repro_torch.core.ams import ams_quantize
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.packing import pack
    from repro_torch.kernels.ams_matmul import ams_matmul_fp533, ams_matmul_fp533_plain

    scheme = get_scheme("fp5.33-e2m3")
    if full:
        shapes = [("wq/wo", 3584, 3584, 2), ("wk/wv", 3584, 512, 2),
                  ("w_gate/w_up", 3584, 18944, 2), ("w_down", 18944, 3584, 1)]
        batches = (8, 8 * 16)
    else:
        shapes = [("wq/wo", 128, 128, 2), ("wk/wv", 128, 64, 2),
                  ("w_gate/w_up", 128, 256, 2), ("w_down", 256, 128, 1)]
        batches = (2, 2 * 4)
    gen = torch.Generator(device=dev).manual_seed(11)
    rows, max_err = [], 0.0
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "flops": 0.0,
             "dense_ms": 0.0}
    for K, N, hi, scale, wd, name, mult in _k1_weights(torch, dev, gen, scheme, shapes,
                                                       ams_quantize, pack):
        Kp = hi.shape[0] * 6
        for B in batches:
            x = torch.zeros((B, Kp), dtype=torch.bfloat16, device=dev)
            x[:, :K] = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
            y_k = ams_matmul_fp533(x, hi, scale)
            y_p = ams_matmul_fp533_plain(x, hi, scale)
            err = float((y_k - y_p).abs().max())
            rel = err / max(float(y_p.abs().max()), 1e-30)
            max_err = max(max_err, err)
            if not (rel <= K1_TOL and torch.isfinite(y_k).all()):
                fail(f"K1 {name} K={K} N={N} B={B}: max abs err {err:.3e} "
                     f"(rel {rel:.3e} > {K1_TOL})")
            nbytes = B * Kp * 2 + hi.numel() * 4 + N * 4 + B * N * 4
            flops = 2.0 * B * K * N
            bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            row = dict(shape=name, K=K, N=N, B=B, max_abs_err=err, rel_err=rel,
                       bound_ms=bms, bound_by=by)
            if timed:
                n = max(1, min(256, math.ceil(L2_FLUSH_BYTES / (hi.numel() * 4))))
                his = [hi.clone() for _ in range(n)]
                wds = [wd.clone() for _ in range(max(1, min(64, math.ceil(
                    L2_FLUSH_BYTES / (wd.numel() * 2)))))]
                outs = []
                row["ms"] = time_graph(torch, [
                    (lambda h=h: outs.append(ams_matmul_fp533(x, h, scale))) for h in his])
                outs.clear()
                row["plain_ms"] = time_loop(torch, lambda: ams_matmul_fp533_plain(x, hi, scale))
                xk = x[:, :K].contiguous()
                row["dense_bf16_ms"] = time_graph(torch, [
                    (lambda w=w: outs.append(torch.matmul(xk, w))) for w in wds])
                outs.clear()
                del his, wds
                if B == batches[0]:
                    layer["ms"] += mult * row["ms"]
                    layer["plain_ms"] += mult * row["plain_ms"]
                    layer["dense_ms"] += mult * row["dense_bf16_ms"]
            if B == batches[0]:
                layer["bytes"] += mult * nbytes
                layer["flops"] += mult * flops
            rows.append(row)
            log("K1 " + json.dumps(row))
    layer["bound_ms"], layer["bound_by"] = bound_ms(layer["bytes"], layer["flops"],
                                                    PEAK_BF16_FLOPS)
    log(f"K1 one decode layer (7 projections, B={batches[0]}): " + json.dumps(layer))
    return layer, max_err


def _k1_weights(torch, dev, gen, scheme, shapes, ams_quantize, pack):
    for name, K, N, mult in shapes:
        w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
        Kp = -(-K // 6) * 6
        wp = torch.nn.functional.pad(w.float(), (0, 0, 0, Kp - K))
        codes, scale = ams_quantize(wp, scheme)
        pw = pack(codes, scale, scheme)
        yield K, N, pw.hi.contiguous(), pw.scale.contiguous(), w, name, mult


# --------------------------------------------------------------------- K2
def phase_k2(torch, dev, timed: bool, full: bool):
    import numpy as np

    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import (
        _fold_q,
        paged_attention_ams,
        paged_attention_ams_plain,
    )

    scheme = get_scheme("fp4.25-e2m2")
    if full:
        kv, g, hd, page, B, max_len, chunks = 4, 7, 128, 16, 8, 1024, (1, 16)
    else:
        kv, g, hd, page, B, max_len, chunks = 2, 2, 32, 8, 4, 64, (1, 4)
    MP = max_len // page
    P = B * MP
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)

    def make_pool():
        pl = {}
        for n in ("k", "v"):
            x = torch.randn((P, page, kv, hd), generator=gen, device=dev)
            pl[n] = {k: t.contiguous() for k, t in quantize_kv(x, scheme).items()}
        return pl

    pool = make_pool()
    bt = torch.as_tensor(rng.permutation(P).reshape(B, MP).astype(np.int32), device=dev)
    # slot lengths (after this tick's insert); the last slot is idle
    ends = rng.integers(max_len // 2, max_len + 1, B)
    ends[1], ends[-1] = max_len, 0
    rows, max_err, decode_row = [], 0.0, None
    for c in chunks:
        nvalid = np.minimum(rng.integers(1, c + 1, B), ends)
        nvalid[0] = c
        nvalid[-1] = 0
        j = np.arange(c)[None, :]
        lengths = np.where(j < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)
        q = torch.randn((B, c, kv * g, hd), generator=gen, device=dev).to(torch.bfloat16)
        qf, lens, _, _ = _fold_q(q, torch.as_tensor(lengths, device=dev), kv, None)
        kw = dict(page_size=page, scheme=scheme, c=c, g=g)
        o_k = paged_attention_ams(qf, pool, lens, bt, **kw)
        o_p = paged_attention_ams_plain(qf, pool, lens, bt, **kw)
        err = float((o_k - o_p).abs().max())
        rel = err / max(float(o_p.abs().max()), 1e-30)
        max_err = max(max_err, err)
        masked = torch.as_tensor(np.repeat(lengths == 0, g, axis=1), device=dev)  # [B, c*g]
        zero_ok = bool((o_k.permute(0, 2, 1, 3)[masked] == 0).all())
        if not (rel <= K2_TOL and zero_ok and torch.isfinite(o_k).all()):
            fail(f"K2 chunk={c}: max abs err {err:.3e} (rel {rel:.3e} > {K2_TOL}) "
                 f"or masked rows not exact zeros ({zero_ok})")
        tok = int(np.sum(np.max(lengths, axis=1)))        # keys each slot's walk needs
        nbytes = (qf.numel() * 4 + tok * kv * 2 * (hd // 2 + 4 + 4) + bt.numel() * 4
                  + lens.numel() * 4 + qf.numel() * 4)
        flops = 4.0 * hd * kv * g * float(lengths.sum())
        bms, by = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        row = dict(chunk=c, kv=kv, g=g, hd=hd, page=page, slots=B,
                   lengths_max=int(lengths.max()), max_abs_err=err, rel_err=rel,
                   exact_zero_rows=int(masked.sum()), bound_ms=bms, bound_by=by)
        if timed:
            n = max(1, min(64, math.ceil(L2_FLUSH_BYTES / max(1, tok * kv * 2 * 72))))
            pools = [pool] + [make_pool() for _ in range(n - 1)]
            outs = []
            row["ms"] = time_graph(torch, [
                (lambda p=p: outs.append(paged_attention_ams(qf, p, lens, bt, **kw)))
                for p in pools])
            outs.clear()
            del pools
            row["plain_ms"] = time_loop(torch, lambda: paged_attention_ams_plain(
                qf, pool, lens, bt, **kw))
        rows.append(row)
        if c == 1:
            decode_row = row
        log("K2 " + json.dumps(row))
    return decode_row, max_err


# ------------------------------------------------------------- main path
def phase_serve(torch, dev, full: bool):
    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.kernels import ams_matmul, attention_template
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    if full:
        ec = EngineConfig(arch="qwen2-7b", reduced=False, scheme="fp5.33-e2m3",
                          impl="kernel", slots=8, capacity=512, prefill_chunk=16,
                          cache=CacheConfig(kind="paged_ams", page_size=16, impl="kernel"),
                          device=str(dev), seed=0)
        n_req, plen, max_tokens, shared = 10, (200, 320), 40, 128
    else:
        ec = EngineConfig(arch="qwen2-7b", reduced=True, scheme="fp5.33-e2m3",
                          impl="kernel", slots=4, capacity=64, prefill_chunk=4,
                          cache=CacheConfig(kind="paged_ams", page_size=8, impl="kernel"),
                          device=str(dev), seed=0)
        n_req, plen, max_tokens, shared = 6, (12, 24), 8, 8
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    eng = ServeEngine(ec)
    log(f"serve: quantize_seconds={eng.quantize_seconds:.3f} layers={eng.cfg.num_layers} "
        f"d_model={eng.cfg.d_model} d_ff={eng.cfg.d_ff} vocab={eng.cfg.vocab_size}")
    rng = np.random.default_rng(1234)
    V = eng.cfg.vocab_size
    prompts = [rng.integers(0, V, int(n)).astype(np.int32)
               for n in rng.integers(plen[0], plen[1], n_req)]
    prompts[-1][:shared] = prompts[0][:shared]   # page-aligned shared prefix, admitted late

    counts = (ams_matmul.COUNT, attention_template.COUNT)
    for cnt in counts:
        cnt.reset()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_tokens) for p in prompts]
    dec_s, dec_tok, dec_ticks = 0.0, 0, 0
    while eng.has_work:
        decode_only = len(eng.sched) == 0 and all(
            r is None or eng.fed[s] >= r.prompt_len for s, r in enumerate(eng.active))
        ts = time.perf_counter()
        out = eng.step()
        if decode_only and out["generated"]:
            dec_s += time.perf_counter() - ts
            dec_tok += out["generated"]
            dec_ticks += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {cnt.name: cnt.launches for cnt in counts}
    plain_cuda = {cnt.name: cnt.plain_on_cuda for cnt in counts}
    st = eng.stats()
    res = dict(requests=len(handles), ticks=st["ticks"], tokens=st["tokens_generated"],
               wall_s=wall, decode_tokens_per_s=(dec_tok / dec_s if dec_s else 0.0),
               decode_ticks=dec_ticks,
               decode_active_slots_mean=(dec_tok / dec_ticks if dec_ticks else 0.0),
               decode_tick_ms=(1e3 * dec_s / dec_ticks if dec_ticks else 0.0),
               decode_ms_median=st["decode_ms_median"], launches=launches,
               plain_calls_on_cuda=plain_cuda, prefix_hit_pages=st["prefix_hit_pages"],
               cached_token_frac=st["cached_token_frac"],
               quantize_seconds=eng.quantize_seconds,
               kv_bytes_per_token=st["kv_bytes_per_token"])
    if dev.type == "cuda":
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    log("serve " + json.dumps(res))
    bad = [h.rid for h in handles if not h.done or len(h.tokens) != max_tokens
           or not all(0 <= t < V for t in h.tokens)]
    if bad:
        fail(f"serve: requests {bad} did not finish with {max_tokens} valid tokens")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"serve: a kernel of the main path never launched: {launches}")
    if dev.type == "cuda" and max(plain_cuda.values()) != 0:
        fail(f"serve: plain versions ran on CUDA tensors: {plain_cuda}")
    if st["prefix_hit_pages"] < 1:
        fail("serve: the shared prefix never hit the prefix cache")
    if dev.type == "cuda":
        profile_decode(torch, eng, rng)
    return res


def profile_decode(torch, eng, rng, ticks: int = 3):
    """Pure-decode ticks with every slot decoding: first timed plainly
    (decode tick ms and tokens/s at a full batch), then under
    torch.profiler (the device-busy share of wall time and the kernels that
    take it)."""
    from torch.profiler import ProfilerActivity, profile

    V = eng.cfg.vocab_size
    for _ in range(eng.slots):
        eng.submit(rng.integers(0, V, eng.chunk).astype("int32"), 2 * ticks + 3)
    eng.step()                                    # the one prefill tick
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    plain_tick = (time.perf_counter() - t0) / ticks
    log("decode " + json.dumps(dict(active_slots=eng.active_count, ticks=ticks,
                                    decode_tick_ms=1e3 * plain_tick,
                                    decode_tokens_per_s=eng.active_count / plain_tick)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    kernels = {}
    busy = 0.0
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = ev.time_range.elapsed_us()
            busy += us
            n, s = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, s + us)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    res = dict(ticks=ticks, wall_ms_per_tick=1e3 * wall / ticks,
               device_busy_ms_per_tick=busy / 1e3 / ticks,
               device_idle_share=max(0.0, 1 - busy / 1e6 / wall),
               kernels_per_tick=sum(n for n, _ in kernels.values()) / ticks,
               top=[dict(name=k[:80], launches_per_tick=n / ticks, ms_per_tick=s / 1e3 / ticks)
                    for k, (n, s) in top])
    log("profile " + json.dumps(res))


def phase_consistency(torch, dev, full: bool):
    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine, init_serving_params
    from repro_torch.models import decode_step, make_cache

    def config(impl, attn):
        base = (dict(reduced=False, depth=2, slots=4, capacity=256, prefill_chunk=16,
                     cache=CacheConfig(kind="paged_ams", page_size=16, impl=attn))
                if full else
                dict(reduced=True, slots=2, capacity=64, prefill_chunk=4,
                     cache=CacheConfig(kind="paged_ams", page_size=8, impl=attn)))
        return EngineConfig(arch="qwen2-7b", scheme="fp5.33-e2m3", impl=impl,
                            device=str(dev), seed=7, **base)

    ck, cr = config("kernel", "kernel"), config("fused_ref", "ref")
    cfg = ck.model_config()
    params = init_serving_params(cfg, QuantPolicy(scheme="fp5.33-e2m3", impl="kernel",
                                                  min_elements=1 << 10), 7, dev)
    rng = np.random.default_rng(99)
    n_req, plen, gen_n = (4, 48, 24) if full else (2, 12, 8)
    prompts = rng.integers(0, cfg.vocab_size, (n_req, plen)).astype(np.int32)

    # first-tick logits of one ragged chunk through both impl pairs
    C = ck.prefill_chunk
    logits = {}
    for ec in (ck, cr):
        ccfg = ec.sized_cache()
        cache = make_cache(cfg, cache_cfg=ccfg, device=dev)
        bt = torch.arange(n_req * ccfg.max_pages_per_seq, dtype=torch.int32,
                          device=dev).reshape(n_req, -1)
        pol = QuantPolicy(scheme=ec.scheme, impl=ec.impl, min_elements=1 << 10)
        lg, _ = decode_step(params, torch.as_tensor(prompts[:, :C], device=dev), cache,
                            torch.zeros(n_req, dtype=torch.int32, device=dev), cfg,
                            policy=pol, block_tables=bt, cache_cfg=ccfg,
                            nvalid=torch.full((n_req,), C, dtype=torch.int32, device=dev))
        logits[ec.impl] = lg.float()
    d = float((logits["kernel"] - logits["fused_ref"]).abs().max())
    rel = d / float(logits["fused_ref"].abs().max())
    same_argmax = bool((logits["kernel"].argmax(-1) == logits["fused_ref"].argmax(-1)).all())

    streams = {}
    for ec in (ck, cr):
        eng = ServeEngine(ec, params=params)
        hs = [eng.submit(p, gen_n) for p in prompts]
        eng.run()
        streams[ec.impl] = [h.tokens for h in hs]
    diverge = []
    for i, (a, b) in enumerate(zip(streams["kernel"], streams["fused_ref"])):
        first = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        diverge.append(first)
    res = dict(depth=cfg.num_layers, logits_max_abs_diff=d, logits_rel_diff=rel,
               tolerance=LOGIT_TOL, first_tick_argmax_equal=same_argmax,
               streams_equal=all(x is None for x in diverge),
               first_diverging_token=diverge)
    log("consistency " + json.dumps(res))
    if not rel <= LOGIT_TOL:
        fail(f"consistency: first-tick logits differ by {rel:.3e} > {LOGIT_TOL}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at tiny sizes (plain versions, no "
                         "timing) and exit non-zero")
    args = ap.parse_args()

    import torch

    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        phase_k1(torch, dev, timed=False, full=False)
        phase_k2(torch, dev, timed=False, full=False)
        phase_serve(torch, dev, full=False)
        phase_consistency(torch, dev, full=False)
        log("rehearsal finished on the CPU: no result")
        sys.exit(2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    report = build.build_all()
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
        log(f"build {name}: {r['seconds']:.1f}s; {' | '.join(regs)}")
    log(f"build total {time.perf_counter() - t0:.1f}s")

    k1, k1_err = phase_k1(torch, dev, timed=True, full=True)
    k2, k2_err = phase_k2(torch, dev, timed=True, full=True)
    serve = phase_serve(torch, dev, full=True)
    phase_consistency(torch, dev, full=True)

    kernels = [
        dict(name="ams_matmul_fp533", route="cuda",
             source="src/repro_torch/kernels/csrc/ams_matmul.cu",
             replaces="src/repro/kernels/ams_matmul.py:138",
             launches=serve["launches"]["ams_matmul_fp533"], max_abs_err=k1_err,
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="paged_attention_ams", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/attention_template.py:399",
             launches=serve["launches"]["paged_attention_ams"], max_abs_err=k2_err,
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
    ]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
