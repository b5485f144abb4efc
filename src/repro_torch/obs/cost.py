"""Roofline-attributed serving cost: analytic floors per engine tick (port
of src/repro/obs/cost.py, on the H100's peaks).

Decode is memory-bound, so the metric the engine keeps is the bytes it
moved against the analytic floor for the work it did. Per engine-step
signature (`launch.steps.engine_step_signature`) this module builds:

  * a `StepCostModel` of per-token costs from `analysis.roofline.param_count`
    (2 x active params per token) plus the KV floors below;
  * per-tick floor HBM bytes and FLOPs for the tokens a tick fed and the
    causal positions it attended (the engine adds them to its registry and
    to each `Request`), and the tick's time floor at the H100's peaks
    (`analysis.roofline`: 3.35 TB/s, 989 TFLOP/s bf16).

Two KV floors: `kv_vector_bytes_floor`, the bytes one packed K or V vector
takes in the AMS page layout (hi codes over the head dim padded to lcm(k,
2), shared-LSB bits in 32-bit words, one f32 scale), derived from the
scheme independently of `repro_torch.cache`; and `kv_vector_bytes_ideal`,
the paper's head_dim x effective_bits / 8 + the scale.

The reference's achieved side, `hlo_step_cost` (compile the jitted step and
parse its HLO), has no PyTorch counterpart; `attribution(eng, profile=True)`
instead replays the engine's decode graph under torch.profiler and sets its
device-busy time beside the tick's time floor.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS, param_count
from repro_torch.core.formats import SCHEMES, AMSFormat, get_scheme


# ------------------------------------------------------------- KV floors
def kv_vector_bytes_floor(hd: int, scheme: AMSFormat) -> int:
    """FORMAT floor: bytes per packed K or V vector of ``hd`` elements
    ((total_bits - 1)-bit hi codes byte-packed over hd padded to lcm(k, 2),
    one shared LSB per k-group in 32-bit words, one f32 scale)."""
    unit = math.lcm(scheme.k, 2)
    hd_p = -(-hd // unit) * unit
    hi = -(-hd_p * (scheme.base.total_bits - 1) // 8)
    lsb = 4 * (-(-(hd_p // scheme.k) // 32))
    return hi + lsb + 4


def kv_vector_bytes_ideal(hd: int, scheme: AMSFormat) -> float:
    """PAPER floor: effective_bits per element + the f32 scale."""
    return hd * scheme.effective_bits / 8.0 + 4.0


# ------------------------------------------------------------ cost model
@dataclasses.dataclass
class StepCostModel:
    """Analytic per-token costs of one engine-step signature (one device:
    the port serves without tensor parallelism)."""

    signature: Dict[str, object]
    weight_bytes: float            # packed weight working set (read per tick)
    flops_per_token: float         # 2 x active params (roofline convention)
    attn_flops_per_pos: float      # QK + AV per (query token, key position)
    kv_bytes_per_token: float      # FORMAT floor, K+V, all layers
    kv_ideal_bytes_per_token: float  # PAPER floor, K+V, all layers
    kv_bf16_bytes_per_token: float   # the bf16 baseline the paper divides by
    # f32 K+V gather round trip per dequantized position (the ref gather's
    # dense views; 0 for bf16 caches)
    kv_dequant_bytes_per_token: float = 0.0

    def tick_floor_bytes(self, tokens_fed: int, positions_read: int) -> float:
        """Floor HBM traffic of one tick: every weight byte once, one KV
        write per fed token and one KV read per attended position."""
        return (self.weight_bytes
                + (tokens_fed + positions_read) * self.kv_bytes_per_token)

    def tick_floor_flops(self, tokens_fed: int, positions_read: int) -> float:
        return (self.flops_per_token * tokens_fed
                + self.attn_flops_per_pos * positions_read)

    def step_time_floor_s(self, tokens_fed: int, positions_read: int) -> float:
        """Roofline time floor of one tick on one H100 SXM
        (`analysis.roofline` HBM_BW / PEAK_FLOPS)."""
        return max(self.tick_floor_bytes(tokens_fed, positions_read) / HBM_BW,
                   self.tick_floor_flops(tokens_fed, positions_read) / PEAK_FLOPS)

    # ------------------------------------------------ achieved KV bytes
    def achieved_kv_read_positions(self, i: int, n: int, *, cache_kind: str = "contiguous",
                                   impl: str = "ref", capacity: int = 0, page_size: int = 0,
                                   max_pages: int = 0) -> int:
        """Cache positions the implementation reads while appending n tokens
        to a slot already holding i: the dense capacity for a contiguous
        cache, the full block-table row for the paged ref gather, the
        causally touched whole pages for the paged kernels (the reference's
        fused template; the port's K2 / K3 mask inside the page alike)."""
        if cache_kind == "contiguous" or not page_size:
            return n * capacity
        if impl == "ref":
            return n * max_pages * page_size
        return sum(-(-(i + j + 1) // page_size) * page_size for j in range(n))

    def achieved_kv_bytes(self, i: int, n: int, *, cache_kind: str = "contiguous",
                          impl: str = "ref", capacity: int = 0, page_size: int = 0,
                          max_pages: int = 0,
                          bytes_per_token: Optional[float] = None) -> float:
        """Bytes the cache implementation moves for that append: one
        pool-layout write per fed token plus the reads above, and for the
        ref impl of a quantized cache the gather's dequantize round trip.
        The kernels restore packed planes on chip: no dequant term."""
        bpt = self.kv_bytes_per_token if bytes_per_token is None else bytes_per_token
        reads = self.achieved_kv_read_positions(
            i, n, cache_kind=cache_kind, impl=impl, capacity=capacity, page_size=page_size,
            max_pages=max_pages)
        out = (n + reads) * bpt
        if page_size and impl == "ref" and self.kv_dequant_bytes_per_token:
            out += reads * self.kv_dequant_bytes_per_token
        return out


def build_cost_model(cfg, scheme: str, cache_cfg=None, *, kv: Optional[int] = None,
                     hd: Optional[int] = None, tp: int = 1, kv_shards: int = 1,
                     seq_shards: int = 1,
                     signature: Optional[Dict[str, object]] = None) -> StepCostModel:
    """Cost model for one engine configuration. ``scheme`` is the weight
    scheme ("fp16": bf16 weights); ``cache_cfg`` selects the KV floors (None,
    contiguous or paged_bf16: bf16 KV); ``kv`` / ``hd`` override the
    config's KV-head geometry with the engine's served dims. Per device on a
    (1, tp) mesh, as in the reference: the weight bytes divide by ``tp``,
    and every KV floor by ``kv_shards`` (the engine passes tp where its
    page pools are head-sharded, else 1) and by ``seq_shards`` (tp where
    its contiguous caches are sequence-sharded: a rank holds and reads 1 /
    tp of every slot's positions), so ``kv_floor_ratio`` stays a ratio of
    like quantities."""
    pc = param_count(cfg)
    wbits = SCHEMES[scheme].effective_bits if scheme in SCHEMES else 16.0
    kv = cfg.num_kv_heads if kv is None else kv
    hd = cfg.head_dim if hd is None else hd
    if kv_shards > 1:
        if kv % kv_shards:
            raise ValueError(f"kv_shards={kv_shards} must divide kv={kv}")
        kv //= kv_shards
    bf16_tok = 2 * kv * (2 * hd)
    dequant = 0.0
    if cache_cfg is not None and getattr(cache_cfg, "quantized", False):
        fmt = get_scheme(cache_cfg.kv_scheme)
        kv_tok = 2 * kv * kv_vector_bytes_floor(hd, fmt)
        kv_ideal = 2 * kv * kv_vector_bytes_ideal(hd, fmt)
        # the ref gather writes and reads back dense f32 K and V views per
        # gathered position (2 vectors x hd x 4 bytes x 2 trips)
        dequant = 2 * kv * hd * 4 * 2
    else:
        kv_tok = float(bf16_tok)
        kv_ideal = float(bf16_tok)
    per = cfg.num_layers / seq_shards
    return StepCostModel(
        signature=dict(signature or {}),
        weight_bytes=pc["total"] * wbits / 8.0 / tp,
        flops_per_token=2.0 * pc["active"],
        attn_flops_per_pos=4.0 * cfg.num_heads * hd,
        kv_bytes_per_token=per * kv_tok,
        kv_ideal_bytes_per_token=per * kv_ideal,
        kv_bf16_bytes_per_token=per * float(bf16_tok),
        kv_dequant_bytes_per_token=per * float(dequant),
    )


# --------------------------------------------------------------- report
def attribution(eng, profile: bool = False, ticks: int = 3) -> Dict[str, object]:
    """Run-level achieved-vs-floor report from an engine's registry (the
    reference's keys). ``kv_achieved_vs_floor`` is the KV read / write
    amplification: bytes the cache implementation touches over the causal
    floor.

    ``profile=True`` stands in for the reference's ``hlo=True``, whose
    keys ``hlo_flops_per_tick`` and ``hlo_hbm_bytes_per_tick`` (and
    ``hlo_hbm_vs_floor``) come from compiling XLA and are not produced
    here: the engine's width-1 decode graph is replayed ``ticks`` times on
    the last tick's staged inputs (a replay rewrites the cache entries that
    tick wrote with the same values; a Mamba or RG-LRU model's recurrent
    states, which a replay would advance again, are put back as the tick
    left them) under
    torch.profiler, after a warm-up replay that is traced and dropped
    (`trace_window`), and its device-busy ms per tick is set beside that tick's time floor at the
    H100's peaks (``profile_floor_ms``; ``profile_floor_share`` = floor /
    busy). It needs an engine on the card whose last tick was a pure-decode
    tick; CPU tensors raise."""
    m = eng.metrics
    cm = eng.cost_model
    if cm is None:
        raise RuntimeError("the engine keeps no cost model (ObsConfig(cost=False))")
    measured = float(eng.kv_bytes_per_token())
    ticks_served = m.value("serve_device_steps_total")
    floor_b = m.value("serve_floor_hbm_bytes_total")
    kv_floor = m.value("serve_kv_floor_bytes_total")
    kv_ach = m.value("serve_kv_achieved_bytes_total")
    out: Dict[str, object] = {
        "signature": dict(cm.signature),
        "kv_bytes_per_token": measured,
        "kv_bytes_per_token_floor": cm.kv_bytes_per_token,
        "kv_bytes_per_token_ideal": cm.kv_ideal_bytes_per_token,
        "kv_floor_ratio": measured / cm.kv_bytes_per_token,
        "kv_vs_ideal_floor": measured / cm.kv_ideal_bytes_per_token,
        "served_ticks": ticks_served,
        "floor_hbm_bytes_total": floor_b,
        "floor_flops_total": m.value("serve_floor_flops_total"),
        "kv_floor_bytes_total": kv_floor,
        "kv_achieved_bytes_total": kv_ach,
        "kv_achieved_vs_floor": kv_ach / kv_floor if kv_floor else 0.0,
        "floor_hbm_bytes_per_tick": floor_b / ticks_served if ticks_served else 0.0,
    }
    if profile:
        out.update(_profiled_decode_graph(eng, cm, ticks))
    return out


# host seconds with nothing on the device at each edge of a profiled window
TRACE_MARGIN_S = 0.05


def trace_window(run, warmup):
    """``warmup()`` then ``run()`` under torch.profiler (CPU and CUDA),
    keeping the records of ``run`` alone: the warm-up is traced and dropped
    (the profiler's schedule), so the device's tracing is running before
    the kept window opens, and the window has ``TRACE_MARGIN_S`` of host
    time with nothing on the device at each edge. Returns (profiler, run's
    result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
        warmup()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        prof.step()
        time.sleep(TRACE_MARGIN_S)
        out = run()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    return prof, out


def device_records(prof):
    """The device's records of a `trace_window`: kernels, copies and fills,
    without the annotation the profiler's schedule spans over the step."""
    return [ev for ev in prof.events()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("ProfilerStep")]


def _profiled_decode_graph(eng, cm: StepCostModel, ticks: int) -> Dict[str, object]:
    import torch

    from repro_torch.launch.sampling import any_sampled
    from repro_torch.launch.steps import recurrent_states_kept

    if eng.graphs is None:
        raise RuntimeError("attribution(profile=True) replays the engine's CUDA graph: the "
                           "engine runs on CPU tensors")
    if eng._pending is not None:
        raise RuntimeError("a step is in flight (call step_end first)")
    h = eng.inputs.host
    if int(h["nvalid"].max()) > 1:
        raise RuntimeError("the last tick was not a pure-decode tick: step a decode tick first")
    pos = h["pos"]
    live = pos >= 0
    fed = int(live.sum())
    reads = int((pos[live].astype("int64") + 1).sum())    # causal: i + 1 positions each
    sampled = any_sampled(eng.samp)                        # the epilogue the tick ran

    def replays():
        for _ in range(ticks):
            eng.graphs(1, sampled)

    with recurrent_states_kept(eng.cache, eng.cfg):
        prof, _ = trace_window(replays, lambda: eng.graphs(1, sampled))
    busy_us = sum(ev.time_range.elapsed_us() for ev in device_records(prof))
    busy_ms = busy_us / 1e3 / ticks
    floor_ms = 1e3 * cm.step_time_floor_s(fed, reads)
    return {"profile_ticks": ticks, "profile_tokens_fed": fed, "profile_positions_read": reads,
            "profile_busy_ms_per_tick": busy_ms, "profile_floor_ms": floor_ms,
            "profile_floor_bytes": cm.tick_floor_bytes(fed, reads),
            "profile_floor_share": floor_ms / busy_ms if busy_ms else 0.0,
            "profile_device": torch.cuda.get_device_name(eng.device)}
