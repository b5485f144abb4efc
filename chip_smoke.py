#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py                  # on a machine with the card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU
    python3 chip_smoke.py --phases k1,k4 [--from DIR]   # some kernel phases
        # alone on the card, this checkout's or those of the checkout at DIR
        # (a parent commit unpacked), to compare two versions in one call;
        # phase "tick" times the greedy FP5.33 graph tick, "rows" runs the
        # row-invariance check of the FP16, contiguous and MLA paths, "tp"
        # the tensor-parallel phase (two ranks on the card), "dp" the
        # data- and tensor-parallel training phase (two ranks on the card),
        # "tptrain" its tensor-parallel run alone

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc
     (one process per source, started together), and print ptxas's
     registers, shared memory and spills for K1's, K1b's, K2's, K3's, K4's,
     K5's and K5p's kernels;
  3. K1 (AMS fp533 dequant-matmul) against its plain torch version at every
     Qwen2-7B projection shape, B in {8, 128}: error, kernel / plain / dense
     bf16 torch.matmul times, and the bound from bytes and operations; one
     layer's 7 projections summed at each B (decode and a prefill chunk);
  4. K1b (AMS planes dequant-matmul), the same for fp4.25-e2m2, plus every
     other planes scheme at one small ragged shape, and, for each decode
     hook that no served path reaches (per_word 4 / 5 / 6: fp8, fp6-e2m3,
     fp5-e2m2), one decode layer's 7 launches counted and every Qwen2-7B
     projection at B in {8, 128} against the plain version, one decode and
     one prefill-chunk layer timed against their bounds and dense bf16;
     K1 also at InternVL2-1B's and Falcon-Mamba-7B's projections (in_proj,
     x_proj with N 288, dt_proj with K 256 = 43 words, out_proj), at
     RecurrentGemma-9B's rec layer (five 4096 x 4096 RG-LRU projections and
     the GeGLU FFN of 12288) and attn layer (wq / wo, wk / wv of one 256-wide
     kv head, the FFN), and K1b (fp4.25) at MusicGen-medium's and at one
     Llama-4-Scout-17B-16E layer (4 attention projections, then the shared
     expert's and 16 experts' gate / up 5120 -> 8192 and down 8192 -> 5120:
     55 launches), the same way;
  5. K2 (paged AMS-e2m2 flash-decode) against its plain version at kv=4,
     g=7, hd=128, pages of 16, 64 and 128 tokens, 8 slots, lengths up to
     1024, chunk in {1, 16}, with an idle slot and masked rows that must
     come out exactly 0; then at hd 64 over pages of 16, InternVL2-1B's
     kv 2, g 7 and MusicGen-medium's kv 24, g 1, and Llama-4-Scout's kv 8,
     g 5, hd 128;
  6. K3 (paged flash-decode over bf16 pages), the same;
  7. K4 (contiguous-cache flash-decode, GQA) at Qwen2-7B shapes (kv=4, g=7,
     hd=128, 8 slots, lengths up to 1024, chunk in {1, 16}) and K5 (the
     absorbed-MLA stream) at MiniCPM3-4B shapes (one stream of 256 + 32
     columns shared by 40 heads, values its first 256), each against its
     plain version element by element within what p's bf16 rounding allows,
     with the torch SDPA call of the same attention timed beside them;
  8. K5p (the paged absorbed-MLA stream, which no served path reaches) at
     MiniCPM3-4B's attention widths, on bf16 and AMS-e2m2 pages that
     cache.pool fills: 8 slots, lengths up to 1024, chunk in {1, 16}, pages
     of 16, 32, 64 and 128, driven through `fused_paged_attention(value_slice=...)`
     with the launch counts zeroed around it, then each hook against its
     plain version (AMS within K2's tolerance, bf16 within K3's rule);
  9. the main paths, served through the continuous-batching engine with
     impl "kernel" for matmuls and attention, each at full width; the main
     path, `fp5.33`, at full depth and every other path cut to its first
     `SERVE_CUT_DEPTH` = 4 layers (5 on the hybrid: one (rec, rec, attn)
     repeat and the (rec, rec) tail), since each model repeats one block
     shape: Qwen2-7B (28 layers)
     with FP5.33 weights over AMS-e2m2 pages (K1, K2; 10 greedy requests,
     two sharing a page-aligned prefix), FP4.25 weights over AMS-e2m2 pages
     (K1b, K2), the FP16 baseline, bf16 weights over bf16 pages (K3), and
     FP5.33 weights over the contiguous cache (K1, K4); MiniCPM3-4B (62 layers) with FP5.33 weights over its contiguous MLA stream (K1,
     K5); InternVL2-1B (24 layers) with FP5.33 weights over AMS
     pages (`vlm-fp5.33`: K1, K2; 9 requests, each 256 seeded normal prefix
     embeds and 32-96 text tokens, 24 new, each stream then held to the
     request served alone on the same engine); MusicGen-medium (48 layers) with FP4.25 weights over AMS pages (`audio-fp4.25`:
     K1b, K2; 9 requests of 96-192 audio tokens, 24 new); Falcon-Mamba-7B
     (64 layers; Mamba-1, no attention) on the one-token
     step over its conv / ssm state caches with FP5.33 weights
     (`ssm-fp5.33`: K1; 9 requests of 32-96 tokens, 24 new, two of them
     seeded sampled, each stream then held to the request served alone)
     and with bf16 weights (`ssm-fp16`: cuBLAS projections, no kernel of
     the port; the same requests; no graph or consistency phase);
     RecurrentGemma-9B (38 layers: (rec, rec, attn) x 12 and a
     (rec, rec) tail) on the one-token step over its conv / recurrent
     states and 2048-slot bf16 rings with FP5.33 weights (`hybrid-fp5.33`:
     K1 alone, the ring attention in plain torch as the reference's XLA
     path, never K4; the Mamba paths' requests, each stream held to the
     request alone) and bf16 weights (`hybrid-fp16`, as `ssm-fp16`);
     Llama-4-Scout-17B-16E (48 layers; MoE: 16 experts, top-1, a shared expert, every
     expert on every token) with FP4.25 weights over AMS pages
     (`moe-fp4.25`: K1b, 55 launches a layer, K2; each stream then held to
     the request served alone) and with bf16 weights over bf16
     pages (`moe-fp16`: K3, cuBLAS projections; served and profiled only);
     9 requests each on the others but FP5.33 (two sharing a prefix on the
     paged ones whose requests are tokens only). Launch counts are zeroed
     just before each path and read just after: every kernel of the path
     must have launched, no other
     kernel and no plain version on CUDA tensors. Every tick replays a CUDA
     graph of the engine step (one per chunk width; capture seconds and the
     graph pool's bytes are printed), and each replay adds the launch
     counts its capture recorded. Each path prints the bytes of the
     weights a decode step reads (projections and lm_head) and their time
     at the memory rate, then times full-batch decode ticks over the served
     context lengths (about 200-360 keys), graph ticks and eager ticks
     (the step function on the same inputs) in turns, one replay's device
     time from CUDA events, and profiles both kinds of tick after a
     warm-up tick that is traced and dropped (device-busy ms, idle share
     and kernels per tick; the profiler's launches of the path's kernels
     in the graph ticks must equal the counted ones, and so must the path
     kernels' nodes in a CUDA graph of the step, read from CUDA's graph
     debug dump);
  10. graph against eager at cut depth (`CUT_DEPTH`, one layer at full
      width; 3 on the hybrid, one whole (rec, rec, attn) repeat; 2 on the
      MoE path), per path:
      two engines from one seed serve the same requests in lockstep (on the
      VLM path with 256 prefix embeds each), one
      replaying its graphs, one running the eager step; tokens after every
      tick and every cache byte must be equal; then one eager step runs
      under torch.cuda.set_sync_debug_mode("error");
  11. consistency at cut depth (as phase 10), per path (both engines
      replay graphs):
      first-tick logits and greedy streams of impl "kernel" against the
      non-kernel impls ("fused_ref" matmuls, "ref" attention) on the card,
      the kernel engine's streams launching every kernel of its path; on
      the MoE path also how many (row, layer) pairs the two lowerings
      routed to another expert set, with the router's margin at each; the
      FP4.25 path once more over pages of 64 tokens (K1b and K2's walk of a
      page in two sub-tiles), and once with fp6-e2m3 weights (K1b's per_word
      5 hook, K2);
  12. ring: `hybrid-fp5.33` at one repeat past the 2048-slot window (two
      prompts of 2100-2300 tokens, 16 new each): a graphed and an eager
      engine in lockstep, equal tokens every tick and equal cache bytes
      (states and rings) at the end; each stream equal to its request
      served alone (`phase_ring`);
  13. engine-features: seeded sampling, preemption with host spill and
      speculative decoding on the FP5.33 path over AMS-e2m2 pages at full
      width (`phase_engine_features`: graph against eager for sampled
      ticks, sampled streams replayed in another engine shape, the sampled
      tick timed and profiled against the greedy one, forced and
      priority-driven preemption resumed bit-equal, the host tier's prefix
      restore, speculative greedy streams equal to plain decoding with
      tokens per step, accept rate and verify-width tick times, the self
      drafters at k = 4 ("self", the first layer, at full depth with
      streams equal to plain decoding's; "self-full" at depth 2; accept
      rate, tokens per step, drafter host ms per round), every row
      of K1, K2, the norm, the head and the sampling epilogue bit-equal to
      the row alone; then K3, FP16's cuBLAS projections, K4, K5 and the
      MLA absorb the same way at 2 and 8 slots x widths {1, 2, 4, 5, 16}:
      a kernel's failing pair is fatal unless the reference's block plan
      explains it, cuBLAS's are recorded, with FP16's speculative streams
      set against plain decoding's), one JSON line per check, K1 and K2 the
      only kernels launched;
  14. seq: `models.forward_seq(want_cache=True)` over a 256-token prompt
      on the FP5.33 Qwen2-7B weights (K1 at 256 rows), then greedy
      one-token decode steps from its cache (K1, K4), against chunked
      prefill of the same prompt over a contiguous cache: first-token
      logits within LOGIT_TOL, the streams' first diverging token printed;
  15. frontend: the async HTTP/SSE front end over the FP5.33 path at full
      width (`phase_frontend`: 12 requests at staggered arrivals, JSON and
      SSE, two sampled, one refused with 429; every stream equal to the
      request served alone; /healthz and /metrics read; K1 and K2 the only
      kernels launched; TTFT, latency, the driver's tick against a direct
      one, the host time between the step's halves and the roofline cost
      line). Each served path also prints an ``attribution`` line: the
      floor of a full decode tick at the H100's peaks beside a profiled
      replay of its graph (`obs.cost.attribution(profile=True)`);
  16. tp (`phase_tp`): tensor-parallel serving, two ranks spawned over
      gloo on the one card (NCCL refuses two ranks on one device; the
      kernels are built before, the ranks load them), in two such worlds
      at once that split the paths (`TP_WORLDS`): full-width Qwen2-7B
      at FP5.33 over AMS pages (`tp2-fp5.33`, all 28 layers, the FP5.33
      path's workload; K1, K2), Llama-4-Scout-17B-16E at FP4.25, 2 layers,
      expert-parallel (`tp2-moe-fp4.25`; K1b, K2), Qwen2-7B at FP16 over
      bf16 pages, 4 layers (`tp2-fp16`; K3), and over sequence-sharded
      contiguous caches: Qwen2-7B at FP5.33, all 28 layers
      (`tp2-contig-fp5.33`, 256 of 512 rows a rank, contig-fp5.33's
      workload), MiniCPM3-4B's MLA stream, 4 layers (`tp2-mla-fp5.33`),
      Falcon-Mamba-7B, 4 layers (`tp2-ssm-fp5.33`, conv / ssm states of
      d_inner / 2 channels a rank, ssm-fp5.33's workload) and
      RecurrentGemma-9B, 5 layers (`tp2-hybrid-fp5.33`, RG-LRU states of
      half the width and 1024 of the 2048 ring slots a rank); K1 alone on
      these four at tp = 2: their ranks merge their partial softmaxes in
      plain torch where tp = 1 launches K4 / K5, as the reference routes a
      sequence-sharded core. Each path's tp = 1 engine
      serves the same workload first (graph ticks but the first, the first
      all-decode one, whose layer 0 K1 / K2 calls, first contiguous
      attention call, head product, MoE call and first logits are
      recorded, and 8 timed eager ones); then each
      rank serves it at tp = 2 eagerly and holds, fatally: the ranks'
      streams equal; its K1 / K1b N-shards of layer 0 (whole where the
      rank holds the linear whole: MLA's wq_a / wkv_a) and its K2 / K3 kv
      heads bit-equal to tp = 1's columns and heads on tp = 1's inputs
      (all but FP16); on `tp2-fp5.33` and `tp2-ssm-fp5.33` its streams and
      first-tick logits bit-equal to tp = 1's, and on the Mamba and hybrid
      paths the recurrent states gathered from both ranks bit-equal to
      tp = 1's (on the hybrid, whose long request puts ring keys on rank
      1, up to its first attention layer, and within LOGIT_TOL after it);
      on `tp2-moe-fp4.25`, whose capacity drops tokens, the same of a
      second serve at the capacity factor that drops nothing; on
      `tp2-fp16` (cuBLAS projections) and the three paths whose attention
      merges across ranks, first-tick logits within
      LOGIT_TOL (streams' first diverging tokens printed), and on those
      three the merge of tp = 1's first contiguous attention call (its q
      and its cache, the rank's half of it) within MERGE_TOL of one rank's
      plain walk, with f32 queries, at the recorded lengths and with every
      row visible; only the path's kernels launched, equal counts on
      both ranks; its cache half of tp = 1's bytes; `moe_ep` with nothing
      dropped against tp = 1's `moe_dense` within LOGIT_TOL. Printed
      (`tp {...}` lines): logits and streams against tp = 1, the head's
      columns, dropped (token, expert) pairs per tick (from the recorded
      routes, after the run), eager tick (the armed tick not timed) and
      collective ms per tick,
      weight bytes and peak memory per rank, launches per rank;
      `tp cublas-columns`: whether cuBLAS gives a rank's N / 2 columns the
      whole product's bits at each bf16 projection and the head; then
      K1, K1b, K2 and K3 timed at a rank's shapes (`K1[qwen2-7b tp2]`...,
      `K1[falcon-mamba-7b tp2]`, `K1[recurrentgemma-9b tp2]`,
      `K1[minicpm3-4b tp2]`). The contiguous, MLA and hybrid paths each
      serve one more request, submitted first, whose prompt (300 tokens;
      1100 on the hybrid, at capacity 1280) runs past rank 0's half, and
      the taps arm on the first all-decode tick that request takes part
      in: rank 1's written rows of layer 0's cache at that tick (printed)
      must be > 0, and the logits and the merge held there read keys on
      both ranks;
  17. train (`phase_train`, after the serving phases have freed the card):
      full-width Qwen2-7B cut to 4 layers trains 8 steps through
      `launch.steps.build_train_step` (B 8 x 512 tokens, microbatches of 4,
      remat; finite, falling loss; step ms, tokens/s, the FLOP-floor share,
      peak memory; no port kernel launched), two depth-1 steps on the card
      against the CPU (loss and grad norm within TRAIN_LOSS_REL /
      TRAIN_GNORM_REL, the masters within TRAIN_UPDATE_REL of how far they
      moved), AdamW alone on the card against the CPU (params, m and v
      within TRAIN_ADAMW_ULPS), and `launch.train.main` on the reduced config with
      a failure injected one step after a checkpoint (restored bytes equal
      to the saved ones, the restored step's loss repeated, a fresh driver
      resuming from the newest step). Run it alone with ``python -c
      "import chip_smoke, torch; chip_smoke.phase_train(torch,
      torch.device('cuda', 0))"``;
  18. dp (`phase_dp`, after train): data- and tensor-parallel training in
      worlds of two ranks spawned over gloo on the one card, after dp = 1
      baselines here (their memory freed first): `single`, (data 2),
      full-width Qwen2-7B at the train phase's config cut to
      DP_SINGLE_LAYERS = 3 layers (B 8 x 512, microbatch 4, remat,
      TRAIN_LR) for DP_STEPS steps, FSDP over data, each step's
      loss and grad norm within TRAIN_LOSS_REL / TRAIN_GNORM_REL of dp = 1
      from the same `init_params(0)`, the ranks' metrics and whole leaves
      bit-equal at every step, each FSDP leaf's master, m and v half a leaf
      on each rank; `multi`, (pod 2, data 1) at depth 1 with the int8
      all-gather (`int8_ag`) for DP_MULTI_STEPS steps, in a world of its
      own: step 0's every compressed leaf within amax / 127 of
      the rank-order f32 sum, step 0's grad norm within TRAIN_GNORM_REL of
      the uncompressed dp = 1 run's plus the int8 error's norm, losses
      within DP_MULTI_LOSS_TOL of the uncompressed dp = 1 run, the ranks'
      params bit-equal; `tp`, (data 1, model 2), single's config in the
      training layout (column / row shards, the vocab split over the
      ranks), in a world of its own, held to single's dp = 1 run: each
      step's loss and grad norm within TRAIN_LOSS_REL / TRAIN_GNORM_REL,
      the ranks' metrics and the master, m and v of every leaf whole over
      ``model`` bit-equal at every step, each model-sharded master, m and
      v half a leaf; no port kernel launched (`dp single` / `dp multi` /
      `dp tp` lines: step and gloo ms, gloo calls and bytes by collective,
      pinned and peak bytes per rank, the card's free bytes, int8 bytes
      against f32's).

A line ``compare {...}`` sets the thirteen paths' graph and eager decode
ticks, replay ms, device-busy ms, idle shares, gaps inside ticks and
kernels per tick side by side. The line before the last is one JSON
object with a row per kernel; the last line is ``{"ok": true, "device":
{...}}``. Without a CUDA card the script exits non-zero and prints no
result (``--cpu-rehearsal`` runs the phases on the CPU at tiny sizes with
the plain versions, skips timing, and also exits non-zero). On the Mamba
and hybrid paths a timed or profiled replay would advance the recurrent
states again: they are put back after the replays
(`launch.steps.recurrent_states_kept`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
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
# K3: max |kernel - plain| <= K3_P_ULP * max|v| + K3_TOL * max |plain|. Both
# round p to bf16 at the running max, but scores summed in another f32
# order can put a p one bf16 ulp (2^-8) apart, which moves an output by at
# most 2^-8 * max|v| (the p / l weights sum to 1).
K3_P_ULP = 2.0 ** -8
K3_TOL = 1e-4
# K4 / K5, element by element: |kernel - plain| <= (CONTIG_P_REL + K3_TOL) * A,
# A = sum_i bf16(p_i) |v_i| / l, the plain walk over |v| with the same p.
# A p one bf16 ulp apart differs by at most 2^-7 of itself (8 significant
# bits), so the flips move an output by at most 2^-7 * A; the f32 orders of
# the sums stay below 1e-4 * A.
CONTIG_P_REL = 2.0 ** -7
LOGIT_TOL = 5e-2                # consistency: max |dlogit| / max |logit|

# the served paths: model, weight scheme, cache kind, the kernels each must launch
PATHS = {
    "fp5.33": dict(arch="qwen2-7b", scheme="fp5.33-e2m3", kind="paged_ams",
                   kernels=("ams_matmul_fp533", "paged_attention_ams")),
    "fp4.25": dict(arch="qwen2-7b", scheme="fp4.25-e2m2", kind="paged_ams",
                   kernels=("ams_matmul_planes", "paged_attention_ams")),
    "fp16": dict(arch="qwen2-7b", scheme="fp16", kind="paged_bf16",
                 kernels=("paged_attention_bf16",)),
    "contig-fp5.33": dict(arch="qwen2-7b", scheme="fp5.33-e2m3", kind="contiguous",
                          kernels=("ams_matmul_fp533", "contiguous_attention")),
    "mla-fp5.33": dict(arch="minicpm3-4b", scheme="fp5.33-e2m3", kind="contiguous",
                       kernels=("ams_matmul_fp533", "contiguous_attention_mla")),
    # the rest of the dense zoo: a VLM whose requests carry 256 patch
    # embeddings each, and an audio decoder with a GELU MLP over MHA
    "vlm-fp5.33": dict(arch="internvl2-1b", scheme="fp5.33-e2m3", kind="paged_ams",
                       kernels=("ams_matmul_fp533", "paged_attention_ams")),
    "audio-fp4.25": dict(arch="musicgen-medium", scheme="fp4.25-e2m2", kind="paged_ams",
                         kernels=("ams_matmul_planes", "paged_attention_ams")),
    # Mamba-1 (attention-free) on the one-token step over its conv / ssm
    # state caches, beside its FP16 baseline (cuBLAS projections, no kernel
    # of the port; no graph or consistency phase)
    "ssm-fp5.33": dict(arch="falcon-mamba-7b", scheme="fp5.33-e2m3", kind="contiguous",
                       kernels=("ams_matmul_fp533",), chunk=1),
    "ssm-fp16": dict(arch="falcon-mamba-7b", scheme="fp16", kind="contiguous", kernels=(),
                     chunk=1, lean=True),
    # the RG-LRU hybrid, (rec, rec, attn) x 12 and a (rec, rec) tail, on the
    # one-token step over its conv / recurrent states and 2048-slot bf16 rings
    # (plain torch attention, as the reference's XLA path: K4 never runs),
    # beside its FP16 baseline; the graph and consistency phases cut it to
    # one whole repeat (3 layers: two would hold no attention)
    "hybrid-fp5.33": dict(arch="recurrentgemma-9b", scheme="fp5.33-e2m3", kind="contiguous",
                          kernels=("ams_matmul_fp533",), chunk=1, depth=3, serve_depth=5),
    "hybrid-fp16": dict(arch="recurrentgemma-9b", scheme="fp16", kind="contiguous",
                        kernels=(), chunk=1, lean=True, serve_depth=5),
    # MoE: Llama-4-Scout-17B-16E (16 experts, top-1, a shared expert) at full
    # width at FP4.25 over AMS pages (every expert's three projections a K1b
    # launch on its slice of the stacked planes), beside FP16 over bf16
    # pages (48 bf16 layers would not fit one card; served and profiled
    # only); each stream held to its request alone
    "moe-fp4.25": dict(arch="llama4-scout-17b-16e", scheme="fp4.25-e2m2", kind="paged_ams",
                       kernels=("ams_matmul_planes", "paged_attention_ams"), alone=True,
                       depth=2),
    "moe-fp16": dict(arch="llama4-scout-17b-16e", scheme="fp16", kind="paged_bf16",
                     kernels=("paged_attention_bf16",), lean=True, alone=True),
}
# the main path, served at full depth; the serve phase cuts every other path
# to its ``serve_depth`` or SERVE_CUT_DEPTH layers: one block shape repeats
# through each model, so a few layers launch every kernel at every shape of
# the path, and the whole smoke stays near half its 1200 s limit
MAIN_PATH = "fp5.33"
SERVE_CUT_DEPTH = 4
# the graph and consistency phases' depth at full width, where a path sets
# none (one layer holds every kernel of a dense path; cut from 2 to keep the
# smoke near 15 minutes with thirteen paths)
CUT_DEPTH = 1
PLANES_SCHEMES = ("fp8", "fp6-e2m3", "fp6-e3m2", "fp5-e2m2", "fp4.5-e2m2", "fp4.33-e2m2",
                  "fp4-e2m1")
QWEN_SHAPES = [("wq/wo", 3584, 3584, 2), ("wk/wv", 3584, 512, 2),
               ("w_gate/w_up", 3584, 18944, 2), ("w_down", 18944, 3584, 1)]
# the zoo's projections: InternVL2-1B (K1, FP5.33) and MusicGen-medium's
# MHA and GELU MLP (K1b, FP4.25)
INTERNVL_SHAPES = [("wq/wo", 896, 896, 2), ("wk/wv", 896, 128, 2),
                   ("w_gate/w_up", 896, 4864, 2), ("w_down", 4864, 896, 1)]
MUSICGEN_SHAPES = [("wq/wk/wv/wo", 1536, 1536, 4), ("w_up", 1536, 6144, 1),
                   ("w_down", 6144, 1536, 1)]
# Falcon-Mamba-7B's projections (K1, FP5.33): x_proj's N = dt_rank + 2n =
# 288, dt_proj's K = 256 (Kp 258, 43 fp533 words)
MAMBA_SHAPES = [("in_proj", 4096, 16384, 1), ("x_proj", 8192, 288, 1),
                ("dt_proj", 256, 8192, 1), ("out_proj", 8192, 4096, 1)]
# RecurrentGemma-9B's projections (K1, FP5.33): a rec layer (the RG-LRU's
# in_x, in_gate, w_rec_gate, w_in_gate and out_proj, then the GeGLU FFN)
# and an attn layer (MQA: one kv head of 256)
RECURRENTGEMMA_SHAPES = {
    "rec": [("in_x/in_gate/w_rec_gate/w_in_gate/out_proj", 4096, 4096, 5),
            ("w_gate/w_up", 4096, 12288, 2), ("w_down", 12288, 4096, 1)],
    "attn": [("wq/wo", 4096, 4096, 2), ("wk/wv", 4096, 256, 2),
             ("w_gate/w_up", 4096, 12288, 2), ("w_down", 12288, 4096, 1)],
}
# one Llama-4-Scout-17B-16E layer (K1b, FP4.25): 4 attention projections
# (40 q / 8 kv heads of 128), then the shared expert's and the 16 experts'
# gate / up (5120 -> 8192) and down (8192 -> 5120), as `moe_dense` runs them
SCOUT_SHAPES = [("wq/wo", 5120, 5120, 2), ("wk/wv", 5120, 1024, 2),
                ("w_gate/w_up x 17", 5120, 8192, 34), ("w_down x 17", 8192, 5120, 17)]
TINY_SHAPES = [("wq/wo", 128, 128, 2), ("wk/wv", 128, 64, 2),
               ("w_gate/w_up", 128, 256, 2), ("w_down", 256, 128, 1)]
# page sizes of the K2 / K3 phases: the CacheConfig default (timed against a
# parent checkout), then pages walked in 2 and 4 sub-tiles of 32 tokens
PAGES = (16, 64, 128)
TINY_PAGES = (8, 32)


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    """Print the failure on both streams (a caller that keeps only the end
    of standard error still reads why) and exit 1."""
    log(f"FAIL: {msg}")
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, *work):
    """The larger of the bytes' time at the memory rate and the operations'
    time, ``work`` being (flops, peak rate of their type) pairs."""
    tb, tf = nbytes / PEAK_BYTES_PER_S, sum(f / peak for f, peak in work)
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


# ------------------------------------------------------------ K1 and K1b
def _packed_weight(torch, dev, gen, scheme_name: str, K: int, N: int):
    """Packed planes of a random [K, N] weight (K zero-padded to the
    layout's block, as models.common.quantize_params does) and the bf16
    weight for the dense yardstick."""
    from repro_torch.core.ams import ams_quantize
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.packing import make_layout, pack

    scheme = get_scheme(scheme_name)
    w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    Kp = make_layout(scheme).padded_k(K)
    wp = torch.nn.functional.pad(w.float(), (0, 0, 0, Kp - K))
    return pack(*ams_quantize(wp, scheme), scheme), w


def _padded_x(torch, dev, gen, K: int, pw, B: int):
    x = torch.zeros((B, pw.K), dtype=torch.bfloat16, device=dev)     # pw.K: padded
    x[:, :K] = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
    return x


def _check_matmul(torch, tag: str, kernel, plain, x, pw):
    y_k, y_p = kernel(x, pw), plain(x, pw)
    err = float((y_k - y_p).abs().max())
    rel = err / max(float(y_p.abs().max()), 1e-30)
    if not (rel <= K1_TOL and torch.isfinite(y_k).all()):
        fail(f"{tag}: max abs err {err:.3e} (rel {rel:.3e} > {K1_TOL})")
    return err, rel


def _matmul_phase(torch, dev, tag: str, scheme: str, gen, kernel, plain, timed: bool,
                  full: bool, decode_only: bool = False, shapes=QWEN_SHAPES):
    """``kernel`` / ``plain`` (x, PackedWeight) -> y at every projection
    shape of a layer (Qwen2-7B's by default), B in {8, 128} (8 alone with
    ``decode_only``): error against the plain version, and when ``timed``
    kernel / plain / dense bf16 torch.matmul times; one decode layer (its 7
    projections at B=8) summed, with its bound."""
    import dataclasses

    shapes = shapes if full else TINY_SHAPES
    batches = (8, 8 * 16) if full else (2, 2 * 4)
    if decode_only:
        batches = batches[:1]
    max_err = 0.0
    layers = {B: {"B": B, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0,
                  "flops": 0.0, "dense_ms": 0.0} for B in batches}
    for name, K, N, mult in shapes:
        pw, wd = _packed_weight(torch, dev, gen, scheme, K, N)
        wbytes = (pw.hi.numel() + pw.lsb.numel()) * 4
        for B in batches:
            x = _padded_x(torch, dev, gen, K, pw, B)
            err, rel = _check_matmul(torch, f"{tag} {name} K={K} N={N} B={B}", kernel, plain,
                                     x, pw)
            max_err = max(max_err, err)
            nbytes = x.numel() * 2 + wbytes + N * 4 + B * N * 4
            flops = 2.0 * B * K * N
            bms, by = bound_ms(nbytes, (flops, PEAK_BF16_FLOPS))
            row = dict(scheme=scheme, shape=name, K=K, N=N, B=B, max_abs_err=err,
                       rel_err=rel, bound_ms=bms, bound_by=by)
            if timed:
                copies = [dataclasses.replace(pw, hi=pw.hi.clone(), lsb=pw.lsb.clone())
                          for _ in range(max(1, min(256, math.ceil(L2_FLUSH_BYTES / wbytes))))]
                wds = [wd.clone() for _ in range(max(1, min(64, math.ceil(
                    L2_FLUSH_BYTES / (wd.numel() * 2)))))]
                outs = []
                row["ms"] = time_graph(torch, [
                    (lambda c=c: outs.append(kernel(x, c))) for c in copies])
                outs.clear()
                row["plain_ms"] = time_loop(torch, lambda: plain(x, pw))
                xk = x[:, :K].contiguous()
                row["dense_bf16_ms"] = time_graph(torch, [
                    (lambda w=w: outs.append(torch.matmul(xk, w))) for w in wds])
                outs.clear()
                del copies, wds
                layers[B]["ms"] += mult * row["ms"]
                layers[B]["plain_ms"] += mult * row["plain_ms"]
                layers[B]["dense_ms"] += mult * row["dense_bf16_ms"]
            layers[B]["bytes"] += mult * nbytes
            layers[B]["flops"] += mult * flops
            log(f"{tag} " + json.dumps(row))
    for B, layer in layers.items():
        layer["bound_ms"], layer["bound_by"] = bound_ms(layer["bytes"],
                                                        (layer["flops"], PEAK_BF16_FLOPS))
        what = "one decode layer" if B == batches[0] else "one prefill-chunk layer"
        n = sum(mult for *_, mult in shapes)
        log(f"{tag} {what} ({n} projections, {scheme}, B={B}): " + json.dumps(layer))
    return layers[batches[0]], max_err


def phase_k1(torch, dev, timed: bool, full: bool):
    from repro_torch.kernels.ams_matmul import ams_matmul_fp533, ams_matmul_fp533_plain

    gen = torch.Generator(device=dev).manual_seed(11)

    def kernel(x, pw):
        return ams_matmul_fp533(x, pw.hi, pw.scale)

    def plain(x, pw):
        return ams_matmul_fp533_plain(x, pw.hi, pw.scale)

    layer, err = _matmul_phase(torch, dev, "K1", "fp5.33-e2m3", gen, kernel, plain, timed, full)
    zoo = _matmul_phase(torch, dev, "K1[internvl2-1b]", "fp5.33-e2m3", gen, kernel, plain, timed,
                        full, shapes=INTERNVL_SHAPES)
    mamba = _matmul_phase(torch, dev, "K1[falcon-mamba-7b]", "fp5.33-e2m3", gen, kernel, plain,
                          timed, full, shapes=MAMBA_SHAPES)
    # one rec and one attn layer of RecurrentGemma-9B, and the two summed
    rg = {kind: _matmul_phase(torch, dev, f"K1[recurrentgemma-9b {kind}]", "fp5.33-e2m3", gen,
                              kernel, plain, timed, full, shapes=shapes)
          for kind, shapes in RECURRENTGEMMA_SHAPES.items()}
    both = {k: rg["rec"][0][k] + rg["attn"][0][k] for k in rg["rec"][0]
            if k not in ("B", "bound_by")}
    both["B"] = rg["rec"][0]["B"]
    both["bound_ms"], both["bound_by"] = bound_ms(both["bytes"], (both["flops"],
                                                                 PEAK_BF16_FLOPS))
    log("K1[recurrentgemma-9b] one rec and one attn decode layer: " + json.dumps(both))
    return layer, err, zoo, mamba, (both, max(rg["rec"][1], rg["attn"][1]))


def phase_k1b(torch, dev, timed: bool, full: bool):
    from repro_torch.kernels.ams_matmul import ams_matmul_planes, ams_matmul_planes_plain

    def kernel(x, pw):
        return ams_matmul_planes(x, pw.hi, pw.lsb, pw.scale, pw.layout)

    def plain(x, pw):
        return ams_matmul_planes_plain(x, pw.hi, pw.lsb, pw.scale, pw.layout)

    gen = torch.Generator(device=dev).manual_seed(12)
    # every planes scheme but fp4.25 at one small ragged shape
    K, N = (700, 300) if full else (70, 30)
    max_err = 0.0
    for name in PLANES_SCHEMES:
        pw, _ = _packed_weight(torch, dev, gen, name, K, N)
        err, rel = _check_matmul(torch, f"K1b {name}", kernel, plain,
                                 _padded_x(torch, dev, gen, K, pw, 5), pw)
        max_err = max(max_err, err)
        log("K1b " + json.dumps(dict(scheme=name, K=K, Kp=pw.K, N=N, B=5, max_abs_err=err,
                                     rel_err=rel)))
    layer, err = _matmul_phase(torch, dev, "K1b", "fp4.25-e2m2", gen, kernel, plain, timed,
                               full)
    zoo = _matmul_phase(torch, dev, "K1b[musicgen-medium]", "fp4.25-e2m2", gen, kernel, plain,
                        timed, full, shapes=MUSICGEN_SHAPES)
    scout = _matmul_phase(torch, dev, "K1b[llama4-scout-17b-16e]", "fp4.25-e2m2", gen, kernel,
                          plain, timed, full, shapes=SCOUT_SHAPES)
    wide = {s: _k1b_hook(torch, dev, gen, s, kernel, plain, timed, full) for s in K1B_WIDE}
    return layer, max(max_err, err), wide, zoo, scout


# one scheme per decode hook of K1b that no served path reaches: per_word 4,
# 5 and 6 (the paper's fp8, fp6 and fp5)
K1B_WIDE = ("fp8", "fp6-e2m3", "fp5-e2m2")


def _k1b_hook(torch, dev, gen, scheme: str, kernel, plain, timed: bool, full: bool):
    """One of K1b's decode hooks that no served path reaches: one decode
    layer of ``scheme`` weights at Qwen2-7B's shapes, first its 7
    projections through the wrapper with the launch counts zeroed just
    before and read just after, then each shape at B 8 and 128 against its
    plain version with times, the bound and dense bf16. Returns the decode
    layer's row, the error, the launches and the per_word."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.packing import make_layout
    from repro_torch.kernels.ams_matmul import COUNT_PLANES, planes_on_tensor_cores

    lay = make_layout(get_scheme(scheme))
    if not planes_on_tensor_cores(lay):
        fail(f"K1b: {scheme} has no decode hook")
    shapes = QWEN_SHAPES if full else TINY_SHAPES
    B = 8 if full else 2
    layer = []
    for name, K, N, mult in shapes:
        pw, _ = _packed_weight(torch, dev, gen, scheme, K, N)
        layer += [(pw, _padded_x(torch, dev, gen, K, pw, B))] * mult
    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    for pw, x in layer:
        kernel(x, pw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {cnt.name: cnt.launches for cnt in counts}
    plain_cuda = sum(cnt.plain_on_cuda for cnt in counts)
    log("K1b entry " + json.dumps(dict(scheme=scheme, per_word=lay.per_word, B=B,
                                       launches=launches, plain_calls_on_cuda=plain_cuda)))
    if dev.type == "cuda" and (launches[COUNT_PLANES.name] != len(layer)
                               or sum(launches.values()) != len(layer) or plain_cuda):
        fail(f"K1b: one {scheme} decode layer did not launch the planes kernel once per "
             f"projection: {launches}, plain versions on CUDA tensors {plain_cuda}")
    del layer
    row, err = _matmul_phase(torch, dev, f"K1b-pw{lay.per_word}", scheme, gen, kernel, plain,
                             timed, full)
    return dict(layer=row, err=err, launches=launches[COUNT_PLANES.name],
                per_word=lay.per_word)


# --------------------------------------------------------------------- K2
# K2 at the zoo's attention shapes (page 16, decode and chunk 16):
# InternVL2-1B (kv 2, g 7) and MusicGen-medium's MHA (kv 24, g 1), hd 64,
# and Llama-4-Scout-17B-16E (kv 8, g 5, hd 128)
K2_ZOO = {"internvl2-1b": (2, 7, 64), "musicgen-medium": (24, 1, 64),
          "llama4-scout-17b-16e": (8, 5, 128)}
K2_ZOO_TINY = {"internvl2-1b": (2, 7, 16), "musicgen-medium": (4, 1, 16),
               "llama4-scout-17b-16e": (2, 2, 16)}


def phase_k2(torch, dev, timed: bool, full: bool):
    """K2 at Qwen2-7B's shapes (kv 4, g 7, hd 128) over pages of 16, 64 and
    128, then at the zoo's shapes (`K2_ZOO`) over pages of 16. Returns the
    Qwen2-7B decode row, the error, and each zoo shape's decode row and
    error."""
    import numpy as np

    if full:
        kv, g, hd, pages, B, max_len, chunks = 4, 7, 128, PAGES, 8, 1024, (1, 16)
        zoo = K2_ZOO
    else:
        kv, g, hd, pages, B, max_len, chunks = 2, 2, 32, TINY_PAGES, 4, 64, (1, 4)
        zoo = K2_ZOO_TINY
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    decode_row, max_err = _k2_cases(torch, np, dev, rng, gen, kv, g, hd, pages, B, max_len,
                                    chunks, timed, "K2")
    extra = {arch: _k2_cases(torch, np, dev, rng, gen, *shape, pages[:1], B, max_len, chunks,
                             timed, f"K2[{arch}]")
             for arch, shape in zoo.items()}
    return decode_row, max_err, extra


def _k2_cases(torch, np, dev, rng, gen, kv, g, hd, pages, B, max_len, chunks, timed, tag):
    """K2 against its plain version at one (kv, g, hd), every page size and
    chunk: error, exact zeros on masked rows, and when ``timed`` kernel /
    plain times against the bound. Returns the first page size's decode row
    and the largest error."""
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.kv_quant import quantize_kv
    from repro_torch.kernels.attention_template import (
        _fold_q,
        paged_attention_ams,
        paged_attention_ams_plain,
    )
    from repro_torch.kernels.tuning import plan_paged_attention

    scheme = get_scheme("fp4.25-e2m2")

    def make_pool(P, page):
        pl = {}
        for n in ("k", "v"):
            x = torch.randn((P, page, kv, hd), generator=gen, device=dev)
            pl[n] = {k: t.contiguous() for k, t in quantize_kv(x, scheme).items()}
        return pl

    max_err, decode_row = 0.0, None
    for page, c, pool, bt, ends in _paged_cases(torch, np, dev, rng, pages, chunks, B, max_len,
                                                make_pool):
        lengths = _chunk_lengths(np, rng, ends, c)
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
            fail(f"{tag} chunk={c}: max abs err {err:.3e} (rel {rel:.3e} > {K2_TOL}) "
                 f"or masked rows not exact zeros ({zero_ok})")
        tok = int(np.sum(np.max(lengths, axis=1)))        # keys each slot's walk needs
        tok_bytes = kv * 2 * (hd // 2 + 4 + 4)            # K and V: hi, lsb word, scale
        nbytes = (qf.numel() * 4 + tok * tok_bytes + bt.numel() * 4
                  + lens.numel() * 4 + qf.numel() * 4)
        flops = 4.0 * hd * kv * g * float(lengths.sum())      # f32 p times f32 v
        bms, by = bound_ms(nbytes, (flops, PEAK_F32_FLOPS))
        plan = plan_paged_attention(B, kv, c * g, bt.shape[1] * page)
        row = dict(chunk=c, kv=kv, g=g, hd=hd, page=page, slots=B,
                   lengths_max=int(lengths.max()), max_abs_err=err, rel_err=rel,
                   exact_zero_rows=int(masked.sum()), bound_ms=bms, bound_by=by,
                   rows_per_cta=plan.rows, cluster=plan.cluster, ctas=plan.ctas(B, kv))
        if timed:
            n = max(1, min(64, math.ceil(L2_FLUSH_BYTES / max(1, tok * tok_bytes))))
            pools = [pool] + [make_pool(bt.numel(), page) for _ in range(n - 1)]
            outs = []
            row["ms"] = time_graph(torch, [
                (lambda p=p: outs.append(paged_attention_ams(qf, p, lens, bt, **kw)))
                for p in pools])
            outs.clear()
            del pools
            row["plain_ms"] = time_loop(torch, lambda: paged_attention_ams_plain(
                qf, pool, lens, bt, **kw))
        if page == pages[0] and c == 1:
            decode_row = row
        log(f"{tag} " + json.dumps(row))
    return decode_row, max_err


def _paged_cases(torch, np, dev, rng, pages, chunks, B: int, max_len: int, make_pool):
    """(page, chunk, pool, block table, slot lengths) of a paged phase: per
    page size a pool of B * max_len / page pages from ``make_pool(P,
    page)`` and a random block table; the slot lengths (after this tick's
    insert: one slot full, the last idle) are drawn once, at the first page
    size, so every page size sees the same keys."""
    ends = None
    for page in pages:
        MP = max_len // page
        pool = make_pool(B * MP, page)
        bt = torch.as_tensor(rng.permutation(B * MP).reshape(B, MP).astype(np.int32),
                             device=dev)
        if ends is None:
            ends = rng.integers(max_len // 2, max_len + 1, B)
            ends[1], ends[-1] = max_len, 0
        for c in chunks:
            yield page, c, pool, bt, ends


def _chunk_lengths(np, rng, ends, c: int):
    """Per-query valid-key counts [B, c] of a chunk that ends at ``ends``
    per slot: slot 0 fills the chunk, the last slot is idle, the others are
    ragged (rows past a slot's count are masked: length 0)."""
    B = len(ends)
    nvalid = np.minimum(rng.integers(1, c + 1, B), ends)
    nvalid[0] = c
    nvalid[-1] = 0
    j = np.arange(c)[None, :]
    return np.where(j < nvalid[:, None], ends[:, None] - nvalid[:, None] + j + 1, 0)


def attention_work(hd: int, hd_v: int, row_keys: float, q_peak: float,
                   pv_peak: float = PEAK_BF16_FLOPS):
    """The operations of attention over ``row_keys`` (query row, visible
    key) pairs: q.k at ``q_peak`` (the f32 rate where q stays unrounded f32,
    the bf16 rate where it holds bf16 values), and p.v at ``pv_peak``: by
    default bf16(p) * bf16 v summed in f32, a bf16 tensor-core product, at
    the bf16 rate; the f32 rate where p stays f32 (AMS pages)."""
    return (2.0 * hd * row_keys, q_peak), (2.0 * hd_v * row_keys, pv_peak)


# --------------------------------------------------------------------- K3
def phase_k3(torch, dev, timed: bool, full: bool):
    import numpy as np

    if full:
        kv, g, hd, pages, B, max_len, chunks = 4, 7, 128, PAGES, 8, 1024, (1, 16)
    else:
        kv, g, hd, pages, B, max_len, chunks = 2, 2, 32, TINY_PAGES, 4, 64, (1, 4)
    rng = np.random.default_rng(6)
    gen = torch.Generator(device=dev).manual_seed(6)
    return _k3_cases(torch, np, dev, rng, gen, kv, g, hd, pages, B, max_len, chunks, timed,
                     "K3")


def _k3_cases(torch, np, dev, rng, gen, kv, g, hd, pages, B, max_len, chunks, timed, tag):
    """K3 against its plain version at one (kv, g, hd), every page size and
    chunk, as `_k2_cases` does K2. Returns the first page size's decode row
    and the largest error."""
    from repro_torch.kernels.attention_template import (
        _fold_q,
        paged_attention_bf16,
        paged_attention_bf16_plain,
    )

    def make_pool(P, page):
        return {n: torch.randn((P, page, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
                for n in ("k", "v")}

    max_err, decode_row = 0.0, None
    for page, c, pool, bt, ends in _paged_cases(torch, np, dev, rng, pages, chunks, B, max_len,
                                                make_pool):
        vmax = float(pool["v"].float().abs().max())
        lengths = _chunk_lengths(np, rng, ends, c)
        q = torch.randn((B, c, kv * g, hd), generator=gen, device=dev).to(torch.bfloat16)
        qf, lens, _, _ = _fold_q(q, torch.as_tensor(lengths, device=dev), kv, None)
        kw = dict(page_size=page, c=c, g=g)
        o_k = paged_attention_bf16(qf, pool, lens, bt, **kw)
        o_p = paged_attention_bf16_plain(qf, pool, lens, bt, **kw)
        err = float((o_k - o_p).abs().max())
        tol = K3_P_ULP * vmax + K3_TOL * float(o_p.abs().max())
        max_err = max(max_err, err)
        masked = torch.as_tensor(np.repeat(lengths == 0, g, axis=1), device=dev)  # [B, c*g]
        zero_ok = bool((o_k.permute(0, 2, 1, 3)[masked] == 0).all())
        if not (err <= tol and zero_ok and torch.isfinite(o_k).all()):
            fail(f"{tag} chunk={c}: max abs err {err:.3e} > {tol:.3e} "
                 f"or masked rows not exact zeros ({zero_ok})")
        tok = int(np.sum(np.max(lengths, axis=1)))        # keys each slot's walk needs
        nbytes = (qf.numel() * 4 + tok * kv * 2 * hd * 2 + bt.numel() * 4
                  + lens.numel() * 4 + qf.numel() * 4)
        bms, by = bound_ms(nbytes, *attention_work(hd, hd, kv * g * float(lengths.sum()),
                                                    PEAK_BF16_FLOPS))   # q rounded to bf16
        row = dict(chunk=c, kv=kv, g=g, hd=hd, page=page, slots=B,
                   lengths_max=int(lengths.max()), max_abs_err=err, tolerance=tol,
                   exact_zero_rows=int(masked.sum()), bound_ms=bms, bound_by=by)
        if timed:
            n = max(1, min(64, math.ceil(L2_FLUSH_BYTES / max(1, tok * kv * 2 * hd * 2))))
            pools = [pool] + [make_pool(bt.numel(), page) for _ in range(n - 1)]
            outs = []
            row["ms"] = time_graph(torch, [
                (lambda p=p: outs.append(paged_attention_bf16(qf, p, lens, bt, **kw)))
                for p in pools])
            outs.clear()
            del pools
            row["plain_ms"] = time_loop(torch, lambda: paged_attention_bf16_plain(
                qf, pool, lens, bt, **kw))
        if page == pages[0] and c == 1:
            decode_row = row
        log(f"{tag} " + json.dumps(row))
    return decode_row, max_err


# ------------------------------------------------------------ K4 and K5
def _library_attention(torch, q, k, v, lengths, scale):
    """One torch SDPA call of the same attention: q [B, c, H, hd] bf16
    (unscaled), k / v [B, S, kv, *] (views of the cache), a boolean mask of
    each query's valid keys. p is not rounded to bf16 at the block max, so
    it computes the function up to that rounding."""
    import torch.nn.functional as F

    S = k.shape[1]
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < lengths[:, None, :, None])                               # [B, 1, c, S]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask, scale=scale,
                                          enable_gqa=True)


def _contiguous_phase(torch, dev, tag: str, timed: bool, full: bool, mla: bool):
    """K4 (``mla`` False: separate K and V at Qwen2-7B shapes) or K5 (one
    MiniCPM3-4B stream, values its first hd_v columns) against its plain
    version: 8 slots, lengths up to 1024 (one slot idle, one full), chunk 1
    and 16, the reference's key block."""
    import numpy as np

    from repro_torch.kernels import attention_template as T
    from repro_torch.kernels.tuning import plan_mla_attention, reference_block_kv

    if mla:
        kv, g, hd, hd_v, scale = (1, 40, 288, 256, 1 / math.sqrt(96)) if full else \
            (1, 4, 48, 32, 1 / math.sqrt(32))
    else:
        kv, g, hd, hd_v, scale = (4, 7, 128, 128, None) if full else (2, 2, 32, 32, None)
    B, S, chunks = (8, 1024, (1, 16)) if full else (4, 64, (1, 4))
    rng = np.random.default_rng(7 if mla else 8)
    gen = torch.Generator(device=dev).manual_seed(7 if mla else 8)

    def make_caches():
        n = 1 if mla else 2
        return [torch.randn((B, S, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(n)]

    caches = make_caches()
    v_of = (lambda cs: cs[0][..., :hd_v]) if mla else (lambda cs: cs[1])
    v_abs = v_of(caches).abs().contiguous()
    ends = rng.integers(S // 2, S + 1, B)
    ends[1], ends[-1] = S, 0
    rows, max_err, decode_row = [], 0.0, None
    for c in chunks:
        lengths = _chunk_lengths(np, rng, ends, c)
        lengths_t = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn((B, c, kv * g, hd), generator=gen, device=dev).to(torch.bfloat16)
        qf, lens, _, _ = T._fold_q(q, lengths_t, kv, scale, round_scaled=False)
        bk = reference_block_kv(rows=c * g, hd=hd, hd_v=hd_v, s_max=S)
        kw = dict(c=c, g=g, block_kv=bk)
        if mla:
            kw["hd_v"] = hd_v
            plan = plan_mla_attention(B, kv, c * g, bk)

            def kernel(cs):
                return T.contiguous_attention_mla(qf, cs[0], lens, **kw)

            def plain(cs):
                return T.contiguous_attention_mla_plain(qf, cs[0], lens, **kw)
        else:
            def kernel(cs):
                return T.contiguous_attention(qf, cs[0], cs[1], lens, **kw)

            def plain(cs):
                return T.contiguous_attention_plain(qf, cs[0], cs[1], lens, **kw)
        o_k, o_p = kernel(caches), plain(caches)
        # A = sum_i bf16(p_i) |v_i| / l: K4's plain walk over |v| with the same p
        tol = (CONTIG_P_REL + K3_TOL) * T.contiguous_attention_plain(
            qf, caches[0], v_abs, lens, c=c, g=g, block_kv=bk)
        diff = (o_k - o_p).abs()
        err = float(diff.max())
        over = float((diff / tol.clamp(min=1e-30)).max())      # <= 1: within tolerance
        max_err = max(max_err, err)
        masked = torch.as_tensor(np.repeat(lengths == 0, g, axis=1), device=dev)  # [B, c*g]
        zero_ok = bool((o_k.permute(0, 2, 1, 3)[masked] == 0).all())
        if not (bool((diff <= tol).all()) and zero_ok and torch.isfinite(o_k).all()):
            fail(f"{tag} chunk={c}: max abs err {err:.3e}, {over:.3g}x its element's "
                 f"tolerance, or masked rows not exact zeros ({zero_ok})")
        tok = int(np.sum(np.max(lengths, axis=1)))        # keys each slot's walk needs
        key_bytes = tok * kv * 2 * (hd if mla else hd + hd_v)     # K5: V is inside K
        nbytes = qf.numel() * 4 + key_bytes + lens.numel() * 4 + o_k.numel() * 4
        bms, by = bound_ms(nbytes, *attention_work(hd, hd_v, kv * g * float(lengths.sum()),
                                                    PEAK_F32_FLOPS))    # q unrounded f32
        row = dict(chunk=c, kv=kv, g=g, hd=hd, hd_v=hd_v, slots=B, S=S, block_kv=bk,
                   lengths_max=int(lengths.max()), max_abs_err=err,
                   tolerance_median=float(tol[tol > 0].median()),
                   tolerance_min=float(tol[tol > 0].min()), err_over_tolerance=over,
                   exact_zero_rows=int(masked.sum()), bound_ms=bms, bound_by=by)
        if mla:
            row.update(cluster=plan.cluster, ctas=plan.ctas(B, kv), resident=plan.resident)
        if timed:
            n = max(1, min(64, math.ceil(L2_FLUSH_BYTES / max(1, key_bytes))))
            sets = [caches] + [make_caches() for _ in range(n - 1)]
            outs = []
            row["ms"] = time_graph(torch, [(lambda cs=cs: outs.append(kernel(cs)))
                                           for cs in sets])
            outs.clear()
            row["plain_ms"] = time_loop(torch, lambda: plain(caches))
            try:
                row["library_ms"] = time_graph(torch, [
                    (lambda cs=cs: outs.append(_library_attention(
                        torch, q, cs[0], v_of(cs), lengths_t, scale))) for cs in sets])
            except RuntimeError as e:     # no SDPA backend takes these shapes
                row["library_ms"], row["library_error"] = None, str(e).splitlines()[0]
            outs.clear()
            del sets
        rows.append(row)
        if c == 1:
            decode_row = row
        log(f"{tag} " + json.dumps(row))
    return decode_row, max_err


def phase_k4(torch, dev, timed: bool, full: bool):
    return _contiguous_phase(torch, dev, "K4", timed, full, mla=False)


def phase_k5(torch, dev, timed: bool, full: bool):
    return _contiguous_phase(torch, dev, "K5", timed, full, mla=True)


# -------------------------------------------------------------------- K5p
K5P_SCHEME = "fp4.25-e2m2"      # the CacheConfig default kv_scheme
K5P_KERNELS = {"bf16": "paged_attention_stream_bf16", "ams": "paged_attention_stream_ams"}


def phase_k5p(torch, dev, timed: bool, full: bool):
    """K5p, the paged absorbed-MLA stream, at MiniCPM3-4B's attention widths
    (40 heads on one stream of 256 + 32 columns, values its first 256, the
    model's softmax scale), on bf16 pages and AMS-e2m2 pages that
    cache.pool builds and fills: 8 slots, lengths up to 1024 (one slot
    idle, one full), chunk 1 and 16, pages of 16 (the CacheConfig default),
    32, 64 and 128. First the entry a user calls,
    `fused_paged_attention(value_slice=...)`, over every case, with the
    launch counts zeroed just before and read just after (no served path
    reaches K5p: the reference pages no MLA cache, and neither does the
    port); then each hook's wrapper against its plain version on the same
    folded inputs (those launches are not counted), with times and bounds.
    Returns the decode rows (page 16) by hook, the errors and the launches."""
    import numpy as np

    from repro_torch.cache import CacheConfig, make_gqa_page_pool, paged_insert
    from repro_torch.configs import get_config
    from repro_torch.core.formats import get_scheme
    from repro_torch.kernels import attention_template as T
    from repro_torch.models.attention import _mla_scale

    cfg = get_config("minicpm3-4b")
    if not full:
        cfg = cfg.reduced()
    g, hd, hd_v = cfg.num_heads, cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank
    scale = _mla_scale(cfg)
    B, max_len, page_sizes, chunks = ((8, 1024, (16, 32, 64, 128), (1, 16)) if full
                                      else (4, 64, (8, 4, 32), (1, 4)))
    scheme = get_scheme(K5P_SCHEME)
    rng = np.random.default_rng(9)
    gen = torch.Generator(device=dev).manual_seed(9)
    # slot lengths (after this tick's insert); the last slot is idle
    ends = rng.integers(max_len // 2, max_len + 1, B)
    ends[1], ends[-1] = max_len, 0
    tokens = torch.randn((B, max_len, 1, hd), generator=gen, device=dev).to(torch.bfloat16)

    cases = []                        # (hook, page, chunk, pool, bt, q, lengths)
    for page in page_sizes:
        MP = max_len // page
        bt = torch.as_tensor(rng.permutation(B * MP).reshape(B, MP).astype(np.int32),
                             device=dev)
        for hook, kind in (("bf16", "paged_bf16"), ("ams", "paged_ams")):
            ccfg = CacheConfig(kind=kind, page_size=page, num_pages=B * MP,
                               max_pages_per_seq=MP, kv_scheme=K5P_SCHEME)
            pool = make_gqa_page_pool(ccfg, 1, hd, device=dev)
            # one insert of every slot's tokens; the stream path never reads v
            paged_insert(pool, tokens, tokens, torch.zeros(B, dtype=torch.int32, device=dev),
                         bt, ccfg, nvalid=torch.as_tensor(ends, dtype=torch.int32, device=dev))
            pool = {"k": pool["k"]}
            for c in chunks:
                lengths = _chunk_lengths(np, rng, ends, c)
                q = torch.randn((B, c, g, hd), generator=gen, device=dev).to(torch.bfloat16)
                cases.append((hook, page, c, pool, bt, q, lengths))

    # the entry a user calls, every case once, launch counts zeroed around it
    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    entry_out = [T.fused_paged_attention(
        q, pool, torch.as_tensor(lengths, device=dev), bt, page_size=page,
        kv_scheme=K5P_SCHEME if hook == "ams" else None, value_slice=hd_v, scale=scale)
        for hook, page, c, pool, bt, q, lengths in cases]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {cnt.name: cnt.launches for cnt in counts}
    plain_cuda = {cnt.name: cnt.plain_on_cuda for cnt in counts}
    log("K5p entry " + json.dumps(dict(cases=len(cases), launches=launches,
                                       plain_calls_on_cuda=plain_cuda)))
    if dev.type == "cuda":
        want = {name: sum(1 for case in cases if case[0] == hook)
                for hook, name in K5P_KERNELS.items()}
        if any(launches[k] != n for k, n in want.items()) or \
                sum(launches.values()) != len(cases) or max(plain_cuda.values()) != 0:
            fail(f"K5p: the entry did not launch each hook's kernel once per case: {launches}, "
                 f"plain versions on CUDA tensors: {plain_cuda}")

    rows, max_err, decode = [], {"bf16": 0.0, "ams": 0.0}, {}
    for (hook, page, c, pool, bt, q, lengths), o_entry in zip(cases, entry_out):
        qf, lens, chunked, dims = T._fold_q(q, torch.as_tensor(lengths, device=dev), 1, scale)
        kw = dict(page_size=page, c=c, g=g, hd_v=hd_v)
        if hook == "bf16":
            kernel, plain = T.paged_attention_stream_bf16, T.paged_attention_stream_bf16_plain
        else:
            kernel, plain = T.paged_attention_stream_ams, T.paged_attention_stream_ams_plain
            kw["scheme"] = scheme
        o_k = kernel(qf, pool, lens, bt, **kw)
        o_p = plain(qf, pool, lens, bt, **kw)
        err = float((o_k - o_p).abs().max())
        ymax = float(o_p.abs().max())
        if hook == "bf16":            # K3's rule: p rounded to bf16 in both
            tol = K3_P_ULP * float(pool["k"][..., :hd_v].float().abs().max()) + K3_TOL * ymax
        else:
            tol = K2_TOL * max(ymax, 1e-30)
        max_err[hook] = max(max_err[hook], err)
        masked = torch.as_tensor(np.repeat(lengths == 0, g, axis=1), device=dev)  # [B, c*g]
        zero_ok = bool((o_k.permute(0, 2, 1, 3)[masked] == 0).all())
        same = bool(torch.equal(T._unfold_o(o_k, dims, chunked, q.dtype), o_entry))
        if not (err <= tol and zero_ok and same and torch.isfinite(o_k).all()):
            fail(f"K5p {hook} page={page} chunk={c}: max abs err {err:.3e} > {tol:.3e}, masked "
                 f"rows not exact zeros ({zero_ok}) or the entry's output differs ({same})")
        tok = int(np.sum(np.max(lengths, axis=1)))        # keys each slot's walk needs
        per_token = 2 * hd if hook == "bf16" else (
            pool["k"]["hi"].shape[-1] + 4 * pool["k"]["lsb"].shape[-1] + 4)
        nbytes = (qf.numel() * 4 + tok * per_token + bt.numel() * 4 + lens.numel() * 4
                  + o_k.numel() * 4)
        # q holds bf16 values (scaled in bf16); p.v in f32 on AMS pages
        pv_peak = PEAK_BF16_FLOPS if hook == "bf16" else PEAK_F32_FLOPS
        bms, by = bound_ms(nbytes, *attention_work(hd, hd_v, g * float(lengths.sum()),
                                                    PEAK_BF16_FLOPS, pv_peak))
        row = dict(hook=hook, page=page, chunk=c, heads=g, hd=hd, hd_v=hd_v, slots=B,
                   lengths_max=int(lengths.max()), bytes_per_token=per_token,
                   max_abs_err=err, tolerance=tol, exact_zero_rows=int(masked.sum()),
                   entry_equals_kernel=same, bound_ms=bms, bound_by=by)
        if timed:
            leaf = pool["k"]
            n = max(1, min(64, math.ceil(L2_FLUSH_BYTES / max(1, tok * per_token))))
            copies = [pool] + [{"k": leaf.clone() if hook == "bf16" else
                                {k: t.clone() for k, t in leaf.items()}} for _ in range(n - 1)]
            outs = []
            row["ms"] = time_graph(torch, [
                (lambda p=p: outs.append(kernel(qf, p, lens, bt, **kw))) for p in copies])
            outs.clear()
            del copies
            row["plain_ms"] = time_loop(torch, lambda: plain(qf, pool, lens, bt, **kw))
            row["factor_over_bound"] = row["ms"] / bms
        rows.append(row)
        if page == page_sizes[0] and c == 1:
            decode[hook] = row
        log("K5p " + json.dumps(row))
    return decode, max_err, {hook: launches[name] for hook, name in K5P_KERNELS.items()}


# ------------------------------------------------------------- main path
def all_counts():
    from repro_torch.kernels import ams_matmul, attention_template
    return (ams_matmul.COUNT, ams_matmul.COUNT_PLANES, attention_template.COUNT,
            attention_template.COUNT_BF16, attention_template.COUNT_CONTIG,
            attention_template.COUNT_MLA, attention_template.COUNT_STREAM_BF16,
            attention_template.COUNT_STREAM_AMS)


def _prefix_embeds(np, rng, cfg, n: int):
    """Seeded standard-normal modality prefix embeddings [n_prefix, d_model]
    for each of ``n`` requests (None each where the config takes none)."""
    if not cfg.num_prefix_embeds:
        return [None] * n
    return [rng.standard_normal((cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
            for _ in range(n)]


def phase_serve(torch, dev, full: bool, path: str = "fp5.33"):
    """Serve one main path through the engine (see the module docstring);
    the FP5.33 path keeps slice 1's workload, the others a shorter one. A
    shared prompt prefix is given to the paged paths whose requests are
    tokens only (the contiguous cache has no prefix cache, as in the
    reference, and a request with prefix embeds skips it). The VLM path's
    requests each carry 256 seeded normal prefix embeddings and 32-96 text
    tokens, and each stream must equal that request served alone. The
    one-token paths (`ssm-*` and `hybrid-*`, recurrent states) serve 9
    requests of 32-96 tokens, two of them seeded sampled requests, so the
    sampled graph is captured while the others hold live states; on the
    FP5.33 ones each stream must then equal the request served alone (with
    its request id, which the draw key folds), on the FP16 ones the
    comparison is printed (cuBLAS gives a row other bits at other row
    counts)."""
    import itertools

    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.sampling import SamplingParams

    spec = PATHS[path]
    paged = spec["kind"] != "contiguous"
    ssm = spec.get("chunk") == 1       # the one-token step: recurrent states
    if full:
        depth = None if path == MAIN_PATH else spec.get("serve_depth", SERVE_CUT_DEPTH)
        ec = EngineConfig(arch=spec["arch"], reduced=False, depth=depth,
                          scheme=spec["scheme"], impl="kernel", slots=8, capacity=512,
                          prefill_chunk=spec.get("chunk", 16),
                          cache=CacheConfig(kind=spec["kind"], page_size=16, impl="kernel"),
                          device=str(dev), seed=0)
        n_req, plen, max_tokens, shared = {"fp5.33": (10, (200, 320), 40, 128),
                                           "vlm-fp5.33": (9, (32, 97), 24, 0)}.get(
                                               path, (9, (32, 97), 24, 0) if ssm
                                               else (9, (96, 192), 24, 64))
    else:
        ec = EngineConfig(arch=spec["arch"], reduced=True, scheme=spec["scheme"],
                          impl="kernel", slots=4, capacity=64,
                          prefill_chunk=spec.get("chunk", 4),
                          cache=CacheConfig(kind=spec["kind"], page_size=8, impl="kernel"),
                          device=str(dev), seed=0)
        n_req, plen, max_tokens, shared = 6, (12, 24), 8, 8
    gc.collect()                       # engines of earlier phases (see below)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    eng = ServeEngine(ec)
    log(f"serve[{path}]: quantize_seconds={eng.quantize_seconds:.3f} "
        f"layers={eng.cfg.num_layers} d_model={eng.cfg.d_model} d_ff={eng.cfg.d_ff} "
        f"vocab={eng.cfg.vocab_size}")
    wbytes = weight_bytes(eng.params)
    log("weights " + json.dumps(dict(path=path, arch=spec["arch"], scheme=spec["scheme"],
                                     depth=eng.cfg.num_layers, bytes=wbytes,
                                     floor_ms=1e3 * wbytes["total"] / PEAK_BYTES_PER_S)))
    rng = np.random.default_rng(1234)
    V = eng.cfg.vocab_size
    prompts = [rng.integers(0, V, int(n)).astype(np.int32)
               for n in rng.integers(plen[0], plen[1], n_req)]
    embeds = _prefix_embeds(np, rng, eng.cfg, n_req)
    shared = shared if embeds[0] is None else 0
    if paged and shared:
        prompts[-1][:shared] = prompts[0][:shared]   # page-aligned shared prefix, admitted late

    # the Mamba paths: requests 2 and 5 sample (seeded)
    sampling = [SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=i)
                if ssm and i in (2, 5) else None for i in range(n_req)]

    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_tokens, prefix_embeds=e, sampling=sp)
               for p, e, sp in zip(prompts, embeds, sampling)]
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
    res = dict(path=path, arch=spec["arch"], scheme=spec["scheme"], cache=spec["kind"],
               requests=len(handles),
               ticks=st["ticks"], tokens=st["tokens_generated"],
               wall_s=wall, decode_tokens_per_s=(dec_tok / dec_s if dec_s else 0.0),
               decode_ticks=dec_ticks,
               decode_active_slots_mean=(dec_tok / dec_ticks if dec_ticks else 0.0),
               decode_tick_ms=(1e3 * dec_s / dec_ticks if dec_ticks else 0.0),
               decode_ms_median=st["decode_ms_median"], launches=launches,
               plain_calls_on_cuda=plain_cuda, prefix_hit_pages=st.get("prefix_hit_pages"),
               cached_token_frac=st.get("cached_token_frac"),
               quantize_seconds=eng.quantize_seconds,
               kv_bytes_per_token=st["kv_bytes_per_token"],
               prefix_embeds_per_request=eng.cfg.num_prefix_embeds if embeds[0] is not None else 0,
               prompt_tokens=[int(len(p)) for p in prompts])
    if dev.type == "cuda":
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        res["graph"] = graph_stats(eng)
    if ssm:
        res["sampled_requests"] = sum(sp is not None for sp in sampling)
        res["sampled_graph_captured"] = dev.type != "cuda" or (1, True) in eng.graphs.graphs
    log("serve " + json.dumps(res))
    if ssm and not res["sampled_graph_captured"]:
        fail(f"serve[{path}]: the sampled graph was never captured")
    bad = [h.rid for h in handles if not h.done or len(h.tokens) != max_tokens
           or not all(0 <= t < V for t in h.tokens)]
    if bad:
        fail(f"serve[{path}]: requests {bad} did not finish with {max_tokens} valid tokens")
    if dev.type == "cuda":
        idle = [k for k in spec["kernels"] if launches[k] <= 0]
        stray = [k for k, n in launches.items() if n and k not in spec["kernels"]]
        if idle or stray:
            fail(f"serve[{path}]: kernels of the path that never launched {idle}, kernels "
                 f"of other paths that did {stray}: {launches}")
        if max(plain_cuda.values()) != 0:
            fail(f"serve[{path}]: plain versions ran on CUDA tensors: {plain_cuda}")
    if paged and shared and st["prefix_hit_pages"] < 1:
        fail(f"serve[{path}]: the shared prefix never hit the prefix cache")
    if embeds[0] is not None or ssm or spec.get("alone"):
        # each request served alone on the same engine; a sampled one with
        # its own request id, which the draw key folds
        alone, fresh = [], eng._rid
        for h, p, e, sp in zip(handles, prompts, embeds, sampling):
            if sp is not None:
                eng._rid = itertools.count(h.rid)
            alone.append(eng.submit(p, max_tokens, prefix_embeds=e, sampling=sp).result())
            eng._rid = fresh
        first = [next((t for t, (a, b) in enumerate(zip(h.tokens, x)) if a != b), None)
                 for h, x in zip(handles, alone)]
        log("serve-alone " + json.dumps(dict(path=path, requests=len(alone),
                                              streams_equal=all(f is None for f in first),
                                              first_diverging_token=first)))
        if (dev.type == "cuda" and spec["scheme"] != "fp16"
                and any(f is not None for f in first)):
            fail(f"serve[{path}]: streams differ from the requests served alone: first "
                 f"diverging tokens {first}")
    if dev.type == "cuda":
        res["profile"] = profile_decode(torch, eng, rng, path)
    else:                              # rehearse the profile's prefill at tiny lengths
        fill_for_decode(eng, rng, (eng.capacity // 4, eng.capacity // 2), 7)
        for _ in range(7):
            eng.step()
        if eng.active_count != eng.slots:
            fail(f"serve[{path}]: {eng.active_count} of {eng.slots} slots decoded")
        eng.run()
    # the engine's metrics hold closures over it: free the cycle now, so the
    # next path's peak memory counts only its own tensors
    del eng, handles
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def weight_bytes(params):
    """Bytes of the weights one decode step reads: every per-layer leaf
    (packed projections with their scales, norms) and the lm_head; the
    embedding table is gathered a row per token, so it is left out."""
    from repro_torch.core.tree import tree_leaves

    def total(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    layers = total(params["layers"]) + total(params.get("tail", {}))
    head = total(params["lm_head"])
    return dict(layers=layers, lm_head=head, total=layers + head)


PROFILE_PROMPT = (200, 340)      # prompt tokens of the profiled requests: the served range
# windows of graph ticks traced at most per path: the profiler can miss
# device records of a window (1-129 a window before `trace_window`), so a
# window that missed a path kernel's launch is logged and traced anew; the
# check fails when none of them saw exactly what the counts added
PROFILE_TRACES = 3


def fill_for_decode(eng, rng, prompt, decode_ticks: int):
    """Submit one request per slot with a prompt of ``prompt`` = (lo, hi)
    tokens and run the ticks that admit and prefill them, so that every
    slot then decodes for ``decode_ticks`` more ticks: a request may
    generate while longer prompts still prefill, so each may generate as
    many tokens as the prefill ticks of the two lengths differ, on top.
    Returns the prefill ticks."""
    V = eng.cfg.vocab_size
    spread = -(-prompt[1] // eng.chunk) - (-(-prompt[0] // eng.chunk))
    max_tokens = decode_ticks + spread + 2
    if not prompt[1] + max_tokens <= eng.capacity:
        raise ValueError(f"capacity {eng.capacity} does not hold the profiled prompts")
    for n in rng.integers(prompt[0], prompt[1] + 1, eng.slots):
        eng.submit(rng.integers(0, V, int(n)).astype("int32"), max_tokens)
    ticks = 0
    while len(eng.sched) or any(r is not None and eng.fed[s] < r.prompt_len
                                for s, r in enumerate(eng.active)):
        eng.step()
        ticks += 1
    if eng.active_count != eng.slots:
        fail(f"only {eng.active_count} of {eng.slots} slots decode after the prefill")
    return ticks


def graph_stats(eng):
    """Capture seconds per chunk width and the bytes of the engine's graph
    memory pool."""
    return dict(capture_seconds={f"{w}/{'sampled' if sp else 'greedy'}": t
                                 for (w, sp), t in eng.graphs.capture_seconds.items()},
                pool_bytes=eng.graphs.pool_bytes)


# the symbol of each counted kernel, as the profiler names its launches
KERNEL_SYMBOLS = {"ams_matmul_fp533": "ams_matmul_mma_kernel",
                  "ams_matmul_planes": "ams_matmul_mma_kernel",
                  "paged_attention_ams": "k2_kernel", "paged_attention_bf16": "k3_kernel",
                  "contiguous_attention": "k4_kernel", "contiguous_attention_mla": "k5_kernel"}


def _profiled_ticks(torch, eng, ticks: int, eager: bool, path: str):
    """``ticks`` decode ticks under torch.profiler, after one warm-up tick
    that is traced and dropped (`obs.cost.trace_window`): device-busy ms and
    idle share per tick, the device's idle time between events inside
    ticks, kernels per tick, the top kernels, and each path kernel's
    launches as the profiler saw them (in all, and in each tick: a device
    record goes to the last tick launched on the host before it began) and
    as the counts add up. ``clock_us``: how far the first device record
    starts before the host's first launch and the last one ends after the
    host saw the device finish (both negative where the clocks agree)."""
    import bisect

    from repro_torch.obs.cost import device_records, trace_window

    counts = {c.name: c for c in all_counts()}
    before, host = {}, {}

    def run():
        before.update({k: counts[k].launches for k in PATHS[path]["kernels"]})
        host["starts"] = []
        t0 = time.perf_counter()
        for _ in range(ticks):
            host["starts"].append(time.time_ns())
            eng.step(eager=eager)
        torch.cuda.synchronize()
        host["wall"] = time.perf_counter() - t0
        host["end"] = time.time_ns()

    prof, _ = trace_window(run, lambda: eng.step(eager=eager))
    wall = host["wall"]
    kernels = {}
    busy = 0.0
    spans = []
    device = device_records(prof)
    for ev in device:
        us = ev.time_range.elapsed_us()
        busy += us
        spans.append((ev.time_range.start, ev.time_range.end))
        n, t = kernels.get(ev.name, (0, 0.0))
        kernels[ev.name] = (n + 1, t + us)
    # device idle between consecutive device events; the ``ticks`` - 1
    # widest gaps are the host's work between ticks, the rest lie inside
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append(a - end)
        end = b if end is None else max(end, b)
    inside = sorted(gaps)[:max(0, len(gaps) - (ticks - 1))]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    seen = {k: sum(n for name, (n, _) in kernels.items() if KERNEL_SYMBOLS[k] in name) / ticks
            for k in before}
    counted = {k: (counts[k].launches - before[k]) / ticks for k in before}
    # the records' times in ns since the epoch, as the host's clock reads
    base = prof.profiler.kineto_results.trace_start_ns()
    starts = [base + 1e3 * ev.time_range.start for ev in device]
    ends = [base + 1e3 * ev.time_range.end for ev in device]
    by_tick = {k: [0] * ticks for k in before}
    for ev, t in zip(device, starts):
        i = max(0, bisect.bisect_right(host["starts"], t) - 1)
        for k in before:
            by_tick[k][i] += KERNEL_SYMBOLS[k] in ev.name
    clock = dict(first_start_before_launch=(host["starts"][0]
                                            - min(starts, default=host["starts"][0])) / 1e3,
                 last_end_after_sync=(max(ends, default=host["end"]) - host["end"]) / 1e3)
    return dict(wall_ms_per_tick=1e3 * wall / ticks,
                device_busy_ms_per_tick=busy / 1e3 / ticks,
                device_idle_share=max(0.0, 1 - busy / 1e6 / wall),
                kernels_per_tick=sum(n for n, _ in kernels.values()) / ticks,
                gaps_inside_ticks_ms_per_tick=sum(inside) / 1e3 / ticks,
                path_launches_per_tick=dict(profiler=seen, counted=counted),
                path_launches_by_tick=by_tick, clock_us=clock,
                top=[dict(name=k[:80], launches_per_tick=n / ticks, ms_per_tick=t / 1e3 / ticks)
                     for k, (n, t) in top])


def profile_decode(torch, eng, rng, path: str, ticks: int = 3, timed: int = 5):
    """Pure-decode ticks with every slot decoding, over the context lengths
    the served workloads reach (prompts of 200-340 tokens, prefilled
    first): graph ticks (`ServeEngine.step`, a CUDA graph replay) and eager
    ticks (`step(eager=True)`, the step function on the same static inputs)
    timed in turns over the same state (decode tick ms and tokens/s at a
    full batch), the device time of one graph replay from CUDA events, then
    both under torch.profiler (device-busy ms, idle share, kernels per
    tick), with the path kernels' launches per tick as the profiler saw
    them, which must equal the counts the graph ticks added (a window that
    missed records is traced anew, up to `PROFILE_TRACES` windows); the
    nodes of each path kernel in the step's graph (`graph_path_nodes`) must
    equal them too."""
    fill_for_decode(eng, rng, PROFILE_PROMPT,
                    2 * (timed + ticks + 1) + 3 + (PROFILE_TRACES - 1) * (ticks + 1))
    eng.step()
    eng.step(eager=True)
    tick = {False: 0.0, True: 0.0}
    for _ in range(timed):
        for eager in (False, True):
            t0 = time.perf_counter()
            eng.step(eager=eager)
            tick[eager] += time.perf_counter() - t0
    if eng.active_count != eng.slots:
        fail(f"profile[{path}]: {eng.active_count} of {eng.slots} slots decoded")
    # one replay's device time on the last tick's inputs (a replay rewrites
    # the cache entries that tick wrote with the same values; recurrent
    # states, which a replay advances again, are put back)
    from repro_torch.launch.steps import recurrent_states_kept
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with recurrent_states_kept(eng.cache, eng.cfg):
        e0.record()
        for _ in range(timed):
            eng.graphs(1)
        e1.record()
        e1.synchronize()
    replay_ms = e0.elapsed_time(e1) / timed
    decode = dict(path=path, active_slots=eng.active_count, ticks=timed,
                  decode_tick_ms=1e3 * tick[False] / timed,
                  eager_tick_ms=1e3 * tick[True] / timed, replay_ms=replay_ms,
                  # the share of a graph tick spent outside its replay's
                  # device span (staging, launch, read-back, bookkeeping)
                  outside_replay_share=1 - replay_ms / (1e3 * tick[False] / timed),
                  decode_tokens_per_s=eng.active_count * timed / tick[False],
                  eager_tokens_per_s=eng.active_count * timed / tick[True])
    log("decode " + json.dumps(decode))
    # keys each decoding slot attends over in the profiled ticks
    keys = [int(eng.fed[s]) + 1 + i for i in range(2 * (ticks + 1))
            for s, r in enumerate(eng.active) if r is not None]
    res = dict(path=path, ticks=ticks, context_keys=[min(keys), max(keys)])
    for trace in range(1, PROFILE_TRACES + 1):
        res["graph"] = g = _profiled_ticks(torch, eng, ticks, False, path)
        if _profiler_saw_the_counts(g):
            break
        # a trace that missed device records: log it and trace a new window
        log("profile-retrace " + json.dumps(dict(
            path=path, trace=trace, kernels_per_tick=g["kernels_per_tick"],
            path_launches_per_tick=g["path_launches_per_tick"],
            path_launches_by_tick=g["path_launches_by_tick"], clock_us=g["clock_us"])))
    res["graph_traces"] = trace
    res["eager"] = _profiled_ticks(torch, eng, ticks, True, path)
    if eng.active_count != eng.slots:
        fail(f"profile[{path}]: {eng.active_count} of {eng.slots} slots decoded while profiled")
    # the roofline floor of a full decode tick beside a profiled graph replay
    # of it (obs.cost.attribution's stand-in for the reference's HLO cost)
    from repro_torch.obs import attribution
    att = attribution(eng, profile=True)
    log("attribution " + json.dumps(dict(path=path, **att)))
    res["floor_share"] = att["profile_floor_share"]
    eng.run()
    log("profile " + json.dumps(res))
    g = res["graph"]
    if g["kernels_per_tick"] <= 0:
        fail(f"profile[{path}]: the profiler saw no kernel of the graph replays")
    seen, counted = g["path_launches_per_tick"]["profiler"], g["path_launches_per_tick"]["counted"]
    nodes, captured = graph_path_nodes(torch, eng, path)
    log("graph-nodes " + json.dumps(dict(path=path, nodes=nodes, capture_counts=captured,
                                         replay_counts_per_tick=counted, profiler_per_tick=seen)))
    # the profiler, the device's own record, must have seen every launch the
    # counts added; each replay launches the graph's nodes, and the counts
    # must add exactly those
    if not _profiler_saw_the_counts(g):
        fail(f"profile[{path}]: launches per graph tick: profiler {seen}, counts {counted} "
             f"(by tick {g['path_launches_by_tick']}, clocks {g['clock_us']} us)")
    if nodes != captured or nodes != counted:
        fail(f"profile[{path}]: path-kernel nodes of the step's graph {nodes}, counts per "
             f"capture {captured} and per replayed tick {counted}")
    res.update(decode)
    return res


def _profiler_saw_the_counts(g) -> bool:
    """Whether a profiled window of graph ticks (`_profiled_ticks`) saw
    kernels, and each path kernel as often per tick as the counts added
    (at least once)."""
    seen, counted = g["path_launches_per_tick"]["profiler"], g["path_launches_per_tick"]["counted"]
    return g["kernels_per_tick"] > 0 and seen == counted and min(counted.values(), default=1) > 0


def graph_path_nodes(torch, eng, path: str):
    """The path kernels' nodes in a CUDA graph of the width-1 step, captured
    once more as `GraphedStep` captures it (never replayed) and read from
    CUDA's graph debug dump, beside the launch counts that capture moved:
    what a replay launches, read from the graph itself rather than from a
    trace."""
    import tempfile

    from repro_torch.kernels.build import recorded_counts
    from repro_torch.launch.steps import run_step

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    collecting = gc.isenabled()
    gc.disable()                # as GraphedStep.capture: no collection mid-capture
    try:
        with recorded_counts() as moved:
            with torch.cuda.graph(graph, stream=s):
                run_step(eng._step, eng.params, eng.cache, eng.inputs, eng.samp, 1)
    finally:
        if collecting:
            gc.enable()
    with tempfile.TemporaryDirectory() as d:
        graph.debug_dump(str(Path(d) / "step.dot"))
        dot = (Path(d) / "step.dot").read_text()
    del graph
    kernels = PATHS[path]["kernels"]
    nodes = {k: dot.count(KERNEL_SYMBOLS[k]) for k in kernels}
    return nodes, {k: sum(n for c, n, _ in moved if c.name == k) for k in kernels}


def phase_graph(torch, dev, full: bool, path: str = "fp5.33"):
    """Graph replays against the eager step at cut depth (`CUT_DEPTH` at full
    width, or the path's ``depth``: the hybrid's one repeat, 3 layers; 2 on
    MoE): two engines from one seed serve the same requests in lockstep
    (prefill and decode ticks mixed), one replaying its CUDA graphs, the
    other running the step function (`step(eager=True)`); tokens after
    every tick and every cache byte at the end must be equal (on the VLM
    path each request feeds its prefix embeds through the graphs' static
    embeds buffer). Then one eager step runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import dataclasses

    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.steps import run_step
    from repro_torch.core.tree import tree_leaves

    spec = PATHS[path]
    gc.collect()           # engines of earlier phases (a handle of the last serve's)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    base = (dict(reduced=False, depth=spec.get("depth", CUT_DEPTH), slots=4, capacity=256,
                 prefill_chunk=spec.get("chunk", 16))
            if full else dict(reduced=True, slots=2, capacity=64,
                              prefill_chunk=spec.get("chunk", 4)))
    ec = EngineConfig(arch=spec["arch"], scheme=spec["scheme"], impl="kernel",
                      cache=CacheConfig(kind=spec["kind"], page_size=16 if full else 8,
                                        impl="kernel"),
                      device=str(dev), seed=11, **base)
    ec = dataclasses.replace(ec, capacity=ec.capacity + ec.model_config().num_prefix_embeds)
    graphed, eager = ServeEngine(ec), ServeEngine(ec)
    rng = np.random.default_rng(5)
    V = graphed.cfg.vocab_size
    n_req, plen, gen_n = (6, (20, 120), 12) if full else (3, (5, 14), 4)
    lens = rng.integers(plen[0], plen[1], n_req)
    for n, e in zip(lens, _prefix_embeds(np, rng, graphed.cfg, n_req)):
        p = rng.integers(0, V, int(n)).astype(np.int32)
        graphed.submit(p, gen_n, prefix_embeds=e)
        eager.submit(p, gen_n, prefix_embeds=e)
    ticks, first = 0, None
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        ticks += 1
        a = [list(r.tokens) if r is not None else None for r in graphed.active]
        b = [list(r.tokens) if r is not None else None for r in eager.active]
        if first is None and a != b:
            first = ticks
    streams_equal = [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    caches_equal = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                       for x, y in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)))
    res = dict(path=path, depth=graphed.cfg.num_layers, ticks=ticks,
               requests=len(graphed.finished), prefix_embeds=graphed.cfg.num_prefix_embeds,
               streams_equal=streams_equal,
               caches_equal=caches_equal, first_diverging_tick=first)
    if dev.type == "cuda":
        res["graph"] = graph_stats(graphed)
        torch.cuda.synchronize()
        graphed.inputs.send()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_step(graphed._step, graphed.params, graphed.cache, graphed.inputs,
                     graphed.samp, graphed.step_chunk)
        except RuntimeError as e:
            fail(f"graph[{path}]: the eager step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        res["sync_free_step"] = True
    log("graph " + json.dumps(res))
    if not (streams_equal and caches_equal and first is None):
        fail(f"graph[{path}]: graph replays and the eager step differ: {res}")
    del graphed, eager
    gc.collect()
    return res


def phase_consistency(torch, dev, full: bool, path: str = "fp5.33", page: int = 0,
                      scheme: str = ""):
    """``page``: the paged cache's page size (0: 16 at full width, 8 tiny);
    ``scheme``: weights other than the path's (its kernels the same)."""
    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine, init_serving_params
    from repro_torch.models import decode_step, make_cache
    from repro_torch.models.moe import record_routes

    arch, kind = PATHS[path]["arch"], PATHS[path]["kind"]
    scheme = scheme or PATHS[path]["scheme"]
    page = page or (16 if full else 8)

    def config(impl, attn):
        base = (dict(reduced=False, depth=PATHS[path].get("depth", CUT_DEPTH), slots=4,
                     capacity=256,
                     prefill_chunk=PATHS[path].get("chunk", 16),
                     cache=CacheConfig(kind=kind, page_size=page, impl=attn))
                if full else
                dict(reduced=True, slots=2, capacity=64, prefill_chunk=PATHS[path].get("chunk", 4),
                     cache=CacheConfig(kind=kind, page_size=page, impl=attn)))
        return EngineConfig(arch=arch, scheme=scheme, impl=impl,
                            device=str(dev), seed=7, **base)

    def policy(ec):
        return (None if scheme == "fp16" else
                QuantPolicy(scheme=scheme, impl=ec.impl, min_elements=1 << 10))

    ck, cr = config("kernel", "kernel"), config("fused_ref", "ref")
    cfg = ck.model_config()
    params = init_serving_params(cfg, policy(ck), 7, dev)
    rng = np.random.default_rng(99)
    n_req, plen, gen_n = (4, 48, 24) if full else (2, 12, 8)
    prompts = rng.integers(0, cfg.vocab_size, (n_req, plen)).astype(np.int32)

    # first-tick logits of one ragged chunk (one token on a one-token
    # engine) through both impl pairs
    C = ck.prefill_chunk
    logits, routes = {}, {}
    for ec in (ck, cr):
        ccfg = ec.sized_cache()
        cache = make_cache(cfg, n_req, ec.capacity, cache_cfg=ccfg, device=dev)
        bt = (torch.arange(n_req * ccfg.max_pages_per_seq, dtype=torch.int32,
                           device=dev).reshape(n_req, -1) if ccfg.paged else None)
        tok = torch.as_tensor(prompts[:, :C] if C > 1 else prompts[:, 0], device=dev)
        nvalid = torch.full((n_req,), C, dtype=torch.int32, device=dev) if C > 1 else None
        with record_routes() as routes[ec.impl]:
            lg, _ = decode_step(params, tok, cache, torch.zeros(n_req, dtype=torch.int32,
                                                                 device=dev), cfg,
                                policy=policy(ec), block_tables=bt, cache_cfg=ccfg,
                                nvalid=nvalid)
        logits[ec.impl] = lg.float()
    d = float((logits["kernel"] - logits["fused_ref"]).abs().max())
    rel = d / float(logits["fused_ref"].abs().max())
    same_argmax = bool((logits["kernel"].argmax(-1) == logits["fused_ref"].argmax(-1)).all())

    streams, launches = {}, {}
    for ec in (ck, cr):
        eng = ServeEngine(ec, params=params)
        hs = [eng.submit(p, gen_n) for p in prompts]
        counts = all_counts()
        for cnt in counts:
            cnt.reset()
        eng.run()
        streams[ec.impl] = [h.tokens for h in hs]
        if ec is ck:
            launches = {cnt.name: cnt.launches for cnt in counts if cnt.launches}
    diverge = []
    for i, (a, b) in enumerate(zip(streams["kernel"], streams["fused_ref"])):
        first = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        diverge.append(first)
    res = dict(path=path, scheme=scheme, depth=cfg.num_layers, logits_max_abs_diff=d,
               logits_rel_diff=rel, **routing_differences(torch, routes["kernel"],
                                                          routes["fused_ref"]),
               tolerance=LOGIT_TOL, first_tick_argmax_equal=same_argmax,
               streams_equal=all(x is None for x in diverge),
               first_diverging_token=diverge, kernel_launches=launches)
    if kind != "contiguous":
        res["page_size"] = page
    log("consistency " + json.dumps(res))
    if not rel <= LOGIT_TOL:
        fail(f"consistency[{path}, {scheme}]: first-tick logits differ by {rel:.3e} > "
             f"{LOGIT_TOL}")
    if dev.type == "cuda" and sorted(launches) != sorted(PATHS[path]["kernels"]):
        fail(f"consistency[{path}, {scheme}]: the kernel engine's streams launched "
             f"{launches}, not every kernel of the path and no other")
    return res


def routing_differences(torch, got, want):
    """The MoE router's choices of two lowerings over the same step
    (`moe.record_routes`, one entry per MoE layer): how many (row, layer)
    pairs chose another expert set, and at each the reference's router
    margin (its k-th largest probability less the next one: how near a tie
    it was). Empty for a model without MoE layers."""
    if not want:
        return {}
    pairs = []
    for layer, ((gi, _), (wi, wp)) in enumerate(zip(got, want)):
        k = wi.shape[-1]
        same = (gi.sort(-1).values == wi.sort(-1).values).all(-1)
        top = wp.sort(-1, descending=True).values
        margin = top[:, k - 1] - (top[:, k] if top.shape[-1] > k else 0.0)
        for row in torch.nonzero(~same).flatten().tolist():
            pairs.append(dict(layer=layer, row=row, margin=float(margin[row])))
    return dict(routed_pairs=len(want) * want[0][0].shape[0], routing_differs=len(pairs),
                routing_differences=pairs)


def phase_ring(torch, dev, full: bool):
    """RecurrentGemma's rings past their window: `hybrid-fp5.33` cut to one
    repeat (3 layers, full widths; the reduced config's 64-slot window at
    tiny sizes), two requests of 2100-2300 prompt tokens (68-84 tiny), 16
    new each. A graphed and an eager engine from one seed serve them in
    lockstep: tokens after every tick, and at the end every cache byte
    (conv / recurrent states, ring K / V), must be equal. Then each request
    is served alone on the graphed engine (its request id kept): its
    stream must equal the one served beside the other."""
    import itertools

    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    spec = PATHS["hybrid-fp5.33"]
    base = (dict(reduced=False, depth=spec["depth"], capacity=2400) if full
            else dict(reduced=True, capacity=112))
    ec = EngineConfig(arch=spec["arch"], scheme=spec["scheme"], impl="kernel", slots=2,
                      prefill_chunk=1, cache=CacheConfig(kind="contiguous", impl="kernel"),
                      device=str(dev), seed=13, **base)
    graphed, eager = ServeEngine(ec), ServeEngine(ec)
    W = graphed.cfg.sliding_window
    rng = np.random.default_rng(21)
    lens = rng.integers(W + 52, W + 253, 2) if full else rng.integers(W + 4, W + 21, 2)
    prompts = [rng.integers(0, graphed.cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    gen_n = 16
    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    t0 = time.perf_counter()
    hs = [graphed.submit(p, gen_n) for p in prompts]
    for p in prompts:
        eager.submit(p, gen_n)
    ticks, first = 0, None
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        ticks += 1
        a = [list(r.tokens) if r is not None else None for r in graphed.active]
        b = [list(r.tokens) if r is not None else None for r in eager.active]
        if first is None and a != b:
            first = ticks
    lockstep_s = time.perf_counter() - t0
    launches = {cnt.name: cnt.launches for cnt in counts if cnt.launches}
    streams_equal = [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
    caches_equal = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                       for x, y in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)))
    together = [list(h.tokens) for h in hs]
    del eager
    gc.collect()
    alone, fresh = [], graphed._rid
    for h, p in zip(hs, prompts):
        graphed._rid = itertools.count(h.rid)
        alone.append(graphed.submit(p, gen_n).result())
        graphed._rid = fresh
    firsts = [next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
              for a, b in zip(together, alone)]
    res = dict(path="hybrid-fp5.33", depth=graphed.cfg.num_layers, window=W,
               prompt_tokens=[int(n) for n in lens], new_tokens=gen_n, ticks=ticks,
               lockstep_s=lockstep_s, graph_equals_eager_streams=streams_equal,
               graph_equals_eager_cache_bytes=caches_equal, first_diverging_tick=first,
               alone_equal=all(f is None for f in firsts), first_diverging_token=firsts,
               kernel_launches=launches)
    log("ring " + json.dumps(res))
    if not min(lens) > W:
        fail(f"ring: prompts {lens} do not pass the window {W}")
    if not (streams_equal and caches_equal and first is None):
        fail(f"ring: graph replays and the eager step differ past the window: {res}")
    if any(f is not None for f in firsts):
        fail(f"ring: streams differ from the requests served alone: {firsts}")
    if dev.type == "cuda" and sorted(launches) != sorted(spec["kernels"]):
        fail(f"ring: launched {launches}, not the path's kernels {spec['kernels']} alone")
    del graphed
    gc.collect()
    return res


# ------------------------------------------------- engine-features phase
def _cache_bytes(torch, eng):
    from repro_torch.core.tree import tree_leaves
    return [t.view(torch.uint8).clone() for t in tree_leaves(eng.cache)]


def _same_bytes(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _serve_all(eng, prompts, max_tokens, sampling=None, priority=0):
    hs = [eng.submit(p, max_tokens, sampling=s, priority=priority)
          for p, s in zip(prompts, sampling or [None] * len(prompts))]
    eng.run()
    return [list(h.tokens) for h in hs]


def _timed_ticks(torch, engines, ticks: int):
    """Wall ms per tick of each engine's ``step()``, the engines stepping in
    turns (one tick each per round) for ``ticks`` rounds."""
    total = [0.0] * len(engines)
    for _ in range(ticks):
        for i, eng in enumerate(engines):
            t0 = time.perf_counter()
            eng.step()
            total[i] += time.perf_counter() - t0
    return [1e3 * t / ticks for t in total]


def phase_engine_features(torch, dev, full: bool, params=None):
    """Seeded sampling, preemption with host spill and speculative decoding
    on the FP5.33 path over AMS-e2m2 pages (K1, K2) at full width, one set
    of weights on the card for every engine (depth-2 checks use the first
    two layers' views). Launch counts are zeroed just before and read just
    after. One JSON line per check, each fatal:
      * sampling: 8 requests (temperature 0.8, top-k 50, top-p 0.95,
        distinct seeds, two greedy) through graph and eager engines in
        lockstep at depth 2: tokens every tick and every cache byte equal;
        the same requests (prompts of 17 to 40 tokens) replay bit-equal in
        an engine of 4 slots and chunk 4, whose ticks have other widths;
      * the sampled tick against the greedy one at full depth, 8 slots
        decoding, in turns, and both profiled (device-busy ms per tick: the
        sampling epilogue's ms is their difference);
      * preemption: forced `preempt(slot)` mid-prefill, at the first token
        and mid-decode, greedy and sampled, resumes bit-equal to the
        uninterrupted run; a spill on a page boundary comes back byte-equal;
        a priority overload (the reference benchmark's overload row: 2
        slots, chunk 1, host_spill_pages=64) preempts, resumes and restores,
        with streams equal to the head-of-line run; the host tier serves an
        evicted prefix;
      * speculation at k = 4 with the n-gram drafter: graph ticks of the
        verify and rollback bit-equal to eager ones at depth 2 (tokens and
        cache bytes, drafts accepted and rejected); at full depth the greedy
        streams equal plain decoding's, tokens per step above 1, the accept
        rate and tick ms at the verify width; an 8-slot run timed at its
        verify width;
      * row invariance (`_row_invariance`, after the counts are read): K1,
        K2, the norm, the head and the sampling epilogue give every row the
        bits it gets alone, at every tick width and slot count (on the
        card; the CPU's plain versions are held to the JAX engine instead).
    """
    import numpy as np

    from repro_torch.cache import CacheConfig, extract_pages
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine, init_serving_params
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.core.tree import tree_leaves, tree_map

    path = PATHS["fp5.33"]
    page, cap = (16, 512) if full else (8, 64)
    cuda = dev.type == "cuda"

    def config(depth, slots, chunk, capacity=cap, page_size=page, **kw):
        spill = kw.pop("host_spill_pages", 0)
        return EngineConfig(arch=path["arch"], reduced=not full, depth=depth,
                            scheme=path["scheme"], impl="kernel", slots=slots,
                            capacity=capacity, prefill_chunk=chunk, device=str(dev), seed=0,
                            cache=CacheConfig(kind=path["kind"], page_size=page_size,
                                              impl="kernel", host_spill_pages=spill), **kw)

    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    t_phase = time.perf_counter()
    cfg = config(None, 8, 16).model_config()
    if params is None:
        params = init_serving_params(cfg, QuantPolicy(scheme=path["scheme"], impl="kernel",
                                                      min_elements=1 << 10), 0, dev)
    cut = dict(params, layers={"sub0": tree_map(lambda t: t[:2], params["layers"]["sub0"])})
    V = cfg.vocab_size
    rng = np.random.default_rng(2026)
    results = {}

    def check(name, ok, **res):
        res = dict(check=name, ok=bool(ok), **res)
        log("engine-features " + json.dumps(res))
        results[name] = res
        if not ok:
            fail(f"engine-features[{name}]: {res}")

    # ---------------------------------------------------------- sampling
    samp = [SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=100 + i)
            if i not in (2, 5) else None for i in range(8)]
    prompts = [rng.integers(0, V, int(n)).astype(np.int32)
               for n in rng.integers(17, 41, 8)]
    gen_n = 24 if full else 8
    graphed, eager = ServeEngine(config(2, 8, 16), params=cut), ServeEngine(config(2, 8, 16),
                                                                               params=cut)
    hg = [graphed.submit(p, gen_n, sampling=s) for p, s in zip(prompts, samp)]
    he = [eager.submit(p, gen_n, sampling=s) for p, s in zip(prompts, samp)]
    first, ticks = None, 0
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        ticks += 1
        if first is None and [h.tokens for h in hg] != [h.tokens for h in he]:
            first = ticks
    streams = [list(h.tokens) for h in hg]
    check("sampling-graph-vs-eager", first is None and _same_bytes(
        torch, _cache_bytes(torch, graphed), _cache_bytes(torch, eager)),
        depth=2, ticks=ticks, first_diverging_tick=first,
        sampled_rows=sum(s is not None for s in samp),
        distinct_streams=len({tuple(s) for s in streams}),
        graphs=sorted(f"{w}/{'sampled' if sp else 'greedy'}" for w, sp in graphed.graphs.graphs)
        if cuda else None)
    if len({tuple(s) for s in streams}) < 8:
        fail(f"engine-features: sampled streams are not distinct: {streams}")
    del graphed, eager
    # 4 slots and chunk 4: every prompt spans several chunks, and a row's
    # ticks are other widths and hold other rows than in the 8-slot run
    replay = _serve_all(ServeEngine(config(2, 4, 4), params=cut), prompts, gen_n, samp)
    check("sampling-replay-4-slots-chunk-4", replay == streams, depth=2,
          first_diverging_token=[next((t for t, (a, b) in enumerate(zip(x, y)) if a != b), None)
                                 for x, y in zip(replay, streams)])

    # the sampled tick against the greedy one, full depth, every slot decoding
    if full:
        n_timed, prompt = 5, PROFILE_PROMPT
    else:
        n_timed, prompt = 2, (8, 16)
    engs = []
    for sampled in (False, True):
        eng = ServeEngine(config(None, 8, 16), params=params)
        r2 = np.random.default_rng(7)
        spread = -(-prompt[1] // 16) - (-(-prompt[0] // 16))
        for i, n in enumerate(r2.integers(prompt[0], prompt[1] + 1, 8)):
            sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i) if sampled else None
            eng.submit(r2.integers(0, V, int(n)).astype(np.int32), 2 * n_timed + spread + 12,
                       sampling=sp)
        while len(eng.sched) or any(r is not None and eng.fed[s] < r.prompt_len
                                    for s, r in enumerate(eng.active)):
            eng.step()
        eng.step()
        engs.append(eng)
    tick_ms = _timed_ticks(torch, engs, n_timed)
    res = dict(depth=cfg.num_layers, slots=8, greedy_tick_ms=tick_ms[0],
               sampled_tick_ms=tick_ms[1], added_ms=tick_ms[1] - tick_ms[0])
    if cuda:
        prof = [_profiled_ticks(torch, eng, 3, False, "fp5.33") for eng in engs]
        res.update(greedy_busy_ms=prof[0]["device_busy_ms_per_tick"],
                   sampled_busy_ms=prof[1]["device_busy_ms_per_tick"],
                   epilogue_device_ms=prof[1]["device_busy_ms_per_tick"]
                   - prof[0]["device_busy_ms_per_tick"],
                   greedy_kernels_per_tick=prof[0]["kernels_per_tick"],
                   sampled_kernels_per_tick=prof[1]["kernels_per_tick"],
                   greedy_path_launches=prof[0]["path_launches_per_tick"]["counted"],
                   sampled_path_launches=prof[1]["path_launches_per_tick"]["counted"],
                   sampled_top=prof[1]["top"][:8])
    full_batch = all(e.active_count == 8 for e in engs)
    for eng in engs:
        eng.run()
    check("sampled-vs-greedy-tick", full_batch, **res)
    del engs

    # ---------------------------------------------------------- preemption
    pr_prompt = rng.integers(0, V, 40 if full else 13).astype(np.int32)
    pchunk = 16 if full else 4
    prefill_ticks = -(-len(pr_prompt) // pchunk)
    for sp in (None, SamplingParams(temperature=0.8, top_k=16, seed=42)):
        want = ServeEngine(config(2, 2, pchunk), params=cut).submit(
            pr_prompt, 12, sampling=sp).result()
        got = []
        for before in (1, prefill_ticks, prefill_ticks + 4):
            eng = ServeEngine(config(2, 2, pchunk), params=cut)
            h = eng.submit(pr_prompt, 12, sampling=sp)
            for _ in range(before):
                eng.step()
            eng.preempt(h.request.slot)
            if h.status != "preempted" or h.request.spill is None:
                fail(f"engine-features: preempt left status {h.status}")
            got.append((before, h.result() == want, eng.stats()["preemptions"],
                        eng.stats()["resumes"], eng.stats()["spill_pages"]))
        check(f"preempt-resume-{'sampled' if sp else 'greedy'}",
              all(ok and p == r == 1 for _, ok, p, r, _ in got), depth=2,
              runs=[dict(ticks_before=b, equal=ok, spill_pages=n) for b, ok, _, _, n in got])

    # a spill on a page boundary comes back byte-equal
    eng = ServeEngine(config(2, 2, pchunk), params=cut)
    h = eng.submit(rng.integers(0, V, 3 * page).astype(np.int32), 6)
    while eng.fed[h.request.slot] < 2 * page:
        eng.step()
    req = h.request
    eng.preempt(req.slot)
    sp = req.spill
    spilled = [t.clone() for t in tree_leaves(sp.content)]
    h.result()
    restored = tree_leaves(extract_pages(eng.cache, req.pages[sp.n_keep:sp.n_keep + sp.n_pages]))
    check("spill-round-trip-bytes", sp.n_pages == 2 and _same_bytes(
        torch, [t.view(torch.uint8) for t in spilled], [t.view(torch.uint8) for t in restored]),
        spilled_pages=sp.n_pages, spill_bytes=sp.nbytes)

    # priority overload: the reference benchmark's overload row at depth 2
    orng = np.random.default_rng(0)
    batch = [(0, orng.integers(0, V, 10), 24) for _ in range(3)]
    inter = [(int(t), orng.integers(0, V, 4), 4)
             for t in np.cumsum(orng.geometric(0.12, 5)) + 2]

    def overload(priority):
        eng = ServeEngine(config(2, 2, 1, capacity=48, page_size=8, host_spill_pages=64),
                          params=cut)
        work = sorted([(t, 0, p, m, 0) for t, p, m in batch]
                      + [(t, 1, p, m, priority) for t, p, m in inter], key=lambda w: w[0])
        hs = []
        while work or eng.has_work:
            while work and work[0][0] <= eng.tick:
                t, inter_, p, m, pri = work.pop(0)
                hs.append((t, inter_, eng.submit(p, m, priority=pri,
                                                 sampling=SamplingParams(seed=0))))
            eng.step()
        ttft = [h.first_token_tick - t for t, i, h in hs if i]
        return eng.stats(), [list(h.tokens) for _, _, h in hs], ttft

    st_p, s_p, ttft_p = overload(5)
    st_h, s_h, ttft_h = overload(0)
    check("priority-overload", st_p["preemptions"] >= 1 and st_p["resumes"] >= 1
          and st_p["restored_pages"] >= 1 and s_p == s_h, depth=2, slots=2, chunk=1,
          preemptions=st_p["preemptions"], resumes=st_p["resumes"],
          spill_pages=st_p["spill_pages"], spill_bytes=st_p["spill_bytes"],
          restored_pages=st_p["restored_pages"], streams_equal_head_of_line=s_p == s_h,
          ttft_ticks_p99=float(np.percentile(ttft_p, 99)),
          hol_ttft_ticks_p99=float(np.percentile(ttft_h, 99)))

    # the host tier serves an evicted prefix (a pool of 4 pages of 8 tokens)
    tier = config(2, 1, 1, capacity=32, page_size=8, host_spill_pages=16)
    hp = np.arange(300, 317, dtype=np.int32)
    want = ServeEngine(tier, params=cut).submit(hp, 6).result()
    eng = ServeEngine(tier, params=cut)
    first_run = eng.submit(hp, 6).result()
    for j in range(3):
        eng.submit(np.arange(1 + 40 * j, 18 + 40 * j, dtype=np.int32), 6).result()
    again = eng.submit(hp, 6)
    again_tokens = again.result()
    st = eng.stats()
    check("host-tier-prefix", again_tokens == want == first_run and st["restored_pages"] >= 2
          and eng.alloc.host_restores >= 2 and again.cached_len >= 16,
          host_spill_pages_total=eng.alloc.host_spills,
          host_restore_pages_total=eng.alloc.host_restores, cached_len=again.cached_len,
          restored_pages=st["restored_pages"])

    # ------------------------------------------------------- speculation
    base = rng.integers(0, V, 12).astype(np.int32)
    sp_prompts = [np.tile(base, 4), np.tile(base[::-1], 4)[:40], np.tile(base + 1, 4)[:44],
                  np.tile(base[:7], 6)]
    sp_gen = 40 if full else 12
    # the verify and the rollback as CUDA graphs, against the eager step
    graphed, eager = (ServeEngine(config(2, 2, 4, speculate_k=4), params=cut)
                      for _ in range(2))
    for p in sp_prompts:
        graphed.submit(p, sp_gen)
        eager.submit(p, sp_gen)
    first, ticks = None, 0
    while graphed.has_work or eager.has_work:
        graphed.step()
        eager.step(eager=True)
        ticks += 1
        if first is None and ([r and r.tokens for r in graphed.active]
                              != [r and r.tokens for r in eager.active]):
            first = ticks
    st = graphed.stats()
    check("speculative-graph-vs-eager", first is None and st["spec_accepted"] > 0
          and st["spec_proposed"] > st["spec_accepted"]
          and [r.tokens for r in graphed.finished] == [r.tokens for r in eager.finished]
          and _same_bytes(torch, _cache_bytes(torch, graphed), _cache_bytes(torch, eager)),
          depth=2, slots=2, k=4, ticks=ticks, first_diverging_tick=first,
          proposed=st["spec_proposed"], accepted=st["spec_accepted"])
    del graphed, eager
    # full depth: speculative greedy streams equal plain decoding's (a
    # verify tick feeds 5 rows per slot where plain decoding feeds 1)
    depth = None if full else 2
    src = params if full else cut
    plain = ServeEngine(config(depth, 2, 4), params=src)
    want = _serve_all(plain, sp_prompts, sp_gen)
    spec = ServeEngine(config(depth, 2, 4, speculate_k=4), params=src)
    hs = [spec.submit(p, sp_gen) for p in sp_prompts]
    tick_ms = _speculative_ticks(spec)
    got = [list(h.tokens) for h in hs]
    st = spec.stats()
    check("speculative-greedy-equal", st["tokens_per_step"] > 1 and got == want,
          depth=spec.cfg.num_layers, slots=2, k=4, tokens_per_step=st["tokens_per_step"],
          accept_rate=st["accept_rate"], proposed=st["spec_proposed"],
          accepted=st["spec_accepted"], ticks=st["ticks"], plain_ticks=plain.stats()["ticks"],
          streams_equal_plain=got == want,
          first_diverging_token=[next((t for t, (a, b) in enumerate(zip(x, y)) if a != b), None)
                                 for x, y in zip(got, want)], **tick_ms)
    del plain, spec
    # an 8-slot speculative engine timed at its verify width
    spec8 = ServeEngine(config(depth, 8, 16, speculate_k=4), params=src)
    for i in range(8):
        spec8.submit(sp_prompts[i % 4][: 36 + i], sp_gen)
    tick_ms = _speculative_ticks(spec8)
    st = spec8.stats()
    check("speculative-8-slots", st["tokens_per_step"] > 1, depth=spec8.cfg.num_layers,
          slots=8, k=4, tokens_per_step=st["tokens_per_step"], accept_rate=st["accept_rate"],
          **tick_ms)
    del spec8
    # the self drafters (k = 4), proposing on the host side of step_begin
    # through models.forward_seq over the engine's capacity: "self" (the
    # first layer) at full depth must give plain decoding's greedy streams;
    # "self-full" (both layers of the depth-2 stack) prints its accept rate
    plain2 = _serve_all(ServeEngine(config(2, 2, 4), params=cut), sp_prompts, sp_gen)
    for drafter, d, src_d, want_d in (("self", depth, src, want),
                                      ("self-full", 2, cut, plain2)):
        eng = ServeEngine(config(d, 2, 4, speculate_k=4, drafter=drafter), params=src_d)
        spent = [0.0, 0]
        propose = eng.drafter.propose

        def timed_propose(h, k, propose=propose, spent=spent):
            t0 = time.perf_counter()
            out = propose(h, k)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out

        eng.drafter.propose = timed_propose
        got = _serve_all(eng, sp_prompts, sp_gen)
        st = eng.stats()
        equal = got == want_d
        check(f"speculative-{drafter}", (equal or drafter != "self") and st["spec_proposed"] > 0,
              depth=eng.cfg.num_layers, draft_layers=eng.drafter.draft_cfg.num_layers, slots=2,
              k=4, capacity=eng.capacity, streams_equal_plain=equal,
              first_diverging_token=[next((t for t, (a, b) in enumerate(zip(x, y)) if a != b),
                                          None) for x, y in zip(got, want_d)],
              tokens_per_step=st["tokens_per_step"], accept_rate=st["accept_rate"],
              proposed=st["spec_proposed"], accepted=st["spec_accepted"], ticks=st["ticks"],
              drafter_rounds=spent[1],
              drafter_host_ms_per_round=1e3 * spent[0] / max(1, spent[1]))
        del eng

    launches = {cnt.name: cnt.launches for cnt in counts}
    plain_cuda = {cnt.name: cnt.plain_on_cuda for cnt in counts}
    if cuda:
        idle = [k for k in path["kernels"] if launches[k] <= 0]
        stray = [k for k, n in launches.items() if n and k not in path["kernels"]]
        if idle or stray or max(plain_cuda.values()) != 0:
            fail(f"engine-features: kernels of the path that never launched {idle}, other "
                 f"kernels that did {stray}, plain versions on CUDA tensors {plain_cuda}")
    res = dict(launches=launches, plain_calls_on_cuda=plain_cuda,
               seconds=time.perf_counter() - t_phase)
    log("engine-features " + json.dumps(res))
    # after the counts are read: its direct kernel calls are no launches of
    # the path
    # (on the CPU the plain versions and torch's sums need not hold it: the
    # CPU port is held to the JAX engine's streams instead)
    ok, report = _row_invariance(torch, dev, cfg, params, full)
    check("row-invariance", ok or not cuda, **report)
    # the other paths: FP16 (K3, cuBLAS), contig-fp5.33 (K4), mla-fp5.33 (K5,
    # the absorb); a kernel's failing pair is fatal unless the reference's
    # block plan explains it, cuBLAS's are recorded
    report, bad = _row_invariance_paths(torch, dev, full)
    check("row-invariance-paths", not bad or not cuda, unexplained=bad, **report)
    check("fp16-speculative-vs-plain", True,
          **_fp16_speculative_streams(torch, dev, full, sp_prompts, sp_gen))
    del params, cut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return results, launches


def phase_seq(torch, dev, full: bool, params=None):
    """The full-sequence forward on the FP5.33 Qwen2-7B weights:
    `models.forward_seq(want_cache=True)` over a 256-token prompt (K1 at
    256 rows), its contiguous cache copied into one of larger capacity, then
    greedy one-token `decode_step`s from it (K1, K4); against the engine's
    chunked prefill of the same prompt (`decode_step` over chunks of 16 on
    a contiguous cache, K1 and K4) and greedy steps from that cache. The
    first-token logits must agree within LOGIT_TOL; the first diverging
    token of the two greedy streams is printed."""
    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import init_serving_params
    from repro_torch.models import decode_step, forward_seq, make_cache

    path = PATHS["fp5.33"]
    cfg = EngineConfig(arch=path["arch"], reduced=not full, device=str(dev)).model_config()
    policy = QuantPolicy(scheme=path["scheme"], impl="kernel", min_elements=1 << 10)
    if params is None:
        params = init_serving_params(cfg, policy, 0, dev)
    S, C, gen_n = (256, 16, 16) if full else (24, 4, 6)
    ccfg = CacheConfig(kind="contiguous", impl="kernel")
    rng = np.random.default_rng(77)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32),
                             device=dev)

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    t0 = time.perf_counter()
    logits, _, seq_cache = forward_seq(params, prompt, cfg, policy=policy, want_cache=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seq_s = time.perf_counter() - t0
    seq_launches = {cnt.name: cnt.launches for cnt in counts if cnt.launches}
    cache_seq = make_cache(cfg, 1, S + gen_n, device=dev)
    for dst, src in zip(tree_leaves(cache_seq), tree_leaves(seq_cache)):
        dst[:, :, :S] = src
    del seq_cache
    first_seq = logits[0, -1].float()
    del logits
    cache_chunk = make_cache(cfg, 1, S + gen_n, device=dev)
    for i in range(0, S, C):
        lg, _ = decode_step(params, prompt[:, i:i + C], cache_chunk, i32(i), cfg, policy=policy,
                            cache_cfg=ccfg, nvalid=i32(C))
    first_chunk = lg[0].float()
    d = float((first_seq - first_chunk).abs().max())
    rel = d / float(first_chunk.abs().max())

    def greedy(cache, first):
        toks = [int(first.argmax())]
        for j in range(gen_n - 1):
            lg, _ = decode_step(params, i32(toks[-1]), cache, i32(S + j), cfg, policy=policy,
                                cache_cfg=ccfg)
            toks.append(int(lg[0].argmax()))
        return toks

    a, b = greedy(cache_seq, first_seq), greedy(cache_chunk, first_chunk)
    launches = {cnt.name: cnt.launches for cnt in counts if cnt.launches}
    res = dict(arch=path["arch"], scheme=path["scheme"], depth=cfg.num_layers, prompt=S,
               chunk=C, logits_max_abs_diff=d, logits_rel_diff=rel, tolerance=LOGIT_TOL,
               first_token_equal=a[0] == b[0], streams_equal=a == b,
               first_diverging_token=next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                                          None),
               forward_seq_ms=1e3 * seq_s, forward_seq_launches=seq_launches,
               launches=launches)
    log("seq " + json.dumps(res))
    if not rel <= LOGIT_TOL:
        fail(f"seq: forward_seq's first-token logits differ from the chunked prefill's by "
             f"{rel:.3e} > {LOGIT_TOL}")
    if dev.type == "cuda" and seq_launches.get("ams_matmul_fp533", 0) <= 0:
        fail(f"seq: forward_seq launched no K1: {seq_launches}")
    return res


def _row_invariance(torch, dev, cfg, params, full: bool):
    """Whether every part of the FP5.33 step gives a row the same bits
    whatever else the tick feeds (the property the stream checks rest on),
    each part called directly: every row of a call against the same row
    alone. K1 on the first layer's seven packed projections at 2 and 8
    slots x widths W in {2, 4, 5, 16, 32} (the failing widths listed); K2
    over AMS pages, each row of a 5-row chunk and the first of a 16-row
    chunk against the same query alone, at lengths that put a chunk's rows
    on both sides of a share boundary (255 + 4 = 259 takes shares of 64
    where 255 takes 32); the norm, the head (final norm and lm_head) and the
    sampling epilogue (top-k / top-p masks, the draw, the log-softmax) at
    2, 4, 8 and 40 rows (the failing row counts listed). Returns (ok,
    report)."""
    from repro_torch.cache import CacheConfig, paged_insert
    from repro_torch.cache.paged_attention import paged_attention_kernel
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch import prng
    from repro_torch.launch.sampling import log_softmax, masked_logits, tempered
    from repro_torch.models import make_cache
    from repro_torch.models.common import apply_linear, model_dims, rms_norm
    from repro_torch.models.transformer import _head

    pol = QuantPolicy(scheme=PATHS["fp5.33"]["scheme"], impl="kernel", min_elements=1 << 10)
    gen = torch.Generator(device=dev).manual_seed(1)
    dims = model_dims(cfg)
    layer = {**params["layers"]["sub0"]["attn"], **params["layers"]["sub0"]["ffn"]}
    fan_in = {"wo": dims.H * dims.hd, "w_down": cfg.d_ff}
    res = {}

    def rows_apart(fn, counts):
        """The row counts n at which some row of fn(slice(0, n)) (a tuple
        of tensors, one row per input row) is not fn of that row alone."""
        alone = [fn(slice(r, r + 1)) for r in range(max(counts))]
        return [n for n in counts if not all(
            all(torch.equal(a[r], b[0]) for a, b in zip(fn(slice(0, n)), alone[r]))
            for r in range(n))]

    for name, w in layer.items():
        w0 = {k: v[0] for k, v in w.items()}
        x = torch.randn((8 * 32, fan_in.get(name, cfg.d_model)), generator=gen,
                        device=dev).to(torch.bfloat16)
        res[f"K1_{name}"] = rows_apart(lambda sl: (apply_linear(w0, x[sl], pol),),
                                       [B * W for B in (2, 8) for W in (1, 2, 4, 5, 16, 32)])
    cap = 1024 if full else 64
    ccfg = CacheConfig(kind="paged_ams", page_size=16, impl="kernel").sized(capacity=cap, slots=2)
    pool = {k: {p: t[0] for p, t in v.items()}
            for k, v in make_cache(cfg, 2, cap, cache_cfg=ccfg, device=dev)["layers"]["sub0"].items()}
    bt = torch.arange(2 * ccfg.max_pages_per_seq, dtype=torch.int32, device=dev).reshape(2, -1)
    kn = torch.randn((2, cap - 16, dims.kv, dims.hd), generator=gen, device=dev).to(torch.bfloat16)
    paged_insert(pool, kn, -kn, torch.zeros(2, dtype=torch.int32, device=dev), bt, ccfg)
    for L in ((64, 250, 255, 256, 300, 1000) if full else (20, 31, 40)):
        q = torch.randn((2, 16, dims.H, dims.hd), generator=gen, device=dev)
        lens = L + torch.arange(16, dtype=torch.int32, device=dev)[None].expand(2, 16)
        alone = [paged_attention_kernel(q[:, j], pool, lens[:, j].contiguous(), bt, ccfg)
                 for j in range(5)]
        five = paged_attention_kernel(q[:, :5].contiguous(), pool, lens[:, :5].contiguous(), bt,
                                      ccfg)
        wide = paged_attention_kernel(q, pool, lens.contiguous(), bt, ccfg)
        res[f"K2_L{L}"] = [j for j in range(5) if not torch.equal(five[:, j], alone[j])] + (
            [] if torch.equal(wide[:, 0], alone[0]) else ["16-row chunk"])
    counts = (2, 4, 8, 40)
    xs = torch.randn((40, 1, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    xf = xs.float() + torch.randn((40, 1, cfg.d_model), generator=gen, device=dev)
    res["norm"] = rows_apart(lambda sl: (rms_norm(xf[sl], params["final_norm"], cfg.norm_eps),),
                             counts)
    res["head"] = rows_apart(lambda sl: (_head(params, xs[sl], cfg, dims, pol),), counts)
    logits = 4 * torch.randn((40, dims.V), generator=gen, device=dev)
    keys = prng.fold_in(prng.PRNGKey(7, device=dev).expand(40, 2),
                        torch.arange(40, device=dev))

    def epilogue(sl):
        t = logits[sl]
        n = t.shape[0]
        m = masked_logits(tempered(t, torch.full((n,), 0.8, device=dev)),
                          torch.full((n,), 50, device=dev), torch.full((n,), 0.95, device=dev))
        return m, prng.categorical(keys[sl], m), log_softmax(t)

    res["sampling"] = rows_apart(epilogue, counts)
    return not any(res.values()), res


ROW_SLOTS, ROW_WIDTHS = (2, 8), (1, 2, 4, 5, 16)


def _rows_vs_alone(torch, call, B_max: int, W_max: int):
    """The (slots, width) pairs of `ROW_SLOTS` x `ROW_WIDTHS` at which some
    row of ``call(B, W)`` (a [B, W, ...] output over the first B slots and W
    positions of fixed inputs) is not ``call`` of that (slot, position)
    alone, ``call((b, j))`` (a [1, 1, ...] output)."""
    alone = [[call((b, j)) for j in range(W_max)] for b in range(B_max)]
    return [[B, W] for B in ROW_SLOTS for W in ROW_WIDTHS if not all(
        torch.equal(out[b, j], alone[b][j][0, 0]) for out in (call(B, W),)
        for b in range(B) for j in range(W))]


def _row_invariance_paths(torch, dev, full: bool):
    """Row invariance on the FP16, contig-fp5.33 and mla-fp5.33 paths, each
    part called directly, every row of a call against the same (slot,
    position) alone at 2 and 8 slots x widths {1, 2, 4, 5, 16} (the failing
    pairs listed): K3 over bf16 pages, FP16's bf16 projections
    (`torch.matmul`, cuBLAS) at Qwen2-7B's shapes, K4 over the contiguous
    GQA cache, K5 over the MLA stream and the MLA absorb (`_mla_q_eff`,
    `_mla_out`, and their einsums alone) of one MiniCPM3-4B layer. K4's and
    K5's key block is the reference's plan for the call's rows (chunk x
    group); where it differs from the one-query block, the pair follows the
    reference (``block_kv`` lists it). Returns (report, the kernels' failing
    pairs not explained by the block)."""
    import dataclasses

    from repro_torch.cache import CacheConfig, paged_insert
    from repro_torch.cache.paged_attention import paged_attention_kernel
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels.attention_template import fused_contiguous_attention
    from repro_torch.kernels.tuning import reference_block_kv
    from repro_torch.launch.engine import init_serving_params
    from repro_torch.models import make_cache
    from repro_torch.models.attention import _mla_out, _mla_q_eff, _mla_scale
    from repro_torch.models.common import apply_linear, materialize_weight, model_dims

    gen = torch.Generator(device=dev).manual_seed(3)
    Bm, Wm = max(ROW_SLOTS), max(ROW_WIDTHS)
    qwen = get_config("qwen2-7b")
    mla = get_config("minicpm3-4b")
    if not full:
        qwen, mla = qwen.reduced(), mla.reduced()
    S = 512 if full else 64
    res, blocks = {}, {}

    def sl(B, W=None):
        """(B, W): the first B slots and W positions; (b, j) alone."""
        if W is None:
            b, j = B
            return slice(b, b + 1), slice(j, j + 1)
        return slice(0, B), slice(0, W)

    # lengths: slot b's position j sees L_b + j keys (a chunk's queries)
    L = torch.as_tensor([S // 2 + 37 * b - 5 * (b % 3) for b in range(Bm)], device=dev)
    L = torch.minimum(L, torch.tensor(S - Wm, device=dev))
    lens = (L[:, None] + torch.arange(1, Wm + 1, device=dev)[None]).to(torch.int32)

    # K3 over bf16 pages (Qwen2-7B heads, pages of 16)
    d = model_dims(qwen)
    ccfg = CacheConfig(kind="paged_bf16", page_size=16, impl="kernel").sized(capacity=S,
                                                                             slots=Bm)
    pool = {k: v[0] for k, v in make_cache(qwen, Bm, S, cache_cfg=ccfg,
                                            device=dev)["layers"]["sub0"].items()}
    bt = torch.randperm(Bm * ccfg.max_pages_per_seq, generator=gen, device=dev).to(
        torch.int32).reshape(Bm, -1)
    kn = torch.randn((Bm, S, d.kv, d.hd), generator=gen, device=dev).to(torch.bfloat16)
    paged_insert(pool, kn, -kn, torch.zeros(Bm, dtype=torch.int32, device=dev), bt, ccfg)
    q3 = torch.randn((Bm, Wm, d.H, d.hd), generator=gen, device=dev).to(torch.bfloat16)

    def k3(B, W=None):
        a, c = sl(B, W)
        return paged_attention_kernel(q3[a, c].contiguous(), pool, lens[a, c].contiguous(),
                                      bt[a].contiguous(), ccfg)

    res["K3"] = _rows_vs_alone(torch, k3, Bm, Wm)
    del pool, kn

    # FP16's projections: bf16 weights through torch.matmul (cuBLAS)
    for name, K, N, _ in (QWEN_SHAPES if full else TINY_SHAPES):
        w = {"w": (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(
            torch.bfloat16)}
        x = torch.randn((Bm, Wm, K), generator=gen, device=dev).to(torch.bfloat16)

        def proj(B, W=None, w=w, x=x):
            a, c = sl(B, W)
            return apply_linear(w, x[a, c].contiguous(), None)

        res[f"fp16_{name}"] = _rows_vs_alone(torch, proj, Bm, Wm)

    # K4 over the contiguous GQA cache (Qwen2-7B heads)
    kc = torch.randn((Bm, S, d.kv, d.hd), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((Bm, S, d.kv, d.hd), generator=gen, device=dev).to(torch.bfloat16)
    q4 = torch.randn((Bm, Wm, d.H, d.hd), generator=gen, device=dev).to(torch.bfloat16)
    g4 = d.H // d.kv

    def k4(B, W=None):
        a, c = sl(B, W)
        return fused_contiguous_attention(q4[a, c].contiguous(), kc[a].contiguous(),
                                          lens[a, c].contiguous(), v_cache=vc[a].contiguous())

    res["K4"] = _rows_vs_alone(torch, k4, Bm, Wm)
    blocks["K4"] = {W: reference_block_kv(rows=W * g4, hd=d.hd, hd_v=d.hd, s_max=S)
                    for W in ROW_WIDTHS}
    del kc, vc

    # K5 over the MLA stream and the MLA absorb (one MiniCPM3-4B layer)
    dm = model_dims(mla)
    hd5, hv5 = mla.kv_lora_rank + mla.qk_rope_dim, mla.kv_lora_rank
    stream = torch.randn((Bm, S, 1, hd5), generator=gen, device=dev).to(torch.bfloat16)
    q5 = torch.randn((Bm, Wm, dm.H, hd5), generator=gen, device=dev).to(torch.bfloat16)

    def k5(B, W=None):
        a, c = sl(B, W)
        return fused_contiguous_attention(q5[a, c].contiguous(), stream[a].contiguous(),
                                          lens[a, c].contiguous(), value_slice=hv5,
                                          scale=_mla_scale(mla))

    res["K5"] = _rows_vs_alone(torch, k5, Bm, Wm)
    blocks["K5"] = {W: reference_block_kv(rows=W * dm.H, hd=hd5, hd_v=hv5, s_max=S)
                    for W in ROW_WIDTHS}
    del stream
    pol = QuantPolicy(scheme=PATHS["mla-fp5.33"]["scheme"], impl="kernel", min_elements=1 << 10)
    one = init_serving_params(dataclasses.replace(mla, num_layers=1), pol, 5, dev)
    p = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0])
         for k, v in one["layers"]["sub0"]["attn"].items()}
    x = torch.randn((Bm, Wm, mla.d_model), generator=gen, device=dev).to(torch.bfloat16)
    pos = (L[:, None] + torch.arange(Wm, device=dev)[None]).to(torch.int32)
    ac = torch.randn((Bm, Wm, dm.H, hv5), generator=gen, device=dev).to(torch.bfloat16)
    w_uk = materialize_weight(p["w_uk"], hv5, torch.bfloat16, pol).reshape(
        hv5, dm.H, mla.qk_nope_dim)
    w_uv = materialize_weight(p["w_uv"], hv5, torch.bfloat16, pol).reshape(
        hv5, dm.H, mla.v_head_dim)
    qn = torch.randn((Bm, Wm, dm.H, mla.qk_nope_dim), generator=gen, device=dev).to(
        torch.bfloat16)
    parts = {
        "mla_q_eff": lambda a, c: _mla_q_eff(p, x[a, c].contiguous(), mla, dm,
                                             pos[a, c].contiguous(), pol),
        "mla_out": lambda a, c: _mla_out(p, ac[a, c].contiguous(), mla, dm, pol),
        "mla_einsum_q": lambda a, c: torch.einsum("bshd,rhd->bshr", qn[a, c].contiguous(),
                                                  w_uk),
        "mla_einsum_o": lambda a, c: torch.einsum("bshr,rhd->bshd", ac[a, c].contiguous(),
                                                  w_uv),
    }
    for name, fn in parts.items():
        res[name] = _rows_vs_alone(torch, lambda B, W=None, fn=fn: fn(*sl(B, W)), Bm, Wm)
    del one, p

    # a kernel's failing pair is explained only where the reference's block
    # for its rows differs from the one-query block
    unexplained = {k: [bw for bw in res[k] if k not in blocks
                       or blocks[k][bw[1]] == blocks[k][1]] for k in ("K3", "K4", "K5")}
    report = dict(slots=list(ROW_SLOTS), widths=list(ROW_WIDTHS), keys=S,
                  lengths=[int(L.min()), int(L.max()) + Wm], failing=res,
                  block_kv={k: {str(w): b for w, b in v.items()} for k, v in blocks.items()},
                  causes={k: ("cuBLAS" if k.startswith(("fp16_", "mla_")) else
                              "block" if v and not unexplained.get(k) else "kernel")
                          for k, v in res.items() if v})
    return report, {k: v for k, v in unexplained.items() if v}


def _fp16_speculative_streams(torch, dev, full: bool, prompts, gen_n: int):
    """FP16 (bf16 weights through cuBLAS, bf16 pages through K3) at full
    depth: speculative greedy streams (k = 4, n-gram) against plain
    decoding's, 2 slots, chunk 4. A record, not a gate: a verify tick feeds
    5 rows per slot where plain decoding feeds 1, so where cuBLAS gives a
    row other bits at another row count the streams may part."""
    from repro_torch.cache import CacheConfig
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    spec = PATHS["fp16"]

    def config(**kw):
        return EngineConfig(arch=spec["arch"], reduced=not full, scheme=spec["scheme"],
                            impl="kernel", slots=2, capacity=512 if full else 64,
                            prefill_chunk=4, device=str(dev), seed=0,
                            cache=CacheConfig(kind=spec["kind"], page_size=16 if full else 8,
                                              impl="kernel"), **kw)

    plain = ServeEngine(config())
    want = _serve_all(plain, prompts, gen_n)
    spec_eng = ServeEngine(config(speculate_k=4), params=plain.params)
    got = _serve_all(spec_eng, prompts, gen_n)
    st = spec_eng.stats()
    del plain, spec_eng
    gc.collect()
    return dict(depth="full" if full else "reduced", slots=2, k=4, streams_equal=got == want,
                tokens_per_step=st["tokens_per_step"],
                first_diverging_token=[next((t for t, (a, b) in enumerate(zip(x, y))
                                             if a != b), None) for x, y in zip(got, want)])


def phase_rows(torch, dev, timed: bool, full: bool):
    """The row-invariance checks of the FP16, contig-fp5.33 and mla-fp5.33
    paths alone (`_row_invariance_paths`)."""
    report, bad = _row_invariance_paths(torch, dev, full)
    return (dict(report, unexplained=bad),)


def _speculative_ticks(eng):
    """Drive a speculative engine to the end, timing each tick by kind:
    ``prefill`` (a slot prefills or a request waits), ``verify`` (drafts
    were scored: the width max(chunk, k + 1)) or ``decode`` (width 1).
    Returns the median ms and count of each kind."""
    import numpy as np
    ticks = {}
    while eng.has_work:
        prefilling = len(eng.sched) > 0 or any(
            r is not None and eng.fed[s] < r.prompt_len for s, r in enumerate(eng.active))
        before = eng.stats()["spec_proposed"]
        t0 = time.perf_counter()
        eng.step()
        ms = 1e3 * (time.perf_counter() - t0)
        kind = ("prefill" if prefilling else
                "verify" if eng.stats()["spec_proposed"] > before else "decode")
        ticks.setdefault(kind, []).append(ms)
    return {**{f"{k}_tick_ms_median": float(np.median(v)) for k, v in ticks.items()},
            **{f"{k}_ticks": len(v) for k, v in ticks.items()}}


# ------------------------------------------------------------ frontend phase
def phase_frontend(torch, dev, full: bool, params=None):
    """The serving surface on the FP5.33 path (K1, K2): full-width Qwen2-7B
    over AMS-e2m2 pages behind `ServeFrontend` on 127.0.0.1 (an ephemeral
    port), its graphs captured on the stepping thread before it listens. A
    stdlib asyncio client sends 12 requests at staggered arrivals, half
    JSON and half SSE, two of them seeded and sampled: 6 long ones fill the
    4 slots and the queue of 2, the 7th must get 429, 5 more arrive as the
    queue drains. Every stream must equal the same request served alone by
    a direct engine (same weights, the same request id, so a seeded draw
    is the same); /healthz and /metrics are read; K1 and K2 must be the only
    kernels launched (counts zeroed just before the front end starts and
    read after it stops). Prints TTFT and latency in ms and ticks, the
    driver's tick against a direct `step()` tick over the same requests,
    the host ms per tick between ``step_begin``'s return and ``step_end``,
    and the cost line (floor bytes and ms per tick at the H100's peaks, the
    measured tick, the share). ``params``: FP5.33 serving weights to reuse."""
    import asyncio
    import dataclasses
    import itertools

    import numpy as np

    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.cache import CacheConfig
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine, init_serving_params
    from repro_torch.launch.frontend import ServeFrontend
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.obs import attribution

    spec = PATHS["fp5.33"]
    slots, max_queue = 4, 2
    ec = EngineConfig(arch=spec["arch"], reduced=not full, scheme=spec["scheme"], impl="kernel",
                      slots=slots, capacity=512 if full else 64, prefill_chunk=16 if full else 4,
                      max_queue=max_queue, device=str(dev), seed=0,
                      cache=CacheConfig(kind=spec["kind"], page_size=16 if full else 8,
                                        impl="kernel"))
    t_phase = time.perf_counter()
    if params is None:
        params = init_serving_params(ec.model_config(), QuantPolicy(
            scheme=spec["scheme"], impl="kernel", min_elements=1 << 10), 0, dev)
    V = ec.model_config().vocab_size
    rng = np.random.default_rng(31)
    plen, long_n, short_n = ((40, 120), 24, 12) if full else ((6, 14), 40, 5)
    reqs = []                          # (stream?, prompt, max_tokens, sampling dict)
    for i in range(12):
        body = {"prompt": [int(t) for t in rng.integers(0, V, int(rng.integers(*plen)))],
                "max_tokens": long_n if i < 7 else short_n, "stream": i % 2 == 1}
        if i in (1, 8):                # one SSE and one JSON request, seeded and sampled
            body.update(temperature=0.8, top_k=40, top_p=0.95, seed=100 + i)
        reqs.append(body)
    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    eng = ServeEngine(ec, params=params)
    fe = ServeFrontend(eng)

    async def send(body):
        t0 = time.perf_counter()
        r, w = await asyncio.open_connection("127.0.0.1", fe.port)
        raw = json.dumps(body).encode()
        w.write(b"POST /v1/generate HTTP/1.1\r\nContent-Length: %d\r\n\r\n%s" % (len(raw), raw))
        await w.drain()
        lines, first = [], None
        while True:
            ln = await r.readline()
            if not ln:
                break
            if first is None and ln.startswith(b"data: {\"token\""):
                first = time.perf_counter()
            lines.append(ln.decode())
        w.close()
        text = "".join(lines)
        res = dict(status=int(text.split(" ", 2)[1]), ms=1e3 * (time.perf_counter() - t0),
                   stream=body["stream"])
        if res["status"] == 200 and body["stream"]:
            res["tokens"] = [json.loads(x[6:])["token"] for x in text.splitlines()
                             if x.startswith("data: {\"token\"")]
            res["ttft_ms"] = 1e3 * (first - t0)
        elif res["status"] == 200:
            res.update(json.loads(text.partition("\r\n\r\n")[2]))
        return res

    async def get(path):
        r, w = await asyncio.open_connection("127.0.0.1", fe.port)
        w.write(f"GET {path} HTTP/1.1\r\nContent-Length: 0\r\n\r\n".encode())
        await w.drain()
        text = (await r.read()).decode()
        w.close()
        return text.partition("\r\n\r\n")[2]

    async def until(pred, what, timeout=60.0):
        t0 = time.perf_counter()
        while True:
            h = json.loads(await get("/healthz"))
            if pred(h):
                return h
            if time.perf_counter() - t0 > timeout:
                fail(f"frontend: {what} not reached in {timeout} s: {h}")
            await asyncio.sleep(0.002)

    async def client():
        await fe.start()
        tasks = []
        # fill the slots and the queue, one arrival at a time (a request is
        # admitted only at a tick's start: arrivals beside a running tick
        # wait in the queue, and past max_queue they are refused)
        for k, body in enumerate(reqs[:6], 1):
            await until(lambda h: h["queue_depth"] < max_queue, "room in the queue")
            tasks.append(asyncio.create_task(send(body)))
            await until(lambda h, k=k: h["active"] + h["queue_depth"] == k,
                        f"request {k} in the engine")
        await until(lambda h: h["active"] == slots and h["queue_depth"] == max_queue,
                    "a full batch and a full queue")
        rejected = await send(reqs[6])
        for body in reqs[7:]:          # staggered arrivals as the queue drains
            await until(lambda h: h["queue_depth"] < max_queue, "room in the queue")
            tasks.append(asyncio.create_task(send(body)))
            await asyncio.sleep(0.02)
        served = await asyncio.gather(*tasks)
        health = json.loads(await get("/healthz"))
        metrics = await get("/metrics")
        await fe.stop()
        return served, rejected, health, metrics

    t0 = time.perf_counter()
    served, rejected, health, metrics = asyncio.run(client())
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {cnt.name: cnt.launches for cnt in counts}
    plain_cuda = {cnt.name: cnt.plain_on_cuda for cnt in counts}
    st = eng.stats()
    fin = {r.rid: r for r in eng.finished}
    att = attribution(eng)

    # each served request alone, through a direct engine with its request id
    order = reqs[:6] + reqs[7:]
    unbounded = dataclasses.replace(ec, max_queue=None)
    direct = ServeEngine(unbounded, params=params)
    alone, mismatched = [], []
    for body, res in zip(order, served):
        rid = res.get("rid")
        if rid is None:                # SSE: the request the front end finished with it
            rid = next(r.rid for r in eng.finished if list(r.prompt) == body["prompt"])
            res["rid"] = rid
        direct._rid = itertools.count(rid)     # the draw key folds the request id
        sp = SamplingParams(**{k: body[k] for k in ("temperature", "top_k", "top_p", "seed")
                               if k in body})
        want = direct.submit(np.asarray(body["prompt"], np.int32), body["max_tokens"],
                             sampling=sp).result()
        alone.append(want)
        if res.get("tokens") != want:
            mismatched.append(rid)
    # a direct step() tick over the same requests, all submitted at once
    batch = ServeEngine(unbounded, params=params)
    for body in order:
        batch.submit(np.asarray(body["prompt"], np.int32), body["max_tokens"],
                     sampling=SamplingParams(**{k: body[k] for k in
                                                ("temperature", "top_k", "top_p", "seed")
                                                if k in body}))
    batch.run()
    bst = batch.stats()
    ticks = st["ticks"]
    tick_ms = 1e3 * sum(eng._m_tick_s.raw_values()) / max(ticks, 1)
    floor_ms = 1e3 * max(att["floor_hbm_bytes_total"] / max(ticks, 1) / HBM_BW,
                         att["floor_flops_total"] / max(ticks, 1) / PEAK_FLOPS)
    ttft_ms = [r["ttft_ms"] for r in served if "ttft_ms" in r]
    res = dict(
        path="fp5.33", depth=eng.cfg.num_layers, slots=slots, max_queue=max_queue,
        requests=len(reqs), served=len(served), json=sum(not r["stream"] for r in served),
        sse=sum(r["stream"] for r in served), sampled=2, rejected_status=rejected["status"],
        statuses=[r["status"] for r in served], streams_equal_alone=not mismatched,
        mismatched_rids=mismatched, wall_s=wall,
        ttft_ms_sse=dict(mean=float(np.mean(ttft_ms)), max=float(np.max(ttft_ms))),
        latency_ms=dict(mean=float(np.mean([r["ms"] for r in served])),
                        max=float(np.max([r["ms"] for r in served]))),
        ttft_ticks=dict(mean=float(np.mean([fin[r["rid"]].ttft_ticks for r in served])),
                        max=max(fin[r["rid"]].ttft_ticks for r in served)),
        latency_ticks=dict(mean=float(np.mean([fin[r["rid"]].latency_ticks for r in served])),
                           max=max(fin[r["rid"]].latency_ticks for r in served)),
        driver_tick_ms_median=st["decode_ms_median"], direct_tick_ms_median=bst["decode_ms_median"],
        driver_ticks=fe.driver_ticks,
        host_ms_between_halves=1e3 * fe.driver_host_s / max(fe.driver_ticks, 1),
        cost=dict(floor_hbm_bytes_per_tick=att["floor_hbm_bytes_per_tick"],
                  floor_ms_h100=floor_ms, tick_ms=tick_ms,
                  floor_share=floor_ms / tick_ms if tick_ms else 0.0,
                  kv_achieved_vs_floor=att["kv_achieved_vs_floor"]),
        healthz=health, metrics_lines=len(metrics.splitlines()),
        launches=launches, plain_calls_on_cuda=plain_cuda,
        graphs=sorted(f"{w}/{'sampled' if sp else 'greedy'}" for w, sp in eng.graphs.graphs)
        if eng.graphs is not None else None,
        seconds=time.perf_counter() - t_phase)
    log("frontend " + json.dumps(res))
    if rejected["status"] != 429 or any(r["status"] != 200 for r in served):
        fail(f"frontend: the request past the queue got {rejected['status']} (want 429), "
             f"served statuses {res['statuses']}")
    if mismatched:
        fail(f"frontend: streams of requests {mismatched} differ from the request served alone")
    if not (health.get("ok") and "serve_requests_finished_total" in metrics
            and "serve_floor_hbm_bytes_total" in metrics):
        fail(f"frontend: /healthz {health} or /metrics without the serving families")
    if dev.type == "cuda":
        idle = [k for k in spec["kernels"] if launches[k] <= 0]
        stray = [k for k, n in launches.items() if n and k not in spec["kernels"]]
        if idle or stray or max(plain_cuda.values()) != 0:
            fail(f"frontend: kernels of the path that never launched {idle}, other kernels "
                 f"that did {stray}, plain versions on CUDA tensors {plain_cuda}")
        if len(eng.graphs.graphs) != 4:
            fail(f"frontend: graphs captured {res['graphs']}, not (1, chunk) x (greedy, sampled)")
    del eng, direct, batch
    gc.collect()
    return res


def ptxas_report(build, kernels=("ams_matmul_mma_kernel", "k4_kernel", "k5_kernel",
                                 "k2_kernel", "k3_kernel", "k5p_kernel")):
    """One line per instantiation of the named kernels from the build's
    ``-Xptxas -v`` logs: registers, shared memory, stack and spills (K1 and
    K1b's kernel, one line per decode hook (`Fp533Decode`,
    `PlanesDecode<HB, KS>`), tile and x copy; K4; K5; K2; K3; K5p on bf16
    and AMS pages)."""
    rows = []
    for name in build.SOURCES:
        logf = build.library_path(name).with_suffix(".log")
        if not logf.exists():
            continue
        fn, props = None, ""
        for ln in logf.read_text().splitlines():
            if "Function properties for" in ln:
                fn, props = ln.split("Function properties for")[-1].strip(), ""
            elif fn and "stack frame" in ln:
                props = ln.strip()
            elif fn and "Used" in ln and "registers" in ln:
                if any(k in fn for k in kernels):
                    rows.append(f"{fn}: {ln.split('Used', 1)[1].strip()}; {props}")
                fn = None
    for r in rows:
        log(f"ptxas {r}")
    if not rows:
        fail("no ptxas report for the K1 / K1b / K2 / K3 / K4 / K5 / K5p kernels")


def phase_tick(torch, dev, timed: bool, full: bool):
    """The greedy FP5.33 graph tick alone: full-width Qwen2-7B over AMS-e2m2
    pages, 8 slots decoding over 211-354 keys (prompts prefilled first),
    ``ticks`` graph ticks timed on the host and the same number of replays
    from CUDA events. With ``--from DIR`` this function runs against the
    other checkout's package (a parent's script without it lends it)."""
    import numpy as np

    from repro_torch.cache import CacheConfig
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import ServeEngine

    spec, ticks = PATHS["fp5.33"], 10
    eng = ServeEngine(EngineConfig(arch=spec["arch"], reduced=not full, scheme=spec["scheme"],
                                   impl="kernel", slots=8, capacity=512 if full else 64,
                                   prefill_chunk=16, device=str(dev), seed=0,
                                   cache=CacheConfig(kind=spec["kind"], page_size=16,
                                                     impl="kernel")))
    fill_for_decode(eng, np.random.default_rng(1234), PROFILE_PROMPT if full else (8, 16),
                    2 * ticks + 3)
    eng.step()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    tick_ms = 1e3 * (time.perf_counter() - t0) / ticks
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(ticks):
        eng.graphs(1)
    e1.record()
    e1.synchronize()
    res = dict(path="fp5.33", active_slots=eng.active_count, decode_tick_ms=tick_ms,
               replay_ms=e0.elapsed_time(e1) / ticks)
    eng.run()
    return (res,)


# ---------------------------------------------------------------- training
# Adam's step: warmup of 2 steps, then the cosine over 10k. Adam's first
# steps move every weight by about lr: at 1e-3 and 3e-4 the full-width loss
# rose for three or four steps (12.47 -> 18.39, -> 24.14) before it fell
TRAIN_LR = 3e-5
# card against CPU, two full-width steps at depth 1 from the same params
# (bf16 products summed in other orders on the two devices), measured on an
# H100 80GB HBM3, 700 W: the relative loss difference at each step (at most
# 1.24e-4: the second step inherits the first update's differences), the
# grad norms' (1.44e-4), and the masters after the steps, |p_card - p_cpu| /
# |p_cpu - p_0| over the whole tree (0.0154: a near-zero grad of the other
# sign moves its weight the other way)
TRAIN_VERSUS_STEPS = 2
TRAIN_LOSS_REL = 1e-3
TRAIN_GNORM_REL = 2e-3
TRAIN_UPDATE_REL = 0.1
# AdamW alone, card against CPU on the same masters and grads: params, m and
# v in ulp of each leaf's largest |value|, and the grad norm (measured 3 ulp
# and 6.0e-8 here, 3.5 ulp and 1.2e-7 on the reduced trees of
# tests/test_torch_gpu.py)
TRAIN_ADAMW_STEPS = 4
TRAIN_ADAMW_ULPS = 8
TRAIN_ADAMW_GNORM_REL = 1e-6
# restart: the restored step's loss against the first pass's (same bits in,
# the same forward; the CUDA embedding backward sums with atomics)
TRAIN_RESTART_REL = 1e-5
ADAMW_BYTES_PER_PARAM = 34      # f32 p, g, m, v read; p, m, v written; bf16 copy written


def _train_flops(cfg, n_matmul: int, n_layers: int, B: int, S: int) -> float:
    """FLOPs of one train step: 6 per matmul parameter (every parameter but
    the embedding table, which is gathered) per token, 2 per layer
    parameter per token for the remat forward, and attention's q . k and
    p . v over the whole S x S block (the blockwise forward computes it
    masked) four times (forward, remat forward, two in the backward)."""
    T = B * S
    attn_fwd = 4.0 * B * S * S * cfg.num_heads * cfg.head_dim * cfg.num_layers
    return 6.0 * n_matmul * T + 2.0 * n_layers * T + 4.0 * attn_fwd


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_train(torch, dev, timed: bool = True, full: bool = True):
    """Training on one card through `launch.steps.build_train_step` and
    `launch.train.main`: full-width Qwen2-7B (4 of 28 layers) takes steps
    at B 8 x 512 tokens in microbatches of 4 with remat (its loss must be
    finite and fall); two full-width steps at depth 1 on the card and on
    the CPU from the same seeded params (loss within TRAIN_LOSS_REL and
    grad norm within TRAIN_GNORM_REL at each step, the masters' difference
    within TRAIN_UPDATE_REL of how far they moved); `optim.apply_updates`
    alone for TRAIN_ADAMW_STEPS steps on the card and on the CPU from the
    same f32 masters and seeded grads (params, m and v within
    TRAIN_ADAMW_ULPS ulp, the grad norm within TRAIN_ADAMW_GNORM_REL); a
    reduced run of the driver with a
    failure injected one step after a checkpoint (restored bytes equal to
    the saved ones, the restored step's loss repeated, the run ending at
    --steps, a fresh driver resuming from the newest step). The training
    path launches no kernel of the port (checked: every count stays 0)."""
    import dataclasses
    import os
    import statistics
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.tree import tree_items, tree_map
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, apply_updates, init_state

    cuda = dev.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = get_config("qwen2-7b")
    if full:
        cfg, S, B, micro, steps = dataclasses.replace(base, num_layers=4), 512, 8, 4, 8
        reduced = ["num_layers 28 -> 4"]
    else:
        cfg, S, B, micro, steps = base.reduced(), 32, 4, 2, 4
        reduced = ["reduced() config"]
    rcfg = RunConfig(model=cfg, seq_len=S, global_batch=B, microbatch=micro,
                     learning_rate=TRAIN_LR, warmup_steps=2)
    for cnt in all_counts():
        cnt.reset()
    step_fn = build_train_step(cfg, rcfg, dev)
    params = init_params(0, cfg, device=dev)
    n_params = sum(t.numel() for _, t in tree_items(params))
    n_layers = sum(t.numel() for _, t in tree_items(params["layers"]))
    n_matmul = n_params - params["embed"]["w"].numel()
    opt = init_state(params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, S, B))
    flops = _train_flops(cfg, n_matmul, n_layers, B, S)
    adamw_floor_ms = 1e3 * ADAMW_BYTES_PER_PARAM * n_params / PEAK_BYTES_PER_S
    log("train setup " + json.dumps(dict(
        arch=cfg.name, d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size, layers=cfg.num_layers,
        reduced=reduced, params=n_params, seq_len=S, global_batch=B, microbatch=micro,
        remat=rcfg.remat, steps=steps, lr=TRAIN_LR, warmup_steps=rcfg.warmup_steps,
        flops_per_step=flops, peak_bf16_flops=PEAK_BF16_FLOPS,
        adamw_bytes_per_param=ADAMW_BYTES_PER_PARAM, adamw_bytes_floor_ms=adamw_floor_ms)))
    losses, gnorms, times = [], [], []
    for s in range(steps):
        toks, tgts = data.batch(s)
        tok, tgt = torch.from_numpy(toks).to(dev), torch.from_numpy(tgts).to(dev)
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, tok, tgt, None, s)
        met = {k: float(v) for k, v in met.items()}
        dt = time.perf_counter() - t0
        losses.append(met["loss"])
        gnorms.append(met["grad_norm"])
        times.append(dt)
        log(f"train step {s} " + json.dumps(dict(
            loss=met["loss"], grad_norm=met["grad_norm"], lr=met["lr"], step_ms=1e3 * dt,
            tokens_per_s=B * S / dt, flop_share=flops / (dt * PEAK_BF16_FLOPS))))
    launches = {c.name: c.launches for c in all_counts() if c.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    step_ms = 1e3 * statistics.median(times[1:])
    summary = dict(step_ms_median=step_ms, tokens_per_s=B * S / (step_ms / 1e3),
                   flop_share=flops / (step_ms / 1e3 * PEAK_BF16_FLOPS),
                   peak_memory_gb=peak_gb, loss_first=losses[0],
                   loss_last_two=float(np.mean(losses[-2:])), port_kernel_launches=launches)
    log("train full-width " + json.dumps(summary))
    if not all(np.isfinite(losses + gnorms)):
        fail(f"train: a loss or grad norm is not finite: {losses}, {gnorms}")
    if not np.mean(losses[-2:]) < losses[0]:
        fail(f"train: the loss did not fall: {losses}")
    if launches:
        fail(f"train: the training path launched port kernels {launches}")
    del params, opt, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # card against CPU: two steps from the same seeded params (drawn on the
    # card, the CPU's generator is slow at 1.3 G values; compared on the card)
    cfg1 = dataclasses.replace(base, num_layers=1) if full else base.reduced()
    S1 = 64 if full else 32
    r1 = RunConfig(model=cfg1, seq_len=S1, global_batch=2, microbatch=1,
                   learning_rate=TRAIN_LR, warmup_steps=2)
    data1 = SyntheticLM(DataConfig(cfg1.vocab_size, S1, 2))
    p0 = init_params(1, cfg1, device=dev)
    p_dev = tree_map(torch.clone, p0)
    p_cpu = tree_map(lambda t: t.to("cpu", copy=True), p0)
    res = {}
    for name, p in (("card", p_dev), ("cpu", p_cpu)):
        d = tree_items(p)[0][1].device
        step1, o, mets = build_train_step(cfg1, r1, d), init_state(p), []
        t0 = time.perf_counter()
        for s in range(TRAIN_VERSUS_STEPS):
            toks, tgts = data1.batch(s)
            p, o, met = step1(p, o, torch.from_numpy(toks).to(d), torch.from_numpy(tgts).to(d),
                              None, s)
            mets.append({k: float(v) for k, v in met.items()})
        res[name] = (mets, o, time.perf_counter() - t0)
    (mc, oc, tc), (mg, og, tg) = res["cpu"], res["card"]
    t0 = time.perf_counter()
    moved = apart = m_apart = m_norm = diff = 0.0
    for (_, a), (_, b), (_, c) in zip(tree_items(p_dev), tree_items(p_cpu), tree_items(p0)):
        b = b.to(dev)
        moved += float(torch.sum(torch.square(b - c)))
        apart += float(torch.sum(torch.square(a - b)))
        diff = max(diff, float((a - b).abs().max()))
    for (_, a), (_, b) in zip(tree_items(og["m"]), tree_items(oc["m"])):
        b = b.to(dev)
        m_apart += float(torch.sum(torch.square(a - b)))
        m_norm += float(torch.sum(torch.square(b)))
    versus = dict(layers=cfg1.num_layers, tokens=[2, S1], steps=TRAIN_VERSUS_STEPS,
                  loss_card=[m["loss"] for m in mg], loss_cpu=[m["loss"] for m in mc],
                  loss_rel=[abs(g["loss"] - c["loss"]) / abs(c["loss"]) for g, c in zip(mg, mc)],
                  grad_norm_rel=max(abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
                                    for g, c in zip(mg, mc)),
                  update_rel=math.sqrt(apart / moved), m_rel=math.sqrt(m_apart / m_norm),
                  master_max_diff_in_lr=diff / mc[-1]["lr"],
                  loss_tol=TRAIN_LOSS_REL, grad_norm_tol=TRAIN_GNORM_REL,
                  update_tol=TRAIN_UPDATE_REL, card_s=tg, cpu_s=tc,
                  compare_s=time.perf_counter() - t0)
    log("train card-vs-cpu " + json.dumps(versus))
    if (max(versus["loss_rel"]) > TRAIN_LOSS_REL or versus["grad_norm_rel"] > TRAIN_GNORM_REL
            or not versus["update_rel"] <= TRAIN_UPDATE_REL):
        fail(f"train: the card's steps are not the CPU's: {versus}")
    if not int(og["step"]) == int(oc["step"]) == TRAIN_VERSUS_STEPS:
        fail(f"train: the step counters {int(og['step'])}, {int(oc['step'])} are not "
             f"{TRAIN_VERSUS_STEPS}")
    del p_cpu, p_dev, oc, og, res

    # AdamW alone on the card against the CPU: the same f32 masters (the
    # depth-1 model's but the embedding and the head) and the same seeded
    # grads, every other step clipped; compared after the last step
    t0 = time.perf_counter()
    card = {k: v for k, v in p0.items() if k not in ("embed", "lm_head")}
    cpu = tree_map(lambda t: t.to("cpu", copy=True), card)
    s_cpu, s_card = init_state(cpu), init_state(card)
    n = sum(t.numel() for _, t in tree_items(cpu))
    gen = torch.Generator(device=dev).manual_seed(3)
    adam = dict(leaves=len(tree_items(cpu)), params=n, steps=TRAIN_ADAMW_STEPS,
                grad_norm_rel=0.0, clipped=[], tol_ulps=TRAIN_ADAMW_ULPS,
                grad_norm_tol=TRAIN_ADAMW_GNORM_REL)
    for it in range(TRAIN_ADAMW_STEPS):
        scale = 0.5 / math.sqrt(n) if it % 2 else 0.5
        g = tree_map(lambda t: scale * torch.randn(t.shape, generator=gen, device=dev), card)
        lr = TRAIN_LR * (it + 1)
        g_cpu = tree_map(lambda t: t.to("cpu", copy=True), g)   # both are consumed
        card, s_card, m_card = apply_updates(card, g, s_card, lr, AdamWConfig())
        cpu, s_cpu, m_cpu = apply_updates(cpu, g_cpu, s_cpu, lr, AdamWConfig())
        gn = float(m_cpu["grad_norm"])
        adam["clipped"].append(gn > 1.0)
        adam["grad_norm_rel"] = max(adam["grad_norm_rel"],
                                    abs(float(m_card["grad_norm"]) - gn) / gn)
        del g, g_cpu
    for key, want, got in (("p", cpu, card), ("m", s_cpu["m"], s_card["m"]),
                           ("v", s_cpu["v"], s_card["v"])):
        adam[key] = 0.0
        for (_, a), (_, b) in zip(tree_items(want), tree_items(got)):
            a = a.to(dev)
            top = np.float32(float(a.abs().max()))
            adam[key] = max(adam[key], float((b - a).abs().max()) / float(np.spacing(top)))
    adam["seconds"] = time.perf_counter() - t0
    log("train adamw card-vs-cpu " + json.dumps(adam))
    if (max(adam["p"], adam["m"], adam["v"]) > TRAIN_ADAMW_ULPS
            or adam["grad_norm_rel"] > TRAIN_ADAMW_GNORM_REL
            or adam["clipped"] != [it % 2 == 0 for it in range(TRAIN_ADAMW_STEPS)]
            or int(s_card["step"]) != TRAIN_ADAMW_STEPS):
        fail(f"train: AdamW on the card is not the CPU's: {adam}")
    del cpu, card, s_cpu, s_card, p0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # restart: a failure injected one step after the checkpoint at step 4
    saved, restored = {}, []
    real_save, real_restore = ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore

    def save(self, step, tree, **kw):
        saved[step] = {k: ckpt._to_host(v) for k, v in ckpt._flatten(tree)}
        return real_save(self, step, tree, **kw)

    def restore(self, tree_like, step=None, shard_id=0, **kw):
        tree, got = real_restore(self, tree_like, step, shard_id, **kw)
        # host bytes now: the train step then updates the restored masters in place
        restored.append((None if tree is None else
                         {k: ckpt._to_host(v).tobytes() for k, v in ckpt._flatten(tree)}, got))
        return tree, got

    with tempfile.TemporaryDirectory(prefix="train-restart-") as d:
        args = ["--arch", "qwen2-7b", "--reduced", "--seq-len", "64", "--global-batch", "4",
                "--microbatch", "2", "--ckpt-dir", d, "--ckpt-every", "4", "--log-every", "4",
                "--device", dev.type]
        ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore = save, restore
        os.environ["REPRO_INJECT_FAIL_AT"] = "5"
        try:
            first = train_driver.main(args + ["--steps", "12"])
            os.environ.pop("REPRO_INJECT_FAIL_AT")
            n_restored = len(restored)
            resumed = train_driver.main(args + ["--steps", "14"])
        finally:
            os.environ.pop("REPRO_INJECT_FAIL_AT", None)
            ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore = real_save, real_restore
        latest = ckpt.CheckpointManager(d).latest_step()
    back = [r for r in restored[:n_restored] if r[1] is not None]
    same = bool(back) and back[0][0].keys() == saved[back[0][1]].keys() and all(
        b == saved[back[0][1]][k].tobytes() for k, b in back[0][0].items())
    restart = dict(restored_from=back[0][1] if back else None, bytes_equal=same,
                   losses=len(first), loss_first_pass=first[4] if len(first) > 5 else None,
                   loss_after_restore=first[5] if len(first) > 5 else None,
                   resumed_from=restored[n_restored][1] if len(restored) > n_restored else None,
                   resumed_losses=len(resumed), latest_step=latest, tol=TRAIN_RESTART_REL)
    log("train restart " + json.dumps(restart))
    if restart["restored_from"] != 4 or not same or len(first) != 13:
        fail(f"train: the guard did not restore step 4 byte-equal and finish: {restart}")
    if abs(first[5] - first[4]) > TRAIN_RESTART_REL * abs(first[4]):
        fail(f"train: the restored step's loss is not the first pass's: {restart}")
    if restart["resumed_from"] != 12 or len(resumed) != 2 or latest != 14:
        fail(f"train: a fresh driver did not resume from step 12: {restart}")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return (dict(full_width=summary, card_vs_cpu=versus, adamw=adam, restart=restart),)


# --------------------------------------------------------------------- tp
TP = 2
K1_ONLY = ("ams_matmul_fp533",)
# layer 0's K1 / K1b projections in call order: (block subtree, linear)
TP_PROJ = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
# MiniCPM3-4B's (w_uk / w_uv are dequantized for the absorb, not K1;
# wq_a / wkv_a are whole on every rank)
MLA_PROJ = [("attn", "wq_a"), ("attn", "wq_b"), ("attn", "wkv_a"), ("attn", "wo"),
            ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
MAMBA_PROJ = [("mixer", "in_proj"), ("mixer", "x_proj"), ("mixer", "dt_proj"),
              ("mixer", "out_proj")]
RGLRU_PROJ = [("mixer", "in_gate"), ("mixer", "in_x"), ("mixer", "w_rec_gate"),
              ("mixer", "w_in_gate"), ("mixer", "out_proj"),
              ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
# tensor-parallel serving: a (1, 2) mesh of two spawned ranks that share the
# one card (gloo: NCCL refuses two ranks on one device), each path served as
# its base path's workload at ``depth`` layers (None: all); ``proj`` are
# layer 0's K1 / K1b calls of a decode tick held against tp = 1 (a dense
# layer's 7, a MoE layer's 4 attention projections: its experts are whole on
# their rank; ``k1`` overrides their number); ``ep``: the MoE decodes
# expert-parallel, whose capacity drops tokens that tp = 1's dense combine
# keeps, so its logits and streams at the config's factor are printed, and
# held bit-equal to tp = 1 in a second serve at the factor that drops
# nothing (`_no_drop_capacity`); ``lean``: cuBLAS projections, whose
# N-shards may change bits, so the first logits are held within LOGIT_TOL
# and the streams printed; ``merged``: a sequence-sharded contiguous cache
# (GQA, the MLA stream, the hybrid's rings), whose ranks merge their
# partial softmaxes in plain torch where tp = 1 launches K4 / K5 (the
# reference's routing: K1 alone runs at tp = 2, ``kernels``), so the first
# logits are held within LOGIT_TOL, the streams' first diverging tokens
# printed, and the merge of layer 0's (the first attention layer's) call
# on tp = 1's inputs held within MERGE_TOL of one rank's plain walk;
# ``states``: recurrent states, gathered from the ranks' halves of the
# inner width at the end of the run: bit-equal to tp = 1's, or on a
# ``merged`` path (whose long request puts keys on rank 1) bit-equal up to
# the first attention layer and within LOGIT_TOL of max |state| after it. Every
# other path's streams and first-tick logits are held bit-equal to tp = 1's.
# ``long``: one more request, submitted first, whose prompt of that many
# tokens runs past a rank's half of the sequence-sharded cache (256 of 512
# rows; 1024 of the ring's 2048 slots, on an engine of ``capacity`` 1280);
# the taps arm on the first all-decode tick it takes part in, so the logits
# and merged attention held there read keys on both ranks; each rank's
# written rows of layer 0's cache at that tick are printed, and rank 1's
# must be > 0
TP_PATHS = {
    "tp2-fp5.33": dict(base="fp5.33", depth=None),
    "tp2-moe-fp4.25": dict(base="moe-fp4.25", depth=2, k1=4, ep=True),
    "tp2-fp16": dict(base="fp16", depth=4, k1=0, lean=True),
    "tp2-contig-fp5.33": dict(base="contig-fp5.33", depth=None, merged=True, kernels=K1_ONLY,
                              long=300),
    "tp2-mla-fp5.33": dict(base="mla-fp5.33", depth=4, merged=True, kernels=K1_ONLY,
                           proj=MLA_PROJ, long=300),
    "tp2-ssm-fp5.33": dict(base="ssm-fp5.33", depth=4, states=True, proj=MAMBA_PROJ),
    "tp2-hybrid-fp5.33": dict(base="hybrid-fp5.33", depth=5, states=True, merged=True,
                              proj=RGLRU_PROJ, long=1100, capacity=1280),
}
# the long request's prompt on the CPU rehearsal (capacity 64: 32 rows a rank)
TINY_LONG = 56
TP1_EAGER_TICKS = 8
# the merged flash-decode against one rank's walk over the whole cache, both
# with f32 queries (so the outputs are not rounded to bf16): max |d| / max
# |o|, the reference's own bound for its sharded cores
MERGE_TOL = 2e-5
TP_NOTE = ("two worlds of two ranks each time-slice one card: these times say nothing of "
           "the speed of two cards; collective_ms is host time in gloo, staged through "
           "pinned host memory")
# the tp = 2 paths run in two worlds at once, each serving its paths in
# turn: a rank's eager tick waits on its syncs and gloo, which the other
# world's work overlaps (the two split the slowest paths, full-depth Qwen2-7B
# and the hybrid's 1100 one-token ticks, evenly)
TP_WORLDS = (("tp2-fp5.33", "tp2-fp16", "tp2-mla-fp5.33", "tp2-contig-fp5.33"),
             ("tp2-hybrid-fp5.33", "tp2-moe-fp4.25", "tp2-ssm-fp5.33"))


def _tp_proj(spec):
    return spec.get("proj", TP_PROJ)[:spec.get("k1", len(spec.get("proj", TP_PROJ)))]


def _tp_kernels(spec):
    return spec.get("kernels", PATHS[spec["base"]]["kernels"])


class _StepTaps:
    """Taps on the eager engine step, installed while open: the first
    step's logits, and on the tick ``armed`` marks, layer 0's first ``k1``
    K1 / K1b calls (x, y), its paged attention call (q, the layer's pool,
    lengths, block table, output) or its first contiguous one (q, the
    layer's K and V caches, lengths, the call's options, output), the
    head's product (x, y) and the MoE FFN's call (x, y). Everything is
    copied to the host."""

    def __init__(self, torch, k1: int):
        from repro_torch.kernels import ops
        from repro_torch.launch import steps
        from repro_torch.models import attention, moe, transformer

        self.torch, self.n_k1 = torch, k1
        self.logits, self.armed = None, False
        self.k1, self.attn, self.head, self.moe, self.contig = [], None, None, None, None
        self.sites = [(ops, "ams_matmul", self._k1), (attention, "paged_attend", self._attn),
                      (attention, "attend_contiguous", self._contig),
                      (transformer, "apply_linear", self._head), (steps, "sample_tokens",
                                                                  self._logits),
                      (moe, "moe_dense", self._moe), (moe, "moe_ep", self._moe)]
        self.orig = {}

    def __enter__(self):
        for mod, name, tap in self.sites:
            self.orig[mod, name] = getattr(mod, name)
            setattr(mod, name, (lambda tap, f: lambda *a, **k: tap(f, *a, **k))(
                tap, self.orig[mod, name]))
        return self

    def __exit__(self, *exc):
        for (mod, name), f in self.orig.items():
            setattr(mod, name, f)

    @staticmethod
    def _host(t):
        from repro_torch.core.tree import tree_map
        return tree_map(lambda x: x.detach().to("cpu", copy=True), t)   # a copy on CPU too

    def _k1(self, f, x, pw, n_split=None):
        y = f(x, pw, n_split=n_split)
        if self.armed and len(self.k1) < self.n_k1:
            self.k1.append(dict(x=self._host(x), y=self._host(y), N=pw.N, n_split=n_split))
        return y

    def _attn(self, f, q, pool, lengths, block_table, ccfg, **kw):
        o = f(q, pool, lengths, block_table, ccfg, **kw)
        if self.armed and self.attn is None:
            self.attn = dict(q=self._host(q), pool=self._host(pool), lengths=self._host(lengths),
                             block_table=self._host(block_table), out=self._host(o),
                             scale=kw.get("scale"))
        return o

    def _contig(self, f, q, k_cache, v_cache, lengths, **kw):
        o = f(q, k_cache, v_cache, lengths, **kw)
        if self.armed and self.contig is None:
            self.contig = dict(q=self._host(q), k=self._host(k_cache), v=self._host(v_cache),
                               lengths=self._host(lengths), out=self._host(o),
                               kv_map=kw["kv_map"], scale=kw.get("scale"),
                               window=kw.get("window", 0), ring=kw.get("ring", False))
        return o

    def _head(self, f, p, x, policy=None, shards=1):
        y = f(p, x, policy, shards)
        if self.armed and self.head is None:
            self.head = dict(x=self._host(x), y=self._host(y))
        return y

    def _logits(self, f, logits, sampling):
        if self.logits is None:
            self.logits = self._host(logits)
        return f(logits, sampling)

    def _moe(self, f, p, x, cfg, *a, **k):
        y, aux = f(p, x, cfg, *a, **k)
        if self.armed and self.moe is None:
            self.moe = dict(x=self._host(x), y=self._host(y))
        return y, aux


@contextlib.contextmanager
def _no_drop_capacity():
    """While open, `moe_ep` serves at the capacity factor E / k, where
    every expert takes every token and nothing drops."""
    from repro_torch.models import moe

    real = moe.expert_capacity
    moe.expert_capacity = lambda T, cfg: real(T, dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token))
    try:
        yield
    finally:
        moe.expert_capacity = real


def _dropped_pairs(torch, routes, cfg) -> tuple:
    """(token, expert) pairs routed and those past the experts' capacity
    (`moe.expert_capacity` as it stands), over the router calls of a
    `moe.record_routes` record."""
    from repro_torch.models import moe

    routed = dropped = 0
    for top_i, _ in routes:
        n = torch.bincount(top_i.reshape(-1), minlength=cfg.num_experts)
        routed += top_i.numel()
        dropped += int((n - moe.expert_capacity(top_i.shape[0], cfg)).clamp_min(0).sum())
    return routed, dropped


def _tp_config(spec, dev_str: str, full: bool, mesh=None):
    from repro_torch.cache import CacheConfig
    from repro_torch.launch.config import EngineConfig

    base = PATHS[spec["base"]]
    if full:
        return EngineConfig(arch=base["arch"], reduced=False, depth=spec["depth"],
                            scheme=base["scheme"], impl="kernel", slots=8,
                            capacity=spec.get("capacity", 512),
                            prefill_chunk=base.get("chunk", 16), mesh=mesh, device=dev_str,
                            seed=0,
                            cache=CacheConfig(kind=base["kind"], page_size=16, impl="kernel"))
    return EngineConfig(arch=base["arch"], reduced=True, scheme=base["scheme"], impl="kernel",
                        slots=4, capacity=64, prefill_chunk=base.get("chunk", 4), mesh=mesh,
                        device=dev_str, seed=0,
                        cache=CacheConfig(kind=base["kind"], page_size=8, impl="kernel"))


def _tp_workload(np, cfg, spec, full: bool):
    """The base path's serve-phase workload (`phase_serve`): prompts (the
    last sharing the first's page-aligned prefix) and new tokens each."""
    if not full:
        n_req, plen, max_tokens, shared = 6, (12, 24), 8, 8
    elif spec["base"] == MAIN_PATH:
        n_req, plen, max_tokens, shared = 10, (200, 320), 40, 128
    elif PATHS[spec["base"]].get("chunk") == 1:        # the one-token step (phase_serve's)
        n_req, plen, max_tokens, shared = 9, (32, 97), 24, 0
    else:
        n_req, plen, max_tokens, shared = 9, (96, 192), 24, 64
    rng = np.random.default_rng(1234)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(plen[0], plen[1], n_req)]
    prompts[-1][:shared] = prompts[0][:shared]
    if spec.get("long"):
        n = spec["long"] if full else TINY_LONG
        prompts.insert(0, np.random.default_rng(4321).integers(0, cfg.vocab_size, n)
                       .astype(np.int32))
    return prompts, max_tokens


def _written_rows(torch, cache) -> int:
    """(slot, row) pairs of the rank's layer-0 attention cache (the first
    ``k`` / ``kv`` leaf: a contiguous shard or a ring) holding any nonzero
    value."""
    from repro_torch.core.tree import tree_items

    for path, t in tree_items(cache):
        if path[-1] in ("k", "kv"):
            t = t[0] if path[0] == "layers" else t
            return int((t.reshape(t.shape[0], t.shape[1], -1) != 0).any(-1).sum())
    return 0


def _tp_serve(torch, np, eng, spec, full: bool, mesh=None):
    """Serve the path's workload under `_StepTaps`, arming them on the first
    tick whose every active slot decodes. A tp = 1 engine on the card
    replays its graphs (bit-equal to its eager step: `phase_graph`) but on
    the first tick, the armed one and the `TP1_EAGER_TICKS` after it, which
    run the eager step the taps see and time it; a tp = 2 engine has no
    graphs. The armed tick, which copies its taps to the host, is not
    timed. At tp > 1 the router calls are recorded and the pairs that the
    experts' capacity dropped counted after the run. With ``states`` the
    result holds the recurrent state leaves (conv / ssm / state) as the
    run left them, on the host. Returns (taps, result)."""
    from repro_torch.models import moe

    prompts, max_tokens = _tp_workload(np, eng.cfg, spec, full)
    counts = all_counts()
    for cnt in counts:
        cnt.reset()
    handles = [eng.submit(p, max_tokens) for p in prompts]
    ticks, dec_ms, graph_ms, coll_ms, armed_tick = 0, [], [], [], None
    armed_lengths, written = [], None
    long_rid = handles[0].rid if spec.get("long") else None
    with _StepTaps(torch, len(_tp_proj(spec))) as taps, moe.record_routes() as routes:
        while eng.has_work:
            decoding = eng.active_count > 0 and all(
                r is None or eng.fed[s] >= r.prompt_len for s, r in enumerate(eng.active)) and (
                long_rid is None or any(r is not None and r.rid == long_rid for r in eng.active))
            taps.armed = decoding and armed_tick is None
            if taps.armed:
                armed_tick = ticks
            eager = eng.graphs is None or ticks == 0 or (
                armed_tick is not None and ticks - armed_tick <= TP1_EAGER_TICKS)
            c0 = mesh.collective_seconds if mesh is not None else 0.0
            t0 = time.perf_counter()
            if taps.armed:
                armed_lengths = [int(eng.fed[s]) for s, r in enumerate(eng.active)
                                 if r is not None]
            eng.step(eager=eager)
            if taps.armed:
                written = _written_rows(torch, eng.cache) if spec.get("merged") else None
            if decoding and not taps.armed:
                (dec_ms if eager else graph_ms).append(1e3 * (time.perf_counter() - t0))
                if mesh is not None:
                    coll_ms.append(1e3 * (mesh.collective_seconds - c0))
            ticks += 1
    launches = {cnt.name: cnt.launches for cnt in counts}
    routed, dropped = _dropped_pairs(torch, routes, eng.cfg) if mesh is not None else (0, 0)
    del routes
    res = dict(streams=[list(map(int, h.tokens)) for h in handles], ticks=ticks,
               armed_tick=armed_tick, launches=launches,
               plain_calls_on_cuda=sum(cnt.plain_on_cuda for cnt in counts),
               eager_decode_tick_ms=float(np.mean(dec_ms)) if dec_ms else 0.0,
               eager_decode_ticks=len(dec_ms),
               graph_decode_tick_ms=float(np.mean(graph_ms)) if graph_ms else None,
               collective_ms_per_tick=float(np.mean(coll_ms)) if coll_ms else 0.0,
               collective_calls=mesh.collective_calls if mesh is not None else 0,
               weight_bytes=weight_bytes(eng.params)["total"],
               param_bytes=_nbytes(eng.params), pool_bytes=_nbytes(eng.cache),
               kv_bytes_per_token=eng.kv_bytes_per_token(), tp=eng.tp,
               graphs=eng.stats()["graphs"], moe_pairs_routed=routed,
               moe_pairs_dropped=dropped, armed_lengths=armed_lengths,
               written_rows_at_armed_tick=written)
    if spec.get("states"):
        from repro_torch.core.tree import tree_items
        res["states"] = {"/".join(p): t.to("cpu", copy=True) for p, t in tree_items(eng.cache)
                         if p[-1] in ("conv", "ssm", "state")}
    bad = [i for i, h in enumerate(handles) if not h.done or len(h.tokens) != max_tokens]
    if bad:
        fail(f"tp: requests {bad} did not finish with {max_tokens} tokens")
    return taps, res


def _nbytes(tree) -> int:
    from repro_torch.core.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _bits_equal(torch, a, b) -> bool:
    """Same shape, dtype and bits (-0.0 and NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _tp_checks(torch, eng, spec, one, taps, dev):
    """This rank's comparisons with the tp = 1 run ``one`` (its taps):
    layer 0's sharded K1 / K1b outputs and K2 / K3 heads on tp = 1's inputs,
    bit for bit (direct calls, after the counts were read); the merged
    contiguous attention on tp = 1's inputs (`_merged_attention`); the
    head's columns; the first step's logits; the MoE FFN with nothing
    dropped against tp = 1's moe_dense."""
    import dataclasses

    from repro_torch.cache import paged_attend
    from repro_torch.core.formats import get_scheme
    from repro_torch.core.packing import PackedWeight, make_layout
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import in_proj_halves
    from repro_torch.models import moe as M
    from repro_torch.models.attention import kv_index_map
    from repro_torch.models.common import apply_linear

    r, tp = eng.ctx.rank, eng.tp
    on = lambda t: tree_map(lambda x: x.to(dev), t)              # noqa: E731
    cols = lambda t, n: t[..., r * n:(r + 1) * n]                # noqa: E731
    out = {}
    blk = tree_map(lambda t: t[0], eng.params["layers"]["sub0"])
    k1 = []
    for (sub, name), rec, mine in zip(_tp_proj(spec), one["k1"], taps.k1):
        p = blk[sub][name]
        pw = PackedWeight(p["hi"], p["lsb"], p["scale"],
                          make_layout(get_scheme(eng.config.scheme)), rec["x"].shape[-1],
                          p["scale"].shape[-1])
        sharded = pw.N != rec["N"]              # wq_a / wkv_a are whole on every rank
        y = ops.ams_matmul(on(rec["x"]), pw, n_split=rec["N"] if sharded else None).cpu()
        n = pw.N
        # the rank's columns of tp = 1's output (in_proj: of each half, [x | z])
        parts = in_proj_halves([name]) if sharded else 1
        w, m = rec["y"].shape[-1] // parts, n // parts
        want = torch.cat([rec["y"][..., i * w + r * m:i * w + (r + 1) * m] for i in range(parts)],
                         dim=-1) if sharded else rec["y"]
        k1.append(dict(name=name, N=rec["N"], shard_N=n if sharded else None,
                       tp1_inputs_bit_equal=_bits_equal(torch, y, want),
                       engine_call_bit_equal=_bits_equal(torch, mine["x"], rec["x"])
                       and _bits_equal(torch, mine["y"], want)))
    out["k1"] = k1
    c = one["contig"]
    if c is not None:
        out["contiguous_attention"] = _merged_attention(torch, eng, c, on)
    a = one["attn"]
    if a is not None:
        kv_loc = tree_leaves(eng.cache)[0].shape[-2]
        hq = a["q"].shape[-2] // tp
        pool = tree_map(lambda t: t.narrow(t.dim() - 2, r * kv_loc, kv_loc).contiguous(),
                        a["pool"])
        q = a["q"].narrow(a["q"].dim() - 2, r * hq, hq).contiguous()
        o = paged_attend(on(q), on(pool), on(a["lengths"]), on(a["block_table"]),
                         eng.cache_cfg, kv_map=kv_index_map(hq, hq, kv_loc),
                         scale=a["scale"]).cpu()
        want = a["out"].narrow(a["out"].dim() - 2, r * hq, hq)
        out["attention"] = dict(kv_heads=kv_loc, q_heads=hq,
                                tp1_inputs_bit_equal=_bits_equal(torch, o, want))
    h = one["head"]
    y = apply_linear(eng.params["lm_head"], on(h["x"]), None).cpu()
    out["head_columns_bit_equal"] = _bits_equal(torch, y, cols(h["y"], y.shape[-1]))
    l1, l2 = one["logits"], taps.logits
    out["first_logits"] = dict(bit_equal=_bits_equal(torch, l1, l2),
                               rel_err=float((l1 - l2).abs().max() / l1.abs().max()))
    if one["moe"] is not None:
        cfg = eng.cfg
        nodrop = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts
                                     / cfg.experts_per_token)
        y, _ = M.moe_ep(blk["moe"], on(one["moe"]["x"]), nodrop, eng.ctx,
                        eng.rcfg.quant if eng.rcfg.quantized else None)
        want = one["moe"]["y"].float()
        out["moe_ep_vs_dense"] = dict(capacity_factor=nodrop.moe_capacity_factor,
                                      rel_err=float((y.cpu().float() - want).abs().max()
                                                    / want.abs().max()))
    return out


def _merged_attention(torch, eng, c, on):
    """The sequence-sharded flash-decode of this rank's shard of tp = 1's
    recorded cache and tp = 1's q (the ranks merge) against one rank's walk
    over the whole cache, both in plain torch on the card: in f32 (q and
    the caches' bf16 values taken as f32, so p is not rounded to bf16 and
    only the f32 sums' order differs: max |d| / max |o|, held within
    MERGE_TOL), and as served, bf16 (whether the outputs keep their bits:
    a score one ulp apart can round p one bf16 ulp apart); at the recorded
    lengths, which the served prompts keep inside rank 0's half, and with
    every cache row visible (lengths of the capacity, of two windows on a
    ring), so that both halves hold keys. Beside it, that plain walk
    against the kernel output tp = 1 recorded (K4 / K5; the plain
    flash-decode on the ring)."""
    from repro_torch.kernels.attention_template import flash_decode, flash_decode_chunk

    r, tp = eng.ctx.rank, eng.tp
    S = c["k"].shape[1]
    s = S // tp
    part = lambda t: on(t.narrow(1, r * s, s).contiguous())      # noqa: E731
    one_token = c["q"].dim() == 3
    kw = dict(kv_map=c["kv_map"], scale=c["scale"])
    if one_token:
        kw.update(window=c["window"], ring=c["ring"])
    fn = flash_decode if one_token else flash_decode_chunk
    every = torch.full_like(c["lengths"], 2 * S if c["ring"] else S)
    out = dict(keys=S, shard_keys=s, one_token=one_token, ring=bool(c["ring"]))
    for tag, lengths in (("recorded", c["lengths"]), ("every_row", every)):
        res = {}
        for name, dt in (("f32", torch.float32), ("bf16", c["q"].dtype)):
            q, k, v = (c[n].to(dt) for n in ("q", "k", "v"))
            whole = fn(on(q), on(k), on(v), on(lengths), **kw)
            merged = fn(on(q), part(k), part(v), on(lengths), ctx=eng.ctx, **kw)
            res[name] = (whole.float(), merged.float())
        (w32, m32), (wb, mb) = res["f32"], res["bf16"]
        out[tag] = dict(rel_err_f32=float((m32 - w32).abs().max() / w32.abs().max()),
                        rel_err_bf16=float((mb - wb).abs().max() / wb.abs().max()),
                        bf16_bit_equal=bool(torch.equal(mb, wb)),
                        bf16_elements_apart=int((mb != wb).sum()))
        if tag == "recorded":
            ref = c["out"].float().to(wb.device)
            out["plain_vs_tp1_call_rel"] = float((wb - ref).abs().max() / ref.abs().max())
    top = int(c["lengths"].max())
    out["recorded_max_length"] = top
    # keys rank 1's shard holds at the recorded lengths (a ring's slot p % S)
    out["recorded_rank1_keys"] = s if top > S else max(0, top - s)
    out["rel_err_f32"] = max(out["recorded"]["rel_err_f32"], out["every_row"]["rel_err_f32"])
    return out


def _tp_rank(mesh, paths, full: bool, oracle_dir: str):
    """One rank of the tp phase: each path's tp = 2 engine served under the
    taps, then `_tp_checks` against the tp = 1 run saved in ``oracle_dir``."""
    import numpy as np
    import torch

    from repro_torch.launch.engine import ServeEngine

    dev = mesh.device
    cuda = dev.type == "cuda"
    if not cuda:                     # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // mesh.tp))
    out = {}
    for name in paths:
        spec = TP_PATHS[name]
        one = torch.load(Path(oracle_dir) / f"{name}.pt", weights_only=False)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = ServeEngine(_tp_config(spec, "cuda" if cuda else "cpu", full, mesh))
        init_s = time.perf_counter() - t0
        taps, res = _tp_serve(torch, np, eng, spec, full, mesh)
        res.update(init_seconds=init_s, checks=_tp_checks(torch, eng, spec, one, taps, dev))
        if cuda:
            res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        del eng, taps
        gc.collect()
        if spec.get("ep"):
            with _no_drop_capacity():
                eng = ServeEngine(_tp_config(spec, "cuda" if cuda else "cpu", full, mesh))
                taps, nd = _tp_serve(torch, np, eng, spec, full, mesh)
            res["no_drop"] = dict(streams=nd["streams"], moe_pairs_dropped=nd["moe_pairs_dropped"],
                                  first_logits_bit_equal=_bits_equal(torch, one["logits"],
                                                                     taps.logits))
            del eng, taps
            gc.collect()
        out[name] = res
    return out


def _first_divergence(got, want):
    return [next((t for t, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]


def phase_tp(torch, dev, timed: bool = True, full: bool = True):
    """Tensor-parallel serving (see the module docstring): each path's tp = 1
    engine served eagerly here under `_StepTaps` (the oracle), then two
    worlds of two spawned ranks at once on this device, each serving its
    paths of TP_WORLDS at tp = 2 (`_tp_rank`), the ranks' results checked
    and printed, then the sharded kernel shapes timed here. Returns (the
    per-path lines, the kernel rows' figures)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.mesh import spawn

    cuda = dev.type == "cuda"
    dev_str = "cuda" if cuda else "cpu"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("tp world " + json.dumps(dict(
        tp=TP, worlds=len(TP_WORLDS), backend="gloo", device=dev_str,
        cards=torch.cuda.device_count() if cuda else 0,
        ranks_share_one_card=cuda, why="NCCL refuses two ranks on one device; gloo's "
        "collectives of CUDA tensors are staged through pinned host buffers")))
    ones = {}
    with tempfile.TemporaryDirectory(prefix="tp-oracle-") as tmp:
        for name, spec in TP_PATHS.items():
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            eng = ServeEngine(_tp_config(spec, dev_str, full))
            taps, res = _tp_serve(torch, np, eng, spec, full)
            if cuda:
                res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
            torch.save(dict(k1=taps.k1, attn=taps.attn, head=taps.head, logits=taps.logits,
                            moe=taps.moe, contig=taps.contig), Path(tmp) / f"{name}.pt")
            ones[name] = res
            del eng, taps
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        with ThreadPoolExecutor(len(TP_WORLDS)) as pool:
            worlds = [pool.submit(spawn, _tp_rank, {"model": TP}, dev_str, list(paths), full,
                                  tmp, backend="gloo") for paths in TP_WORLDS]
            worlds = [w.result() for w in worlds]
        ranks = [{k: v for w in worlds for k, v in w[r].items()} for r in range(TP)]
    lines = {}
    for name, spec in TP_PATHS.items():
        one, rs = ones[name], [r[name] for r in ranks]
        base = PATHS[spec["base"]]
        first = _first_divergence(rs[0]["streams"], one["streams"])
        line = dict(
            path=name, base=spec["base"], arch=base["arch"], scheme=base["scheme"],
            depth=spec["depth"], tp=TP, ranks_agree=rs[0]["streams"] == rs[1]["streams"],
            streams_equal_tp1=all(f is None for f in first), first_diverging_token=first,
            first_logits=[r["checks"]["first_logits"] for r in rs],
            head_columns_bit_equal=[r["checks"]["head_columns_bit_equal"] for r in rs],
            k1=[r["checks"]["k1"] for r in rs],
            attention=[r["checks"].get("attention") for r in rs],
            contiguous_attention=[r["checks"].get("contiguous_attention") for r in rs],
            states=_tp_states(torch, one, rs, base["arch"]) if spec.get("states") else None,
            moe_ep_vs_dense=[r["checks"].get("moe_ep_vs_dense") for r in rs],
            moe_pairs_dropped_per_tick=[r["moe_pairs_dropped"] / r["ticks"] for r in rs],
            moe_pairs_routed_per_tick=[r["moe_pairs_routed"] / r["ticks"] for r in rs],
            no_drop=[dict(streams_equal_tp1=r["no_drop"]["streams"] == one["streams"],
                          first_diverging_token=_first_divergence(r["no_drop"]["streams"],
                                                                  one["streams"]),
                          first_logits_bit_equal=r["no_drop"]["first_logits_bit_equal"],
                          moe_pairs_dropped=r["no_drop"]["moe_pairs_dropped"])
                     for r in rs] if spec.get("ep") else None,
            eager_decode_tick_ms=dict(tp1=one["eager_decode_tick_ms"],
                                      tp2=[r["eager_decode_tick_ms"] for r in rs]),
            collective_ms_per_tick=[r["collective_ms_per_tick"] for r in rs],
            collective_calls=[r["collective_calls"] for r in rs],
            eager_decode_ticks=dict(tp1=one["eager_decode_ticks"],
                                    tp2=[r["eager_decode_ticks"] for r in rs]),
            tp1_graph_decode_tick_ms=one["graph_decode_tick_ms"],
            weight_bytes=dict(tp1=one["weight_bytes"], tp2=[r["weight_bytes"] for r in rs]),
            pool_bytes=dict(tp1=one["pool_bytes"], tp2=[r["pool_bytes"] for r in rs]),
            kv_bytes_per_token=dict(tp1=one["kv_bytes_per_token"],
                                    tp2=[r["kv_bytes_per_token"] for r in rs]),
            peak_memory_bytes=dict(tp1=one.get("peak_memory_bytes"),
                                   tp2=[r.get("peak_memory_bytes") for r in rs]),
            init_seconds=[r["init_seconds"] for r in rs],
            long_prompt=spec.get("long"),
            armed_lengths=dict(tp1=one["armed_lengths"], tp2=[r["armed_lengths"] for r in rs]),
            written_rows_per_rank=[r["written_rows_at_armed_tick"] for r in rs],
            launches=dict(tp1=one["launches"], tp2=[r["launches"] for r in rs]),
            graphs=[r["graphs"] for r in rs], note=TP_NOTE)
        lines[name] = line
        log("tp " + json.dumps(line))
    for name, spec in TP_PATHS.items():          # every path printed before any fails
        _tp_fatal(name, spec, ones[name], [r[name] for r in ranks], lines[name], cuda)
    _cublas_shard_columns(torch, dev, full)
    return lines, _tp_kernel_times(torch, dev, timed, full)


def _tp_states(torch, one, rs, arch: str) -> dict:
    """Each recurrent state leaf of the tp = 1 run against the two ranks'
    halves concatenated along its inner width (`cache_shard_dim`): whether
    the bits are equal, max |d| / max |state|, and whether the leaf's first
    repeat runs before any attention layer (``upstream``: nothing merged
    across ranks feeds it, so its bits must be tp = 1's; downstream of a
    merge whose rank 1 holds keys, a p rounded one bf16 ulp apart can move
    a state)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import cache_shard_dim
    from repro_torch.models import layer_pattern

    pat = layer_pattern(get_config(arch))
    first_attn = next((i for i, k in enumerate(pat) if k not in ("mamba", "rec")), len(pat))
    out = {}
    for k, v in one["states"].items():
        names = k.split("/")
        stacked = names[0] == "layers"
        d = cache_shard_dim(names, v, 1 if stacked else 0)
        got = torch.cat([r["states"][k] for r in rs], dim=d)
        up = stacked and int(names[1][3:]) < first_attn
        out[k] = dict(bit_equal=_bits_equal(torch, got, v), upstream=up,
                      upstream_bit_equal=_bits_equal(torch, got[0], v[0]) if up else None,
                      rel_err=float((got.float() - v.float()).abs().max()
                                    / v.float().abs().max().clamp_min(1e-30)))
    return out


# the cuBLAS products of the tp paths (FP16's projections, every path's
# bf16 head): (name, K, N), whole and as a rank's N / 2 columns
CUBLAS_TP2_SHAPES = [("wq/wo", 3584, 3584), ("wk/wv", 3584, 512), ("w_gate/w_up", 3584, 18944),
                     ("w_down", 18944, 3584), ("lm_head", 3584, 152064)]


def _cublas_shard_columns(torch, dev, full: bool):
    """Whether a rank's N-shard of a bf16 weight gives the whole product's
    columns bit for bit through torch.matmul (cuBLAS on the card) at a
    decode tick's 8 rows and a prefill chunk's 128: printed, not held (the
    kernels of the port are held; cuBLAS picks its own algorithm per
    shape)."""
    gen = torch.Generator(device=dev).manual_seed(31)
    shapes = CUBLAS_TP2_SHAPES if full else [(n, K, N) for n, K, N, _ in TINY_SHAPES]
    out = []
    for name, K, N in shapes:
        w = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
        n = N // TP
        for rows in (8, 128):
            x = torch.randn((rows, K), generator=gen, device=dev).to(torch.bfloat16)
            whole = x @ w
            equal = [_bits_equal(torch, x @ w[:, r * n:(r + 1) * n].contiguous(),
                                 whole[:, r * n:(r + 1) * n]) for r in range(TP)]
            out.append(dict(name=name, K=K, N=N, shard_N=n, rows=rows, bit_equal=all(equal)))
    log("tp cublas-columns " + json.dumps(out))
    return out


def _tp_fatal(name, spec, one, rs, line, cuda: bool):
    kernels = _tp_kernels(spec)
    exact = not (spec.get("ep") or spec.get("lean") or spec.get("merged"))
    if not line["ranks_agree"]:
        fail(f"tp[{name}]: the ranks' streams differ")
    if exact and not line["streams_equal_tp1"]:
        fail(f"tp[{name}]: streams differ from tp = 1's at tokens "
             f"{line['first_diverging_token']}")
    st = line["states"]
    if spec.get("states") and not (st and all(
            (x["bit_equal"] if not spec.get("merged") else
             (x["upstream_bit_equal"] is not False and x["rel_err"] <= LOGIT_TOL))
            for x in st.values())):
        fail(f"tp[{name}]: recurrent states gathered from the ranks differ from tp = 1's: "
             f"{st}")
    if spec.get("long"):
        n = max(line["armed_lengths"]["tp2"][0] or [0])
        if not line["written_rows_per_rank"][1] or n < (spec["long"] if cuda else TINY_LONG):
            fail(f"tp[{name}]: the long request did not reach rank 1's half at the first "
                 f"all-decode tick (lengths {line['armed_lengths']}, written rows per rank "
                 f"{line['written_rows_per_rank']})")
        for r, res in enumerate(rs):
            m = res["checks"].get("contiguous_attention") or {}
            if not m.get("recorded_rank1_keys"):
                fail(f"tp[{name}] rank {r}: the merged attention's recorded lengths leave rank "
                     f"1's half empty: {m}")
    for r, res in enumerate(rs):
        c = res["checks"]
        if (spec.get("lean") or spec.get("merged")) and c["first_logits"]["rel_err"] > LOGIT_TOL:
            fail(f"tp[{name}] rank {r}: first-tick logits {c['first_logits']} beyond "
                 f"{LOGIT_TOL} of tp = 1's")
        if exact and not c["first_logits"]["bit_equal"]:
            fail(f"tp[{name}] rank {r}: first-tick logits {c['first_logits']} not bit-equal "
                 "to tp = 1's")
        if spec.get("ep"):
            nd = line["no_drop"][r]
            if not (nd["streams_equal_tp1"] and nd["first_logits_bit_equal"]) or \
                    nd["moe_pairs_dropped"]:
                fail(f"tp[{name}] rank {r}: at the capacity that drops nothing, streams and "
                     f"first-tick logits not bit-equal to tp = 1's: {nd}")
        if res["pool_bytes"] * TP != one["pool_bytes"]:
            fail(f"tp[{name}] rank {r}: cache {res['pool_bytes']} bytes, not half of tp = 1's "
                 f"{one['pool_bytes']}")
        if not spec.get("lean"):
            bad = [k["name"] for k in c["k1"] if not k["tp1_inputs_bit_equal"]]
            if bad or len(c["k1"]) != len(_tp_proj(spec)):
                fail(f"tp[{name}] rank {r}: K1 shards of {bad} differ from tp = 1's columns "
                     f"({len(c['k1'])} of {len(_tp_proj(spec))} projections held)")
            if c.get("attention") and not c["attention"]["tp1_inputs_bit_equal"]:
                fail(f"tp[{name}] rank {r}: paged attention on the rank's heads differs from "
                     "tp = 1's")
        if spec.get("merged"):
            m = c.get("contiguous_attention")
            if m is None or not m["rel_err_f32"] <= MERGE_TOL:
                fail(f"tp[{name}] rank {r}: the merged attention on tp = 1's inputs {m} beyond "
                     f"{MERGE_TOL} of one rank's walk")
        moe = c.get("moe_ep_vs_dense")
        if moe is not None and moe["rel_err"] > LOGIT_TOL:
            fail(f"tp[{name}] rank {r}: moe_ep without drops {moe} beyond {LOGIT_TOL} of "
                 "moe_dense")
        if cuda:
            launched = {k for k, n in res["launches"].items() if n}
            if launched != set(kernels) or res["plain_calls_on_cuda"]:
                fail(f"tp[{name}] rank {r}: launched {res['launches']} (plain versions on CUDA "
                     f"{res['plain_calls_on_cuda']}); the path's kernels are {kernels}")
    if rs[0]["launches"] != rs[1]["launches"]:
        fail(f"tp[{name}]: the ranks launched {rs[0]['launches']} and {rs[1]['launches']}")


# the sharded shapes a rank's kernels run at tp = 2 (K, N, launches a
# layer): Qwen2-7B's N-shards (K1), Llama-4-Scout's attention and shared-
# expert N-shards and its 8 local experts, whole (K1b, timed at 8 rows)
QWEN_TP2_SHAPES = [("wq/wo shard", 3584, 1792, 2), ("wk/wv shard", 3584, 256, 2),
                   ("w_gate/w_up shard", 3584, 9472, 2), ("w_down shard", 18944, 1792, 1)]
SCOUT_TP2_SHAPES = [("wq/wo shard", 5120, 2560, 2), ("wk/wv shard", 5120, 512, 2),
                    ("shared w_gate/w_up shard", 5120, 4096, 2),
                    ("shared w_down shard", 8192, 2560, 1),
                    ("w_gate/w_up x 8 local experts", 5120, 8192, 16),
                    ("w_down x 8 local experts", 8192, 5120, 8)]
# K1 at a rank's shapes on the paths over contiguous caches: (name, K, the
# rank's N, launches a layer, the whole linear's N or None where the rank
# holds the linear whole): Falcon-Mamba-7B's layer (in_proj's N-shard is
# its slices of both halves; x_proj's 288 columns are 144 a rank),
# RecurrentGemma-9B's rec layer, MiniCPM3-4B's (wq_a / wkv_a whole)
K1_TP2_SHAPES = {
    "falcon-mamba-7b": [("in_proj shard", 4096, 8192, 1, 16384),
                        ("x_proj shard", 8192, 144, 1, 288),
                        ("dt_proj shard", 256, 4096, 1, 8192),
                        ("out_proj shard", 8192, 2048, 1, 4096)],
    "recurrentgemma-9b": [("in_x/in_gate/w_rec_gate/w_in_gate/out_proj shard", 4096, 2048, 5,
                           4096),
                          ("w_gate/w_up shard", 4096, 6144, 2, 12288),
                          ("w_down shard", 12288, 2048, 1, 4096)],
    "minicpm3-4b": [("wq_a whole", 2560, 768, 1, None), ("wq_b shard", 768, 1920, 1, 3840),
                    ("wkv_a whole", 2560, 288, 1, None), ("wo shard", 2560, 1280, 1, 2560),
                    ("w_gate/w_up shard", 2560, 3200, 2, 6400),
                    ("w_down shard", 6400, 1280, 1, 2560)],
}


def _tp_kernel_times(torch, dev, timed: bool, full: bool):
    """K1, K1b, K2 and K3 at a rank's shapes, against their plain versions
    (a sharded projection planned with the whole linear's K split): each
    kernel's decode row and error, as the kernel phases report them; K1
    also at the contiguous paths' shapes (`K1_TP2_SHAPES`)."""
    import numpy as np

    from repro_torch.kernels.ams_matmul import (
        ams_matmul_fp533,
        ams_matmul_fp533_plain,
        ams_matmul_planes,
        ams_matmul_planes_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(29)
    rng = np.random.default_rng(29)
    qwen = QWEN_TP2_SHAPES if full else [(n, K, N // TP, m) for n, K, N, m in TINY_SHAPES]
    scout = SCOUT_TP2_SHAPES if full else qwen
    shard_n = {N for _, _, N, _ in qwen} | {N for n, _, N, _ in scout if "shard" in n}

    def split(pw):
        return TP * pw.N if pw.N in shard_n else None

    out = {}
    out["ams_matmul_fp533"] = _matmul_phase(
        torch, dev, "K1[qwen2-7b tp2]", "fp5.33-e2m3", gen,
        lambda x, pw: ams_matmul_fp533(x, pw.hi, pw.scale, n_split=split(pw)),
        lambda x, pw: ams_matmul_fp533_plain(x, pw.hi, pw.scale), timed, full,
        decode_only=True, shapes=qwen)
    out["ams_matmul_planes"] = _matmul_phase(
        torch, dev, "K1b[llama4-scout-17b-16e tp2]", "fp4.25-e2m2", gen,
        lambda x, pw: ams_matmul_planes(x, pw.hi, pw.lsb, pw.scale, pw.layout,
                                        n_split=split(pw)),
        lambda x, pw: ams_matmul_planes_plain(x, pw.hi, pw.lsb, pw.scale, pw.layout), timed,
        full, decode_only=True, shapes=scout)
    kv_hd = dict(qwen=(4 // TP, 7, 128), scout=(8 // TP, 5, 128)) if full else \
        dict(qwen=(1, 2, 32), scout=(1, 2, 32))
    paged = ((16,), 8, 1024) if full else (TINY_PAGES[:1], 4, 64)
    out["paged_attention_ams"] = _k2_cases(torch, np, dev, rng, gen, *kv_hd["qwen"], *paged,
                                           (1,), timed, "K2[qwen2-7b tp2]")
    out["paged_attention_ams[scout]"] = _k2_cases(torch, np, dev, rng, gen, *kv_hd["scout"],
                                                  *paged, (1,), timed,
                                                  "K2[llama4-scout-17b-16e tp2]")
    out["paged_attention_bf16"] = _k3_cases(torch, np, dev, rng, gen, *kv_hd["qwen"], *paged,
                                            (1,), timed, "K3[qwen2-7b tp2]")
    for arch, rows in K1_TP2_SHAPES.items():
        if not full:
            rows = [(n, K, N // TP, m, N) for n, K, N, m in TINY_SHAPES]
        n_split = {N: whole for _, _, N, _, whole in rows}
        out[f"ams_matmul_fp533[{arch}]"] = _matmul_phase(
            torch, dev, f"K1[{arch} tp2]", "fp5.33-e2m3", gen,
            lambda x, pw, n_split=n_split: ams_matmul_fp533(x, pw.hi, pw.scale,
                                                            n_split=n_split.get(pw.N)),
            lambda x, pw: ams_matmul_fp533_plain(x, pw.hi, pw.scale), timed, full,
            decode_only=True, shapes=[r[:4] for r in rows])
    return out


# --------------------------------------------------------------------- dp
# data- and tensor-parallel training: two ranks share the one card over
# gloo, as in the tp phase; ``single`` (data 2) at the train phase's config,
# FSDP over data, against dp = 1 from the same params; ``multi`` (pod 2,
# data 1) at depth 1 with the int8 all-gather over pod, against the
# uncompressed dp = 1 run; ``tp`` (data 1, model 2) at single's config, the
# training layout's column / row shards, against the same dp = 1 run
DP_STEPS = 4
DP_MULTI_STEPS = 3
# single's depth: at the train phase's 4 layers (33.9 GB a rank) the two
# ranks and this process left the card under 2 GB, and a rank ran out
DP_SINGLE_LAYERS = 3
# the runs, each in a world of its own (one after the other in one world,
# the second run's peak rose by 3.3 GB a rank), whose ranks' CUDA allocator
# grows expandable segments: with 4 GB a rank reserved and unused the two
# ranks and this process filled the card. kind -> (its mesh, the dp = 1
# baseline it is held to, whose config and steps it takes (`_dp_configs`),
# its gradient compression)
DP_MESHES = {"single": ({"data": 2, "model": 1}, "single", "none"),
             "multi": ({"pod": 2, "data": 1, "model": 1}, "multi", "int8_ag"),
             "tp": ({"data": 1, "model": 2}, "single", "none")}
DP_ALLOC_CONF = "expandable_segments:True"
DP_MULTI_LOSS_TOL = 2e-2        # tests/test_distributed.py's sharded-train bound (rtol = atol)
# the int8 error's norm over step 0's grad norm must stay under this, so the
# grad-norm gate it widens still catches a sum off by a factor (1 / npod)
DP_INT8_ERR_MAX = 0.25
DP_NOTE = ("two ranks time-slice one card: step and gloo ms say nothing of the speed of two "
           "cards; gloo's collectives of CUDA tensors are staged through the mesh's one "
           "pinned host buffer")


@contextlib.contextmanager
def _env(**values):
    """While open, these environment variables are set (for the processes
    spawned meanwhile), then put back as they were."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _dp_configs(full: bool):
    """({baseline: (its config, its steps)} for the baselines DP_MESHES
    names, their RunConfig fields, the cuts): the train phase's (B 8 x 512,
    microbatch 4, remat, TRAIN_LR)."""
    import dataclasses as dc

    from repro_torch.configs import get_config

    base = get_config("qwen2-7b")
    if full:
        return ({"single": (dc.replace(base, num_layers=DP_SINGLE_LAYERS), DP_STEPS),
                 "multi": (dc.replace(base, num_layers=1), DP_MULTI_STEPS)},
                dict(seq_len=512, global_batch=8, microbatch=4),
                [f"single: num_layers 28 -> {DP_SINGLE_LAYERS} (4 did not fit two ranks "
                 "beside this process)", "multi: num_layers 28 -> 1"])
    return ({"single": (base.reduced(), DP_STEPS), "multi": (base.reduced(), DP_MULTI_STEPS)},
            dict(seq_len=32, global_batch=4, microbatch=2), ["reduced() config"])


def _fingerprint(torch, t) -> list:
    """Two int64 sums of a (4-byte) tensor's 32-bit words (plain and position-
    weighted, wrapping), in chunks on its device: equal bits give equal
    fingerprints, and a flipped bit changes them."""
    w = t.detach().contiguous().reshape(-1).view(torch.int32)
    a = b = 0
    for lo in range(0, w.numel(), 1 << 26):
        part = w[lo:lo + (1 << 26)].to(torch.int64)
        pos = torch.arange(lo, lo + part.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
        a += int(part.sum())
        b += int((part * pos).sum())
    return [a, b]


def _dp_run(torch, cfg, rcfg, dev, steps, ctx=None, compress_stats=None):
    """Train ``steps`` steps from ``init_params(0, cfg, tp=model axis)`` on
    ``dev`` (the whole masters drawn, then this rank's model shards and
    FSDP slices kept): per step the metrics, step ms and (on a mesh) gloo
    ms, calls and bytes by collective; the fingerprint of the leaves whole
    on the rank (the masters, and with a model axis m and v too); the
    sliced leaves' shapes against their whole shapes (masters, m and v);
    peak memory, and the memory allocated when the run began."""
    from repro_torch.core.tree import tree_items
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import init_params
    from repro_torch.models.parallel import NO_CTX
    from repro_torch.optim import compressed_psum, init_state

    cuda = dev.type == "cuda"
    mesh = ctx.mesh if ctx is not None else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev) if cuda else 0
    ctx = ctx or NO_CTX
    step_fn = steps_mod.build_train_step(cfg, rcfg, dev, ctx)
    whole = init_params(0, cfg, tp=ctx.tp, device=dev)
    shapes = {"/".join(p): tuple(t.shape) for p, t in tree_items(whole)}
    params = step_fn.shard(whole)
    del whole
    dims = {"/".join(p): d for p, d in tree_items(step_fn.layout())}
    mdims = ({"/".join(p): d for p, d in tree_items(step_fn.layout("model"))} if ctx.tp > 1
             else dict.fromkeys(dims))
    opt = init_state(params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, rcfg.seq_len, rcfg.global_batch))
    real = steps_mod.compressed_psum
    out = dict(steps=[], fingerprints=[])
    for s in range(steps):
        if compress_stats is not None and s == 0:       # step 0's per-leaf int8 errors
            steps_mod.compressed_psum = lambda g, c, a: real(g, c, a, compress_stats)
        toks, tgts = data.batch(s, shard=0, num_shards=1)
        tok, tgt = torch.from_numpy(toks).to(dev), torch.from_numpy(tgts).to(dev)
        if mesh is not None:
            mesh.reset_counts()
        _sync(torch, dev)
        t0 = time.perf_counter()
        try:
            params, opt, met = step_fn(params, opt, tok, tgt, None, s)
            met = {k: float(v) for k, v in met.items()}
        finally:
            steps_mod.compressed_psum = real
        dt = time.perf_counter() - t0
        row = dict(step=s, **met, step_ms=1e3 * dt)
        if cuda:
            row["card_free_gb"] = torch.cuda.mem_get_info(dev)[0] / 1e9
        if mesh is not None:
            row.update(gloo_ms=1e3 * mesh.collective_seconds, gloo_calls=mesh.collective_calls,
                       bytes_by_collective=dict(mesh.collective_bytes))
        out["steps"].append(row)
        out["fingerprints"].append({   # no name keeps the trees: `del params` frees them
            n + k: _fingerprint(torch, t)
            for n, tree in [("", params)] + ([("m/", opt["m"]), ("v/", opt["v"])]
                                             if ctx.tp > 1 else [])
            for k, t in (("/".join(p), t) for p, t in tree_items(tree))
            if dims[k] is None and mdims[k] is None})
    own = {name: {"/".join(p): tuple(t.shape) for p, t in tree_items(tree)}
           for name, tree in (("master", params), ("m", opt["m"]), ("v", opt["v"]))}
    out["halves"] = {k: dict(whole=shapes[k], dims=[x for x in (d, mdims[k]) if x is not None],
                             **{n: own[n][k] for n in own})
                     for k, d in dims.items() if d is not None or mdims[k] is not None}
    out["master_bytes"] = sum(t.numel() * t.element_size() for _, t in tree_items(params))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    out["allocated_at_start_gb"] = at_start / 1e9 if cuda else None
    out["card_free_gb"] = min((r["card_free_gb"] for r in out["steps"]), default=None) \
        if cuda else None
    if mesh is not None:
        out["pinned_bytes"] = mesh.pinned_bytes
    del params, opt, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _dp_rank(mesh, kind: str, full: bool):
    """One rank of a dp world: the ``kind`` run on this rank's mesh, the
    port's kernel counts zeroed before and read after."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.models.parallel import ParallelCtx

    dev = mesh.device
    if dev.type == "cpu":                     # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // mesh.world))
    _, baseline, compression = DP_MESHES[kind]
    runs, kw, _ = _dp_configs(full)
    cfg, steps = runs[baseline]
    rcfg = RunConfig(model=cfg, learning_rate=TRAIN_LR, warmup_steps=2,
                     grad_compression=compression, **kw)
    for cnt in all_counts():
        cnt.reset()
    stats = [] if compression == "int8_ag" else None
    t0 = time.perf_counter()
    res = _dp_run(torch, cfg, rcfg, dev, steps, ParallelCtx(mesh=mesh, tp_axis="model"), stats)
    res.update(rank=mesh.rank, coords=mesh.coords, compress_stats=stats,
               launches={c.name: c.launches for c in all_counts() if c.launches},
               run_seconds=time.perf_counter() - t0)
    return res


def phase_dp(torch, dev, timed: bool = True, full: bool = True,
             kinds=tuple(DP_MESHES)):
    """Data- and tensor-parallel training on two ranks of the one card (see
    DP_NOTE): dp = 1 baselines here first (the single run's config for
    DP_STEPS steps, the multi run's uncompressed for DP_MULTI_STEPS; only
    those ``kinds`` need), their memory freed, then a world of two ranks
    for each of ``kinds`` (`launch.mesh.spawn`, gloo): ``single`` at (data
    2), ``multi`` at (pod 2, data 1) with ``int8_ag``, ``tp`` at (data 1,
    model 2) at single's config (`_dp_rank`). Fatal: each single and tp
    step's loss within TRAIN_LOSS_REL and grad norm within TRAIN_GNORM_REL
    of dp = 1's, the ranks' metrics and whole leaves bit-equal at every
    step (on tp the master, m and v of every leaf whole over ``model``),
    each sliced leaf's master, m and v half a leaf on each rank (single:
    the FSDP leaves, tp: the model shards); on the multi run every
    compressed leaf of step 0 within amax / 127 of the rank-order f32 sum
    (the rank's shard), step 0's grad norm within TRAIN_GNORM_REL of the
    uncompressed dp = 1 run's plus the norm of the int8 error (|a| - |b| <=
    |a - b|; that error under DP_INT8_ERR_MAX of the norm, so a wrong
    scale of the sum cannot hide in it), the losses within
    DP_MULTI_LOSS_TOL of the uncompressed run's, the ranks' params
    bit-equal; no port kernel launched. Printed: step and gloo ms, gloo
    calls and bytes by collective per step, pinned and peak bytes per
    rank, the card's free bytes after each step, this process's bytes,
    the int8 all-gather's bytes against f32's."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import spawn

    cuda = dev.type == "cuda"
    dev_str = "cuda" if cuda else "cpu"
    gc.collect()
    if cuda:
        torch.cuda.init()                      # run alone, no phase has touched the card yet
        torch.cuda.empty_cache()
    runs, kw, reduced = _dp_configs(full)
    base = {}
    need = {DP_MESHES[k][1] for k in kinds}
    for kind, (cfg, n) in runs.items():
        if kind not in need:
            continue
        for cnt in all_counts():
            cnt.reset()
        rcfg = RunConfig(model=cfg, learning_rate=TRAIN_LR, warmup_steps=2, **kw)
        base[kind] = _dp_run(torch, cfg, rcfg, dev, n)
        base[kind]["launches"] = {c.name: c.launches for c in all_counts() if c.launches}
    main_gb = dict(allocated=torch.cuda.memory_allocated(dev) / 1e9,
                   reserved=torch.cuda.memory_reserved(dev) / 1e9,
                   card_free=torch.cuda.mem_get_info(dev)[0] / 1e9) if cuda else None
    log("dp main-process " + json.dumps(main_gb))
    out = {}
    for kind in kinds:
        shape, baseline, compression = DP_MESHES[kind]
        t0 = time.perf_counter()
        with _env(PYTORCH_CUDA_ALLOC_CONF=DP_ALLOC_CONF):
            rs = spawn(_dp_rank, shape, dev_str, kind, full, backend="gloo")
        wall = time.perf_counter() - t0
        one = base[baseline]
        first = rs[0]["steps"]
        line = dict(
            kind=kind, mesh=shape, arch="qwen2-7b", layers=runs[baseline][0].num_layers,
            reduced=reduced, **kw, grad_compression=compression,
            loss=dict(dp1=[r["loss"] for r in one["steps"]], dp2=[r["loss"] for r in first]),
            grad_norm=dict(dp1=[r["grad_norm"] for r in one["steps"]],
                           dp2=[r["grad_norm"] for r in first]),
            loss_rel=[abs(a["loss"] - b["loss"]) / abs(b["loss"])
                      for a, b in zip(first, one["steps"])],
            grad_norm_rel=[abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                           for a, b in zip(first, one["steps"])],
            ranks_metrics_equal=all(
                [{k: v for k, v in a.items() if k in ("loss", "grad_norm", "lr")}
                 for a in r["steps"]]
                == [{k: v for k, v in a.items() if k in ("loss", "grad_norm", "lr")}
                    for a in first]
                for r in rs),
            ranks_whole_leaves_equal=all(r["fingerprints"] == rs[0]["fingerprints"] for r in rs),
            whole_leaves=len(rs[0]["fingerprints"][0]),
            step_ms=dict(dp1=[r["step_ms"] for r in one["steps"]],
                         dp2=[[x["step_ms"] for x in r["steps"]] for r in rs]),
            gloo_ms=[[x["gloo_ms"] for x in r["steps"]] for r in rs],
            gloo_calls=[[x["gloo_calls"] for x in r["steps"]] for r in rs],
            bytes_by_collective=[r["steps"][-1]["bytes_by_collective"] for r in rs],
            pinned_bytes=[r["pinned_bytes"] for r in rs],
            peak_memory_gb=dict(dp1=one["peak_memory_gb"], dp2=[r["peak_memory_gb"] for r in rs]),
            allocated_at_start_gb=dict(dp1=one["allocated_at_start_gb"],
                                       dp2=[r["allocated_at_start_gb"] for r in rs]),
            master_bytes=dict(dp1=one["master_bytes"], dp2=[r["master_bytes"] for r in rs]),
            sliced_leaves=len(rs[0]["halves"]),
            halves=all(h["master"] == h["m"] == h["v"]
                       and all(h["master"][i] * (2 if i in h["dims"] else 1) == w
                               for i, w in enumerate(h["whole"]))
                       for r in rs for h in r["halves"].values()),
            launches=[r["launches"] for r in rs] + [one["launches"]],
            card_free_gb=[r["card_free_gb"] for r in rs], main_process_gb=main_gb,
            run_seconds=[r["run_seconds"] for r in rs], world_seconds=wall, note=DP_NOTE)
        if compression == "int8_ag":
            st = [x for r in rs for x in r["compress_stats"] if not x["fallback"]]
            int8 = rs[0]["steps"][-1]["bytes_by_collective"].get("all_gather_int8", 0)
            sc = rs[0]["steps"][-1]["bytes_by_collective"].get("all_gather_scale", 0)
            gn0, gn1 = line["grad_norm"]["dp2"][0], line["grad_norm"]["dp1"][0]
            err = math.sqrt(sum(x["err_sq"] for x in st))
            line.update(
                compressed_leaves=len(st), fallback_leaves=sum(x["fallback"] for r in rs
                                                               for x in r["compress_stats"]) // 2,
                worst_int8_err_over_amax=max(x["max_err"] / max(x["amax"], 1e-30) for x in st),
                int8_bound_over_amax=1 / 127,
                int8_err_norm_over_grad_norm=err / gn1,
                grad_norm0_allow=TRAIN_GNORM_REL * gn1 + err,
                grad_norm0_diff=abs(gn0 - gn1),
                all_gather_bytes=dict(int8_codes=int8, scales=sc, f32_equivalent=4 * int8,
                                      ratio=4 * int8 / max(1, int8 + sc)),
                loss_abs_diff=[abs(a["loss"] - b["loss"]) for a, b in zip(first, one["steps"])],
                loss_tol=DP_MULTI_LOSS_TOL)
        out[kind] = line
        log(f"dp {kind} " + json.dumps(line))
    for kind, line in out.items():             # every line printed before any fails
        if not line["ranks_metrics_equal"] or not line["ranks_whole_leaves_equal"]:
            fail(f"dp[{kind}]: the ranks' metrics or whole leaves differ")
        if any(line["launches"]):
            fail(f"dp[{kind}]: the training path launched port kernels {line['launches']}")
        fin = line["loss"]["dp2"] + line["grad_norm"]["dp2"]
        if not all(math.isfinite(x) for x in fin):
            fail(f"dp[{kind}]: a loss or grad norm is not finite: {fin}")
        if line["grad_compression"] == "none":
            if max(line["loss_rel"]) > TRAIN_LOSS_REL or \
                    max(line["grad_norm_rel"]) > TRAIN_GNORM_REL:
                fail(f"dp[{kind}]: losses {line['loss']} / grad norms {line['grad_norm']} beyond "
                     f"{TRAIN_LOSS_REL} / {TRAIN_GNORM_REL} of dp = 1's")
            if not line["halves"] or ((full or line["mesh"]["model"] > 1)
                                      and not line["sliced_leaves"]):
                fail(f"dp[{kind}]: a sliced leaf's master, m or v is not half a leaf on a rank")
        else:
            if not line["worst_int8_err_over_amax"] <= 1 / 127:
                fail(f"dp[multi]: a compressed leaf beyond amax / 127 of the f32 sum: "
                     f"{line['worst_int8_err_over_amax']}")
            if not line["int8_err_norm_over_grad_norm"] < DP_INT8_ERR_MAX:
                fail(f"dp[multi]: the int8 error's norm is {line['int8_err_norm_over_grad_norm']}"
                     f" of the grad norm, not under {DP_INT8_ERR_MAX}")
            if not line["grad_norm0_diff"] <= line["grad_norm0_allow"]:
                fail(f"dp[multi]: step 0's grad norm {line['grad_norm']['dp2'][0]} beyond "
                     f"{line['grad_norm0_allow']} of the uncompressed run's "
                     f"{line['grad_norm']['dp1'][0]}")
            if any(d > DP_MULTI_LOSS_TOL * (1 + abs(b)) for d, b in
                   zip(line["loss_abs_diff"], line["loss"]["dp1"])):
                fail(f"dp[multi]: losses {line['loss']} beyond {DP_MULTI_LOSS_TOL} of the "
                     "uncompressed run's")
    return (out,)


def phase_tptrain(torch, dev, timed: bool = True, full: bool = True):
    """The dp phase's tensor-parallel run alone (`phase_dp` with kinds
    ("tp",)): its dp = 1 baseline, then the (data 1, model 2) world."""
    return phase_dp(torch, dev, timed, full, kinds=("tp",))


PHASES = ("k1", "k1b", "k2", "k3", "k4", "k5", "k5p", "tick", "rows", "train", "tp", "dp",
          "tptrain")


def run_phases(torch, names, other):
    """Time some kernel phases alone on the card (one process per checkout,
    so two versions compare in one call: parent, change, change, parent);
    ``other`` is the root of another checkout whose chip_smoke.py phases
    (and kernels) run instead of this one's."""
    import importlib.util

    mod = sys.modules[__name__]
    if other:
        root = Path(other).resolve()
        sys.path.insert(0, str(root / "src"))
        spec = importlib.util.spec_from_file_location("chip_smoke_other", root / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    from repro_torch.kernels import build

    log(f"phases of {Path(mod.__file__).resolve().parent}, kernels from "
        f"{Path(build.__file__).resolve().parent}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build {time.perf_counter() - t0:.1f}s")
    if not other:
        ptxas_report(build)
    dev = torch.device("cuda", 0)
    for n in names:
        phase = getattr(mod, f"phase_{n}", None) or globals()[f"phase_{n}"]
        t0 = time.perf_counter()
        res = phase(torch, dev, timed=True, full=True)
        log(f"phase {n} seconds {time.perf_counter() - t0:.1f}")
        log(f"phase {n} " + json.dumps(res[0], default=str))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at tiny sizes (plain versions, no "
                         "timing) and exit non-zero")
    ap.add_argument("--phases", help="time only these kernel phases on the card, comma-"
                    f"separated from {','.join(PHASES)}, and print no result")
    ap.add_argument("--from", dest="other", help="with --phases: run the phases and kernels "
                    "of the checkout at this root instead (a parent commit, unpacked)")
    args = ap.parse_args()

    import torch

    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        phase_k1(torch, dev, timed=False, full=False)
        phase_k1b(torch, dev, timed=False, full=False)
        phase_k2(torch, dev, timed=False, full=False)
        phase_k3(torch, dev, timed=False, full=False)
        phase_k4(torch, dev, timed=False, full=False)
        phase_k5(torch, dev, timed=False, full=False)
        phase_k5p(torch, dev, timed=False, full=False)
        for path in PATHS:
            phase_serve(torch, dev, full=False, path=path)
            if not PATHS[path].get("lean"):
                phase_graph(torch, dev, full=False, path=path)
                phase_consistency(torch, dev, full=False, path=path)
        phase_consistency(torch, dev, full=False, path="fp4.25", page=16)
        phase_consistency(torch, dev, full=False, path="fp4.25", scheme="fp6-e2m3")
        phase_ring(torch, dev, full=False)
        phase_engine_features(torch, dev, full=False)
        phase_seq(torch, dev, full=False)
        phase_frontend(torch, dev, full=False)
        phase_tp(torch, dev, timed=False, full=False)
        phase_train(torch, dev, timed=False, full=False)
        phase_dp(torch, dev, timed=False, full=False)
        log("rehearsal finished on the CPU: no result")
        sys.exit(2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    if args.phases:
        names = args.phases.split(",")
        if not set(names) <= set(PHASES):
            fail(f"unknown phases {names}; choose from {PHASES}")
        run_phases(torch, names, args.other)
        return
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    report = build.build_all()
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
        log(f"build {name}: {r['seconds']:.1f}s; {' | '.join(regs)}")
    log(f"build total {time.perf_counter() - t0:.1f}s")
    ptxas_report(build)
    seconds, clock = {"build": round(time.perf_counter() - t0, 1)}, [time.perf_counter()]

    def mark(name):             # the seconds since the last mark, for the phase-seconds line
        seconds[name] = round(time.perf_counter() - clock[0], 1)
        clock[0] = time.perf_counter()

    (k1, k1_err, (k1_zoo, k1_zoo_err), (k1_ssm, k1_ssm_err),
     (k1_rg, k1_rg_err)) = phase_k1(torch, dev, timed=True, full=True)
    (k1b, k1b_err, k1b_wide, (k1b_zoo, k1b_zoo_err),
     (k1b_scout, k1b_scout_err)) = phase_k1b(torch, dev, timed=True, full=True)
    k2, k2_err, k2_zoo = phase_k2(torch, dev, timed=True, full=True)
    k3, k3_err = phase_k3(torch, dev, timed=True, full=True)
    k4, k4_err = phase_k4(torch, dev, timed=True, full=True)
    k5, k5_err = phase_k5(torch, dev, timed=True, full=True)
    k5p, k5p_err, k5p_launches = phase_k5p(torch, dev, timed=True, full=True)
    mark("kernels")
    served = {}
    for path in PATHS:
        served[path] = phase_serve(torch, dev, full=True, path=path)
        mark(f"serve {path}")
        if not PATHS[path].get("lean"):
            phase_graph(torch, dev, full=True, path=path)
            phase_consistency(torch, dev, full=True, path=path)
            mark(f"graph, consistency {path}")
    phase_consistency(torch, dev, full=True, path="fp4.25", page=64)
    phase_consistency(torch, dev, full=True, path="fp4.25", scheme="fp6-e2m3")
    phase_ring(torch, dev, full=True)
    mark("consistency fp4.25 page 64 / fp6-e2m3, ring")
    # one set of FP5.33 weights for the engine-features and frontend phases
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch.config import EngineConfig
    from repro_torch.launch.engine import init_serving_params
    fp533 = init_serving_params(
        EngineConfig(arch=PATHS["fp5.33"]["arch"], reduced=False, device="cuda").model_config(),
        QuantPolicy(scheme=PATHS["fp5.33"]["scheme"], impl="kernel", min_elements=1 << 10), 0,
        dev)
    features, feature_launches = phase_engine_features(torch, dev, full=True, params=fp533)
    phase_seq(torch, dev, full=True, params=fp533)
    phase_frontend(torch, dev, full=True, params=fp533)
    del fp533
    gc.collect()
    torch.cuda.empty_cache()
    mark("engine-features, seq, frontend")
    tp_lines, tp_times = phase_tp(torch, dev, timed=True, full=True)
    mark("tp")
    phase_train(torch, dev, timed=True, full=True)
    mark("train")
    phase_dp(torch, dev, timed=True, full=True)
    mark("dp")
    log("phase-seconds " + json.dumps(seconds))
    log("compare " + json.dumps({
        path: dict(arch=r["arch"], scheme=r["scheme"], cache=r["cache"],
                   decode_tick_ms=r["profile"]["decode_tick_ms"],
                   eager_tick_ms=r["profile"]["eager_tick_ms"],
                   replay_ms=r["profile"]["replay_ms"],
                   outside_replay_share=r["profile"]["outside_replay_share"],
                   **{f"{k}_{m}": r["profile"][k][m] for k in ("graph", "eager")
                      for m in ("device_busy_ms_per_tick", "device_idle_share",
                                "gaps_inside_ticks_ms_per_tick", "kernels_per_tick")},
                   card=card)
        for path, r in served.items()}))

    # library_ms: K4 / K5 against one torch SDPA call with the equivalent
    # boolean mask; null for K1-K3 and K5p, because no single PyTorch call
    # computes a dequant-matmul from packed AMS planes, or paged attention
    # through a block table. launches: the count on the path's served run;
    # K5p and K1b's per_word 4 / 5 / 6 hooks, which no served path reaches,
    # their phases' runs of the entry (path null)
    # launches_engine_features: the engine-features phase's run (K1, K2).
    # A name "kernel[arch]" is the kernel at that model's shapes, its
    # launches the count on that model's path
    def row(name, src, replaces, path, res, err, launches=None):
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
                    replaces=replaces, path=path,
                    paths=[p for p, sp in PATHS.items() if name.split("[")[0] in sp["kernels"]]
                    + [p for p, sp in TP_PATHS.items() if name.split("[")[0] in _tp_kernels(sp)],
                    launches=served[path]["launches"][name.split("[")[0]] if path else launches,
                    launches_engine_features=feature_launches[name]
                    if name in feature_launches else None,
                    max_abs_err=err, ms=res["ms"], plain_ms=res["plain_ms"],
                    bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                    library_ms=res.get("library_ms"))

    kernels = [
        row("ams_matmul_fp533", "ams_matmul.cu", "src/repro/kernels/ams_matmul.py:138",
            "fp5.33", k1, k1_err),
        row("ams_matmul_planes", "ams_matmul.cu", "src/repro/kernels/ams_matmul.py:95",
            "fp4.25", k1b, k1b_err),
        *[row(f"ams_matmul_planes_pw{r['per_word']}_{sc}", "ams_matmul.cu",
              "src/repro/kernels/ams_matmul.py:95", None, r["layer"], r["err"], r["launches"])
          for sc, r in k1b_wide.items()],
        row("paged_attention_ams", "paged_attention.cu",
            "src/repro/kernels/attention_template.py:399", "fp5.33", k2, k2_err),
        row("ams_matmul_fp533[internvl2-1b]", "ams_matmul.cu",
            "src/repro/kernels/ams_matmul.py:138", "vlm-fp5.33", k1_zoo, k1_zoo_err),
        row("ams_matmul_fp533[falcon-mamba-7b]", "ams_matmul.cu",
            "src/repro/kernels/ams_matmul.py:138", "ssm-fp5.33", k1_ssm, k1_ssm_err),
        row("ams_matmul_fp533[recurrentgemma-9b]", "ams_matmul.cu",
            "src/repro/kernels/ams_matmul.py:138", "hybrid-fp5.33", k1_rg, k1_rg_err),
        row("ams_matmul_planes[musicgen-medium]", "ams_matmul.cu",
            "src/repro/kernels/ams_matmul.py:95", "audio-fp4.25", k1b_zoo, k1b_zoo_err),
        row("paged_attention_ams[internvl2-1b]", "paged_attention.cu",
            "src/repro/kernels/attention_template.py:399", "vlm-fp5.33",
            *k2_zoo["internvl2-1b"]),
        row("paged_attention_ams[musicgen-medium]", "paged_attention.cu",
            "src/repro/kernels/attention_template.py:399", "audio-fp4.25",
            *k2_zoo["musicgen-medium"]),
        row("ams_matmul_planes[llama4-scout-17b-16e]", "ams_matmul.cu",
            "src/repro/kernels/ams_matmul.py:95", "moe-fp4.25", k1b_scout, k1b_scout_err),
        row("paged_attention_ams[llama4-scout-17b-16e]", "paged_attention.cu",
            "src/repro/kernels/attention_template.py:399", "moe-fp4.25",
            *k2_zoo["llama4-scout-17b-16e"]),
        row("paged_attention_bf16", "paged_attention.cu",
            "src/repro/kernels/attention_template.py:292", "fp16", k3, k3_err),
        row("contiguous_attention", "contiguous_attention.cu",
            "src/repro/kernels/attention_template.py:472", "contig-fp5.33", k4, k4_err),
        row("contiguous_attention_mla", "contiguous_attention.cu",
            "src/repro/kernels/attention_template.py:299", "mla-fp5.33", k5, k5_err),
        row("paged_attention_stream_bf16", "paged_attention.cu",
            "src/repro/kernels/attention_template.py:299", None, k5p["bf16"], k5p_err["bf16"],
            k5p_launches["bf16"]),
        row("paged_attention_stream_ams", "paged_attention.cu",
            "src/repro/kernels/attention_template.py:309", None, k5p["ams"], k5p_err["ams"],
            k5p_launches["ams"]),
    ]
    # the tp paths' kernels at a rank's shapes: launches per rank on the tp
    # path's served run (the ranks' counts are equal: checked); Qwen2-7B's
    # K1 shards serve both the paged and the contiguous path
    for name, key, src, replaces, path in (
            ("ams_matmul_fp533[qwen2-7b tp2]", "ams_matmul_fp533", "ams_matmul.cu",
             "src/repro/kernels/ams_matmul.py:138", "tp2-fp5.33"),
            ("ams_matmul_fp533[qwen2-7b contig tp2]", "ams_matmul_fp533", "ams_matmul.cu",
             "src/repro/kernels/ams_matmul.py:138", "tp2-contig-fp5.33"),
            ("ams_matmul_fp533[minicpm3-4b tp2]", "ams_matmul_fp533[minicpm3-4b]",
             "ams_matmul.cu", "src/repro/kernels/ams_matmul.py:138", "tp2-mla-fp5.33"),
            ("ams_matmul_fp533[falcon-mamba-7b tp2]", "ams_matmul_fp533[falcon-mamba-7b]",
             "ams_matmul.cu", "src/repro/kernels/ams_matmul.py:138", "tp2-ssm-fp5.33"),
            ("ams_matmul_fp533[recurrentgemma-9b tp2]", "ams_matmul_fp533[recurrentgemma-9b]",
             "ams_matmul.cu", "src/repro/kernels/ams_matmul.py:138", "tp2-hybrid-fp5.33"),
            ("paged_attention_ams[qwen2-7b tp2]", "paged_attention_ams", "paged_attention.cu",
             "src/repro/kernels/attention_template.py:399", "tp2-fp5.33"),
            ("ams_matmul_planes[llama4-scout-17b-16e tp2]", "ams_matmul_planes", "ams_matmul.cu",
             "src/repro/kernels/ams_matmul.py:95", "tp2-moe-fp4.25"),
            ("paged_attention_ams[llama4-scout-17b-16e tp2]", "paged_attention_ams[scout]",
             "paged_attention.cu", "src/repro/kernels/attention_template.py:399",
             "tp2-moe-fp4.25"),
            ("paged_attention_bf16[qwen2-7b tp2]", "paged_attention_bf16", "paged_attention.cu",
             "src/repro/kernels/attention_template.py:292", "tp2-fp16")):
        res, err = tp_times[key]
        per_rank = [ls[name.split("[")[0]] for ls in tp_lines[path]["launches"]["tp2"]]
        kernels.append(dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
                            replaces=replaces, path=path, paths=[path], launches=per_rank[0],
                            launches_per_rank=per_rank, max_abs_err=err, ms=res["ms"],
                            plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                            bound_by=res["bound_by"], library_ms=None))
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
