"""Parameter counts and the device peaks the roofline floors divide by
(port of `param_count` in src/repro/analysis/roofline.py; its dry-run
records, HLO terms and tables are XLA-only and have no counterpart).

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit), not the reference's TPU figures: a card
set to a lower power limit runs below them.
"""

from __future__ import annotations

from typing import Dict

H100_HBM_BYTES_PER_S = 3.35e12        # HBM3, 80 GB
H100_BF16_FLOPS = 989e12              # dense bf16 tensor-core rate

HBM_BW = H100_HBM_BYTES_PER_S
PEAK_FLOPS = H100_BF16_FLOPS


def param_count(cfg) -> Dict[str, float]:
    """(total, active) parameter counts of the true (unpadded) architecture."""
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    emb = V * D
    head = D * V

    def attn_params():
        if cfg.attention == "mla":
            H = cfg.num_heads
            return (D * cfg.q_lora_rank
                    + cfg.q_lora_rank * H * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                    + D * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                    + cfg.kv_lora_rank * H * cfg.qk_nope_dim
                    + cfg.kv_lora_rank * H * cfg.v_head_dim
                    + H * cfg.v_head_dim * D)
        if cfg.attention == "none":
            return 0
        hd = cfg.head_dim
        return (D * cfg.num_heads * hd + 2 * D * cfg.num_kv_heads * hd
                + cfg.num_heads * hd * D)

    def ffn_params(width):
        mult = 3 if cfg.ffn_activation.endswith("_glu") else 2
        return mult * D * width

    if cfg.family == "ssm":
        di, n = cfg.d_inner, cfg.ssm_state
        dtr = cfg.dt_rank or D // 16
        per_layer = (D * 2 * di + cfg.ssm_conv * di + di * (dtr + 2 * n)
                     + dtr * di + di * n + di + di * D)
        total = emb + head + L * per_layer
        return {"total": total, "active": total}

    if cfg.family == "hybrid":
        W = cfg.lru_width
        rec = D * 2 * W + 4 * W + 2 * W * W + W * D + ffn_params(cfg.d_ff)
        att = attn_params() + ffn_params(cfg.d_ff)
        counts = {"rec": rec, "attn": att}
        pat = cfg.block_pattern
        total = emb + head + sum(counts[pat[i % len(pat)]] for i in range(L))
        return {"total": total, "active": total}

    att = attn_params()
    if cfg.num_experts:
        experts = cfg.num_experts * ffn_params(cfg.d_ff)
        shared = ffn_params(cfg.moe_shared_expert_ff) if cfg.moe_shared_expert_ff else 0
        router = D * cfg.num_experts
        per_layer = att + experts + shared + router
        per_layer_active = (att + cfg.experts_per_token * ffn_params(cfg.d_ff)
                            + shared + router)
    else:
        per_layer = att + ffn_params(cfg.d_ff)
        per_layer_active = per_layer
    return {"total": emb + head + L * per_layer,
            "active": emb + head + L * per_layer_active}
