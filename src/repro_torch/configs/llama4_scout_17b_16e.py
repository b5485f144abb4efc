# Port of src/repro/configs/llama4_scout_17b_16e.py: a copy with its imports rewired to repro_torch.
"""Llama-4-Scout-17B-16E: MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attention="gqa",
    rope_theta=500_000.0,
    num_experts=16,
    experts_per_token=1,
    moe_shared_expert_ff=8192,
    ffn_activation="silu_glu",
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
