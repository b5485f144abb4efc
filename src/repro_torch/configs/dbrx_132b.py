# Port of src/repro/configs/dbrx_132b.py: a copy with its imports rewired to repro_torch.
"""DBRX-132B: fine-grained MoE, 16 experts top-4, GQA. [hf:databricks/dbrx-base; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    attention="gqa",
    rope_theta=500_000.0,
    num_experts=16,
    experts_per_token=4,
    ffn_activation="silu_glu",
    source="[hf:databricks/dbrx-base; unverified]",
)
