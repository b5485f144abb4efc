# Port of src/repro/configs/qwen1_5_4b.py: a copy with its imports rewired to repro_torch.
"""Qwen1.5-4B: dense MHA (kv == heads) with QKV bias. [hf:Qwen/Qwen1.5-4B; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
    ffn_activation="silu_glu",
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)
