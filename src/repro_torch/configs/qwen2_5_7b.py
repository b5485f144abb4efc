# Port of src/repro/configs/qwen2_5_7b.py: a copy with its imports rewired to repro_torch.
"""Qwen2.5-7B-Instruct: the paper's own efficiency-eval model (Table 3 uses
its (3584, 18944) MLP-down shape). Same backbone dims as Qwen2-7B."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    ffn_activation="silu_glu",
    source="[hf:Qwen/Qwen2.5-7B-Instruct; hf]",
)
