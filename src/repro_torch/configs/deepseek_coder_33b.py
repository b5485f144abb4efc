# Port of src/repro/configs/deepseek_coder_33b.py: a copy with its imports rewired to repro_torch.
"""DeepSeek-Coder-33B: llama-arch dense GQA. [arXiv:2401.14196; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    attention="gqa",
    rope_theta=100_000.0,
    ffn_activation="silu_glu",
    source="[arXiv:2401.14196; hf]",
)
