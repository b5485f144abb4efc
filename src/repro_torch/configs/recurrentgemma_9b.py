# Port of src/repro/configs/recurrentgemma_9b.py: a copy with its imports rewired to repro_torch.
"""RecurrentGemma-9B: RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427; unverified] — 38 layers, d_model=4096, lru_width=4096,
16 heads MQA (kv=1, head_dim=256), local window 2048, GeGLU d_ff=12288.
Sub-quadratic (bounded-window attention + recurrence): runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention="gqa",
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    ffn_activation="gelu_glu",
    subquadratic=True,
    source="[arXiv:2402.19427; unverified]",
)
