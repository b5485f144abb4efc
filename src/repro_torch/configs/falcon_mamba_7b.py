# Port of src/repro/configs/falcon_mamba_7b.py: a copy with its imports rewired to repro_torch.
"""Falcon-Mamba-7B: attention-free Mamba-1 SSM. [arXiv:2410.05355; unverified]

64 layers, d_model=4096, d_inner=8192 (expand 2), ssm_state=16, conv=4,
dt_rank = d_model/16 = 256. Sub-quadratic: runs the long_500k shape.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65024,
    attention="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=256,
    subquadratic=True,
    source="[arXiv:2410.05355; unverified]",
)
