"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE every 2nd.
A copy of ``repro/configs/jamba_v01_52b.py``.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Jamba-v0.1 uses Mamba-1 internally; we realize the mamba layers with the
SSD formulation (same selective-SSM family, d_state=16) — models/ssm.py.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,            # 4096 / 32
    d_ff=14336,
    vocab_size=65536,
    attn_period=8,           # 1 attention layer per 8 (1:7 with mamba)
    n_experts=16,
    top_k=2,
    moe_period=2,            # MoE every 2nd layer
    moe_d_ff=14336,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,            # d_inner = 8192
    ssm_head_dim=64,
    ssm_groups=1,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
)
