"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
A copy of ``repro/configs/phi35_moe_42b_a66b.py``.

32L d_model=4096 32H (GQA kv=8) per-expert d_ff=6400 vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,            # 4096 / 32
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    moe_period=1,
    moe_d_ff=6400,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
)
