"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style 64-expert top-6 MoE.
A copy of ``repro/configs/moonshot_v1_16b_a3b.py``.

48L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,            # 2048 / 16
    d_ff=1408,               # unused (all layers MoE); kept for bookkeeping
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    moe_period=1,            # every layer MoE
    moe_d_ff=1408,
    rope_theta=50_000.0,
    act="silu",
    tie_embeddings=False,
)
