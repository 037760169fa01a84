"""qwen2-7b [dense] — GQA with QKV bias.  A copy of ``repro/configs/qwen2_7b.py``.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
[arXiv:2407.10671; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,            # 3584 / 28
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
)
