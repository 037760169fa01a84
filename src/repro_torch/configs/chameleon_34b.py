"""chameleon-34b [vlm] — early-fusion; VQ image tokens share the text vocab,
so the backbone is a pure LM (the VQ tokenizer frontend is out of scope per
the assignment: image content arrives as token ids).  A copy of
``repro/configs/chameleon_34b.py``.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,            # 8192 / 64
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,            # chameleon stabilizes with QK-norm
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
)
