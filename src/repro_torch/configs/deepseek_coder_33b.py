"""deepseek-coder-33b [dense] — llama-arch GQA.  A copy of
``repro/configs/deepseek_coder_33b.py``.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256
[arXiv:2401.14196; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,            # 7168 / 56
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    act="silu",
    tie_embeddings=False,
)
