"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.
A copy of ``repro/configs/h2o_danube_3_4b.py``.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000
[arXiv:2401.16818; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,            # 3840 / 32
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,     # mistral-style SWA on every layer
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
)
