"""mamba2-130m [ssm] — attention-free, SSD (state-space duality).
A copy of ``repro/configs/mamba2_130m.py``.

24L d_model=768 d_ff=0 vocab=50280 ssm_state=128
[arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                  # attn-free, no FFN: mamba block only
    vocab_size=50280,
    attn_period=0,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,            # d_inner = 1536
    ssm_head_dim=64,         # 24 SSD heads
    ssm_groups=1,
    tie_embeddings=True,
)
