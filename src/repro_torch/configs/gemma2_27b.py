"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.
A copy of ``repro/configs/gemma2_27b.py``.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,            # explicit (not d_model / n_heads)
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,     # local layers
    local_global_period=2,   # even layers local SWA, odd layers global
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,    # sandwich norms
    rope_theta=10_000.0,
    act="gelu",
    tie_embeddings=True,
)
