"""seamless-m4t-large-v2 [audio] — encoder-decoder multimodal backbone.
A copy of ``repro/configs/seamless_m4t_large_v2.py``.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206
[arXiv:2308.11596; hf]

The assigned geometry specifies the transformer BACKBONE; we instantiate
24 encoder + 24 decoder layers of it.  The audio frontend is a STUB:
``models/seq2seq.encode`` takes precomputed frame embeddings (B, S, d_model).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,             # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,             # 1024 / 16
    d_ff=8192,
    vocab_size=256206,
    encoder_decoder=True,
    n_encoder_layers=24,
    decoder_cache_len=4096,
    norm_type="layernorm",
    act="gelu",
    rope_theta=10_000.0,
    input_kind="frames",
    tie_embeddings=False,
)
