"""The paper's own model family, CPU-scale — a copy of ``repro/configs/tiny.py``.

A ladder of tiny llama-style LMs (the reference trains them on a synthetic
Zipf-Markov corpus for its scaling-law benchmarks).
"""

from repro_torch.configs.base import ArchConfig


def _tiny(name, n_layers, d_model, n_heads, d_ff, vocab=2048) -> ArchConfig:
    return ArchConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        head_dim=d_model // n_heads,
        d_ff=d_ff,
        vocab_size=vocab,
        tie_embeddings=True,
    )


TINY_FAMILY = {
    "tiny-160k": _tiny("tiny-160k", 2, 64, 2, 192),
    "tiny-650k": _tiny("tiny-650k", 3, 128, 4, 384),
    "tiny-2.6m": _tiny("tiny-2.6m", 4, 256, 4, 768),
    "tiny-10m": _tiny("tiny-10m", 6, 448, 8, 1344),
}

CONFIG = TINY_FAMILY["tiny-2.6m"]
