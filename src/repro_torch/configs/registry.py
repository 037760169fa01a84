"""Architecture registry — port of ``repro/configs/registry.py``, holding the
architectures the port serves: the dense decoders (Qwen2-7B, deepseek-coder,
chameleon's backbone, h2o-danube-3's sliding window, gemma2's local/global
stack with sandwich norms), the mixture-of-experts decoders (moonshot-v1's
64 experts, phi3.5-moe's 16), the state-space and hybrid decoders
(mamba2-130m, jamba-v0.1's attention and SSM period of 8 with MoE), the
encoder-decoder with frame inputs (seamless-m4t-large-v2, served by
``models/seq2seq.py``) and the tiny ladder: every arch of the reference's
registry."""

from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    deepseek_coder_33b,
    gemma2_27b,
    h2o_danube_3_4b,
    jamba_v01_52b,
    mamba2_130m,
    moonshot_v1_16b_a3b,
    phi35_moe_42b_a66b,
    qwen2_7b,
    seamless_m4t_large_v2,
    tiny,
)
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        h2o_danube_3_4b.CONFIG,
        deepseek_coder_33b.CONFIG,
        qwen2_7b.CONFIG,
        gemma2_27b.CONFIG,
        chameleon_34b.CONFIG,
        moonshot_v1_16b_a3b.CONFIG,
        phi35_moe_42b_a66b.CONFIG,
        mamba2_130m.CONFIG,
        jamba_v01_52b.CONFIG,
        seamless_m4t_large_v2.CONFIG,
    ]
}

ASSIGNED = list(ARCHS)  # the 10 graded architectures (the dry-run's)

ARCHS.update(tiny.TINY_FAMILY)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
