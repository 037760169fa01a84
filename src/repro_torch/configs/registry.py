"""Architecture registry — port of ``repro/configs/registry.py``, holding the
architectures the port serves: Qwen2-7B and the tiny ladder.  The
reference's other registry archs (``NOT_PORTED``) raise, naming ROADMAP A10."""

from __future__ import annotations

from repro_torch.configs import qwen2_7b, tiny
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {qwen2_7b.CONFIG.name: qwen2_7b.CONFIG}
ARCHS.update(tiny.TINY_FAMILY)


#: the reference's registry archs that the port does not serve yet: MoE, SSM,
#: hybrid, sliding-window, sandwich-norm and seq2seq stacks (ROADMAP A10)
NOT_PORTED = ("h2o-danube-3-4b", "deepseek-coder-33b", "gemma2-27b", "moonshot-v1-16b-a3b",
              "phi3.5-moe-42b-a6.6b", "mamba2-130m", "jamba-v0.1-52b", "chameleon-34b",
              "seamless-m4t-large-v2")


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP A10); known: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
