"""Architecture registry — port of ``repro/configs/registry.py``, holding the
architectures this slice serves: Qwen2-7B and the tiny ladder."""

from __future__ import annotations

from repro_torch.configs import qwen2_7b, tiny
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {qwen2_7b.CONFIG.name: qwen2_7b.CONFIG}
ARCHS.update(tiny.TINY_FAMILY)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
