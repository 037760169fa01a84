"""Architecture and quantization configs — port of ``repro/configs``."""

from repro_torch.configs.base import ArchConfig, QuantConfig
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchConfig", "QuantConfig", "get_arch"]
