from .arch import ArchConfig
from .registry import ARCH_IDS, get_config

__all__ = ["ArchConfig", "ARCH_IDS", "get_config"]
