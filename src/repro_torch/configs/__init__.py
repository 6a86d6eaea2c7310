"""Architecture configs: one module per assigned architecture + registry
(a copy of ``repro.configs``), and ``single_card``, the form served on one
card."""
from .base import (SHAPES, ArchConfig, MoECfg, ShapeCfg, get_arch,
                   list_archs, single_card)

__all__ = ["ArchConfig", "MoECfg", "SHAPES", "ShapeCfg", "get_arch",
           "list_archs", "single_card"]
