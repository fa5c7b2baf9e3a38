"""Model configs of the port: a copy of ``repro.configs``."""

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeSpec, all_configs,
                                      cell_is_runnable, get_config, reduced)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeSpec", "all_configs",
           "cell_is_runnable", "get_config", "reduced"]
