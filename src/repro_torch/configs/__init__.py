from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig, SSMConfig,
                                ShapeConfig, SHAPES, SHAPES_BY_NAME,
                                shape_applicable)
from repro_torch.configs.registry import (ARCH_IDS, get_config, get_smoke_config,
                                    input_specs, iter_cells)

__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "SHAPES_BY_NAME", "shape_applicable",
    "ARCH_IDS", "get_config", "get_smoke_config", "input_specs", "iter_cells",
]
