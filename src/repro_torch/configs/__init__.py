from repro_torch.configs.base import (
    MLAConfig,
    MoEConfig,
    ModelConfig,
    OptimizerConfig,
    SHAPES,
    SHAPES_BY_NAME,
    SSMConfig,
    ShapeConfig,
    TrainConfig,
    shape_applicable,
)
from repro_torch.configs.registry import all_configs, get_config, list_archs
