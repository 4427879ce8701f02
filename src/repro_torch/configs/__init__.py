from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    cell_is_runnable,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_NAMES,
    all_cells,
    get_config,
    get_shape,
    get_smoke_config,
    matrix_summary,
    runnable_cells,
)
from repro_torch.configs.vgg import VGG5, VGG8, VGGConfig  # noqa: F401
