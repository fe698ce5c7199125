"""Architecture registry: importing this package registers all assigned archs."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
    shape_applicable, get_arch, list_archs, reduced, with_overrides,
)

# Assigned architectures (registration side effects).
from repro_torch.configs import granite_3_2b        # noqa: F401
from repro_torch.configs import deepseek_7b         # noqa: F401
from repro_torch.configs import minicpm_2b          # noqa: F401
from repro_torch.configs import command_r_plus_104b # noqa: F401
from repro_torch.configs import whisper_medium      # noqa: F401
from repro_torch.configs import mamba2_130m         # noqa: F401
from repro_torch.configs import moonshot_v1_16b_a3b # noqa: F401
from repro_torch.configs import arctic_480b         # noqa: F401
from repro_torch.configs import llama_3_2_vision_90b  # noqa: F401
from repro_torch.configs import jamba_1_5_large_398b  # noqa: F401

ARCH_IDS = [
    "granite-3-2b", "deepseek-7b", "minicpm-2b", "command-r-plus-104b",
    "whisper-medium", "mamba2-130m", "moonshot-v1-16b-a3b", "arctic-480b",
    "llama-3.2-vision-90b", "jamba-1.5-large-398b",
]
