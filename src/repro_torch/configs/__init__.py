from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,
                                      LONG_CONTEXT_WINDOW, PORTED_ARCHS,
                                      ArchSpec, InputShape, get_arch,
                                      list_archs, model_for_shape)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "LONG_CONTEXT_WINDOW", "PORTED_ARCHS",
           "ArchSpec", "InputShape", "get_arch", "list_archs",
           "model_for_shape"]
