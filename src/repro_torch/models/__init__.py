from repro_torch.models.convnet import (accuracy, ce_loss, convnet_apply,
                                        convnet_defs, ghost_norm, init_convnet)
from repro_torch.models.param import ParamDef, count, materialize
from repro_torch.models.runtime import (CPU_RUNTIME, Runtime, make_runtime,
                                        resolve_device)
from repro_torch.models.transformer import (cast_for_compute, forward,
                                            model_defs, unembed_matrix)

__all__ = ["accuracy", "ce_loss", "convnet_apply", "convnet_defs",
           "ghost_norm", "init_convnet", "ParamDef", "count", "materialize",
           "CPU_RUNTIME", "Runtime", "make_runtime", "resolve_device",
           "cast_for_compute", "forward", "model_defs", "unembed_matrix"]
