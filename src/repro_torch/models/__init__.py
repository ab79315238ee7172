from repro_torch.models.param import ParamDef, count, materialize
from repro_torch.models.runtime import (CPU_RUNTIME, Runtime, make_runtime,
                                        resolve_device)
from repro_torch.models.transformer import (cast_for_compute, forward,
                                            model_defs, unembed_matrix)

__all__ = ["ParamDef", "count", "materialize", "CPU_RUNTIME", "Runtime",
           "make_runtime", "resolve_device", "cast_for_compute", "forward",
           "model_defs", "unembed_matrix"]
