from repro_torch.core.optim import (LambState, OptimizerSpec, OptState,
                                    Optimizer, TrainState, builder_accepts,
                                    from_pytree, lamb, lars, make_optimizer,
                                    msgd, optimizer_names, sngd, sngm,
                                    to_pytree)
from repro_torch.core.schedules import make_schedule

__all__ = ["LambState", "OptimizerSpec", "OptState", "Optimizer",
           "TrainState", "builder_accepts", "from_pytree", "lamb", "lars",
           "make_optimizer", "msgd", "optimizer_names", "sngd", "sngm",
           "to_pytree", "make_schedule"]
