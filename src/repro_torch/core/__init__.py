from repro_torch.core.optim import (LambState, OptState, Optimizer,
                                    TrainState, lamb, lars, make_optimizer,
                                    msgd, optimizer_names, sngd, sngm)
from repro_torch.core.schedules import make_schedule

__all__ = ["LambState", "OptState", "Optimizer", "TrainState", "lamb", "lars",
           "make_optimizer", "msgd", "optimizer_names", "sngd", "sngm",
           "make_schedule"]
