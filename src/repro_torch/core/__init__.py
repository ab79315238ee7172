from repro_torch.core.optim import (OptState, Optimizer, TrainState,
                                    lars, make_optimizer, msgd,
                                    optimizer_names, sngd, sngm)
from repro_torch.core.schedules import make_schedule

__all__ = ["OptState", "Optimizer", "TrainState", "lars", "make_optimizer",
           "msgd", "optimizer_names", "sngd", "sngm", "make_schedule"]
