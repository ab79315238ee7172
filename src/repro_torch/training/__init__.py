from repro_torch.training.loss import lm_loss
from repro_torch.training.step import loss_fn, make_train_step, run_steps

__all__ = ["lm_loss", "loss_fn", "make_train_step", "run_steps"]
