from repro_torch.training.loss import lm_loss
from repro_torch.training.step import loss_fn, make_train_step, run_steps
from repro_torch.training.loops import train_convnet, train_lm

__all__ = ["lm_loss", "loss_fn", "make_train_step", "run_steps",
           "train_convnet", "train_lm"]
