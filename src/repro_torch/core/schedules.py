"""Learning-rate schedules used in the paper's experiments.

A port of ``repro.core.schedules``: the same schedules, computed in
torch float32 on the CPU as the JAX package computes them in f32 (a
Python float meeting an f32 tensor is rounded to f32 first, as a weakly
typed JAX float is).  A schedule maps the step (an int or an integer
tensor) to a 0-dim f32 CPU tensor, which the optimizers use as a scalar
on any device.  ``pow`` and ``cos`` may round differently from XLA's by
an ulp; ``tests/test_torch_train.py`` states the bound it holds.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[object], torch.Tensor]   # step -> lr


def _t(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32).cpu()


def constant(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def poly_power(lr0: float, total_steps: int, power: float = 1.1) -> Schedule:
    """lr0 * (1 - t/T)^power  — the paper's poly strategy (You et al. 2017)."""
    def sched(step):
        frac = torch.clamp(_t(step) / total_steps, 0.0, 1.0)
        return lr0 * (1.0 - frac) ** power
    return sched


def step_decay(lr0: float, milestones: Sequence[int], factor: float = 0.1) -> Schedule:
    """Divide lr by 1/factor at each milestone (He et al. 2016 recipe)."""
    ms = torch.tensor(sorted(milestones), dtype=torch.int32)
    def sched(step):
        n = (torch.as_tensor(step).cpu() >= ms).sum().to(torch.float32)
        return lr0 * factor ** n
    return sched


def warmup(base: Schedule, warmup_steps: int, init_lr: float = 0.0) -> Schedule:
    """Gradual linear warm-up from init_lr to base(warmup_steps), then base.

    Used only for the LARS-with-warm-up baseline (Table 2); SNGM needs none.
    """
    def sched(step):
        t = _t(step)
        target = base(warmup_steps)
        frac = torch.clamp(t / max(warmup_steps, 1), 0.0, 1.0)
        warm = init_lr + frac * (target - init_lr)
        return torch.where(t < warmup_steps, warm, base(step))
    return sched


def cosine(lr0: float, total_steps: int, final_frac: float = 0.0) -> Schedule:
    def sched(step):
        frac = torch.clamp(_t(step) / total_steps, 0.0, 1.0)
        c = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr0 * (final_frac + (1 - final_frac) * c)
    return sched


# ---------------------------------------------------------------------------
# registry + declarative specs
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": constant,
    "poly_power": poly_power,
    "step_decay": step_decay,
    "warmup": warmup,
    "cosine": cosine,
}


def schedule_names():
    return tuple(sorted(SCHEDULES))


def make_schedule(spec) -> Schedule:
    """Build a schedule from a JSON-safe ``{"name": ..., "kwargs": {...}}``
    spec; ``warmup`` nests its base schedule as another spec under
    ``kwargs["base"]``."""
    name = spec["name"]
    if name not in SCHEDULES:
        raise KeyError(f"unknown schedule {name!r}; "
                       f"available {schedule_names()}")
    kwargs = dict(spec.get("kwargs", {}))
    if name == "warmup":
        kwargs["base"] = make_schedule(kwargs["base"])
    return SCHEDULES[name](**kwargs)
