"""repro_torch.kernels — hand-written Hopper kernels and their launch counts.

Each kernel package is <name>/{ops,ref}.py plus csrc/: the wrapper
that dispatches on the tensor's device (the plain version for a CPU
tensor, the kernel for a CUDA tensor), the plain PyTorch version, and
the CUDA source.  ``build.py`` compiles the sources with nvcc at first
use.

``LAUNCHES`` holds one plain integer per kernel.  A wrapper adds one to
its kernel's count where it launches the kernel, and nowhere else, so a
run can show that its path went through the kernel.

``CALLS`` holds the same names and counts wrapper calls: each wrapper
adds one on entry, on either device, so a CPU run counts what a run on
the card would launch.  ``count_kernel_calls()`` reads them over a block,
as the JAX package's ``count_pallas_launches`` reads its trace-time
count.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0, "chunk_sumsq": 0,
                            "fused_update": 0, "fused_update_deferred": 0,
                            "adam_update": 0, "scale_apply": 0,
                            "fused_sngm_update": 0,
                            "lars_sqnorm": 0, "lars_update": 0,
                            "rmsnorm": 0, "flash_attention": 0}
CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def record_launch(name: str) -> None:
    LAUNCHES[name] += 1


def record_call(name: str) -> None:
    CALLS[name] += 1


@contextlib.contextmanager
def count_kernel_calls():
    """Wrapper calls inside the block: ``box["calls"]`` per kernel name,
    ``box["launches"]`` their sum (what the block launches on the card).

        with count_kernel_calls() as c:
            opt.step(grads, state, params)
        print(c["launches"])
    """
    start = dict(CALLS)
    box = {"launches": 0, "calls": {}}
    try:
        yield box
    finally:
        box["calls"] = {k: CALLS[k] - start[k] for k in CALLS}
        box["launches"] = sum(box["calls"].values())


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True
