"""Runtime: the device context threaded through model apply functions.

The JAX package's ``Runtime`` carries a mesh; the port runs on one
device and carries that device instead, plus the choice of paged
decode attention, of remat in training and of the dtype the loss casts
the weights to.  Entry points run
on CUDA unless the caller asks for the CPU: ``resolve_device`` raises
when CUDA is asked for (the default) and no card is present, and never
falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch


@dataclasses.dataclass(frozen=True)
class Runtime:
    device: torch.device
    # paged decode attention through ``kernels.paged_attention.ops`` (the
    # CUDA kernel on a CUDA tensor, its plain version on a CPU tensor);
    # False runs the plain gather path of ``layers.gqa_attention``, the
    # mirror of the JAX package's CPU path, which the chip smoke run
    # compares the kernel path against
    paged_kernel: bool = True
    # train mode: checkpoint each block (torch.utils.checkpoint), so the
    # backward pass keeps one block's internals at a time, as the JAX
    # package's Runtime.remat does with jax.checkpoint; a stack of 12 or
    # more periods also runs them in checkpointed groups (sqrt-remat)
    remat: bool = False
    # the loss casts every stored fp32 leaf of two or more dims (stacked
    # leaves by their stored shape: the stacked norm scales too) to this
    # dtype once a micro-batch, before the forward, as the JAX package's
    # Runtime.gather_dtype does
    gather_dtype: str = "float32"
    # what remat saves: "full" saves a block's input only; the JAX
    # package's "save_tp" names tensor-parallel outputs, which the
    # one-device port does not have
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy == "save_tp":
            raise NotImplementedError(
                "remat_policy='save_tp' (tensor-parallel outputs) is not "
                "ported yet (ROADMAP.md Queue A item 5)")


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means CUDA.  On CUDA, fp32 matmuls are kept in full fp32
    (no TF32) and bf16 matmuls accumulate in fp32, as the JAX package's
    fp32 logits and ``preferred_element_type`` math assume."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_runtime(device: Union[str, torch.device, None] = None, *,
                 remat: bool = False, gather_dtype: str = "float32") -> Runtime:
    return Runtime(device=resolve_device(device), remat=remat,
                   gather_dtype=gather_dtype)


CPU_RUNTIME = Runtime(device=torch.device("cpu"))
