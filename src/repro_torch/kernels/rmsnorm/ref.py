"""Plain PyTorch version of the RMSNorm kernel.

Mirrors ``repro.kernels.rmsnorm.ref.rmsnorm_ref`` (the math of the
model's ``layers.rmsnorm``): fp32 inside, the output in ``x.dtype``.
The wrapper in ``ops.py`` runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the CUDA kernel against it.
"""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x**2, -1) + eps) * scale`` over the last dim."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
