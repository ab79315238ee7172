"""Small convolutional classifier: the paper's Figure-1 network ("a
network with two convolutional layers"), trained by the CIFAR10-proxy
experiments (Fig. 1 and Table 2 at reduced scale).  A port of
``repro.models.convnet``.

The parameters keep the JAX package's layout: conv weights HWIO
``(3, 3, Cin, Cout)``, images NHWC ``(B, 32, 32, 3)``.  ``convnet_apply``
permutes to PyTorch's OIHW/NCHW inside, for ``F.conv2d`` and
``F.max_pool2d``, and back to NHWC before the flatten, so ``fc1`` reads
its rows in the JAX order (h, w, c) and a JAX parameter tree crosses
bitwise (``convert.from_numpy_tree``).  On CUDA, ``resolve_device`` turns
TF32 off for cuDNN's convolutions, so the card's fp32 network computes
in fp32 as the CPU's does.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models.param import ParamDef, materialize
from repro_torch.models.runtime import resolve_device

Tree = Dict[str, torch.Tensor]


def convnet_defs(n_classes: int = 10, width: int = 32):
    return {
        "conv1": ParamDef((3, 3, 3, width), (None, None, None, None), scale=0.1),
        "b1": ParamDef((width,), (None,), "zeros"),
        "conv2": ParamDef((3, 3, width, 2 * width), (None, None, None, None), scale=0.1),
        "b2": ParamDef((2 * width,), (None,), "zeros"),
        "fc1": ParamDef((2 * width * 8 * 8, 128), (None, None)),
        "bf": ParamDef((128,), (None,), "zeros"),
        "fc2": ParamDef((128, n_classes), (None, None)),
        "bo": ParamDef((n_classes,), (None,), "zeros"),
    }


def ghost_norm(h: torch.Tensor, ghost_batch: int, eps: float = 1e-5,
               channel_dim: int = -1) -> torch.Tensor:
    """Parameter-free ghost batch normalization (Hoffer et al. 2017,
    1705.08741): standardize each channel over virtual batches of
    ``ghost_batch`` examples instead of the full batch, with the
    population variance.  No learned scale or shift and no running
    statistics: eval uses the same batch statistics.  ``channel_dim`` is
    the channel axis of ``h`` (-1: the JAX package's NHWC)."""
    b = h.shape[0]
    g = min(ghost_batch, b)
    if b % g:
        raise ValueError(f"ghost_batch {g} must divide the batch {b}")
    c = channel_dim % h.dim() + 1            # the channel axis of hg
    hg = h.reshape(b // g, g, *h.shape[1:])
    dims = tuple(d for d in range(1, hg.dim()) if d != c)
    mu = hg.mean(dims, keepdim=True)
    var = hg.var(dims, unbiased=False, keepdim=True)
    return ((hg - mu) / torch.sqrt(var + eps)).reshape(h.shape)


def convnet_apply(p: Tree, x: torch.Tensor,
                  ghost_batch: Optional[int] = None) -> torch.Tensor:
    """x: (B, 32, 32, 3) -> logits (B, n_classes).  ``ghost_batch``
    normalizes each conv pre-activation over ghost groups."""
    def conv(h, w, b):
        # "SAME" for a 3x3 window at stride 1 pads one on each side
        y = F.conv2d(h, w.permute(3, 2, 0, 1), padding=1) + b[:, None, None]
        if ghost_batch:
            y = ghost_norm(y, ghost_batch, channel_dim=1)
        return F.relu(y)

    h = x.permute(0, 3, 1, 2)                       # NCHW
    h = F.max_pool2d(conv(h, p["conv1"], p["b1"]), 2)           # 16x16
    h = F.max_pool2d(conv(h, p["conv2"], p["b2"]), 2)           # 8x8
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # the JAX (h, w, c) order
    h = F.relu(h @ p["fc1"] + p["bf"])
    return h @ p["fc2"] + p["bo"]


def ce_loss(p: Tree, x: torch.Tensor, y: torch.Tensor,
            ghost_batch: Optional[int] = None) -> torch.Tensor:
    ll = F.log_softmax(convnet_apply(p, x, ghost_batch=ghost_batch), -1)
    return -ll.gather(1, y.long()[:, None]).mean()


def accuracy(p: Tree, x: torch.Tensor, y: torch.Tensor,
             ghost_batch: Optional[int] = None) -> torch.Tensor:
    logits = convnet_apply(p, x, ghost_batch=ghost_batch)
    return (logits.argmax(-1) == y).float().mean()


def init_convnet(seed: int = 0,
                 device: Union[str, torch.device, None] = None, **kw) -> Tree:
    """The JAX package's ``init_convnet(seed)``, drawn on ``device`` (CUDA
    unless the CPU is asked for)."""
    return materialize(convnet_defs(**kw), prng.PRNGKey(seed),
                       resolve_device(device))
