"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX reference (``src/repro``), held
against it by the parity tests in ``tests/test_torch_*.py``.  It
imports ``torch``, never ``jax``, and nothing of ``repro``.  Ported so
far: paged serving of the dense decoder archs
(``python -m repro_torch.launch.serve``), with paged decode attention
as a hand-written CUDA kernel for ``sm_90a``
(``kernels/paged_attention``).
"""
