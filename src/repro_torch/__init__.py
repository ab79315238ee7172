"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX reference (``src/repro``), held
against it by the parity tests in ``tests/test_torch_*.py``.  It
imports ``torch``, never ``jax``, and nothing of ``repro``.  Ported so
far, for the dense decoder archs at their full widths:

  * training (``python -m repro_torch.launch.train``): SNGM and its
    baselines with gradient accumulation, the multi-tensor optimizer
    passes as hand-written CUDA kernels (``kernels/multi_tensor``);
  * checkpoints and resume (``repro_torch.checkpoint``), in the JAX
    package's on-disk format, so each package resumes the other's runs;
  * paged serving (``python -m repro_torch.launch.serve``), decode
    attention as a hand-written CUDA kernel (``kernels/paged_attention``).

The kernels are built for ``sm_90a`` at first use.
"""
