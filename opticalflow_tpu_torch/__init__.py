"""opticalflow_tpu_torch — the PyTorch/CUDA port of ``opticalflow_tpu``.

A second package beside the JAX one, for NVIDIA Hopper GPUs (H100).  It
mirrors the JAX package's module names; plain tensor code is PyTorch and
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use.  It imports neither JAX
nor anything of ``opticalflow_tpu``.  Importing it is light: nothing is
built or loaded until a kernel is first called.
"""
