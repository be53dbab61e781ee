"""HandyRL on PyTorch and CUDA: the port of ``handyrl_tpu`` to an NVIDIA H100.

Subpackages mirror the JAX package's (``envs``, ``models``, ``ops``,
``runtime``, ``parallel``, ``utils``) so each counterpart is easy to find.
The port imports nothing from ``handyrl_tpu`` and nothing of JAX; its
hand-written CUDA kernels live in ``csrc/`` and are built by ``nvcc`` at
first use.
"""
