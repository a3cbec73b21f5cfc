"""PyTorch/CUDA port of orientedobjectdetection_tpu for NVIDIA Hopper.

Same configs, same results, same mmrotate ``state_dict`` names; tensors are
NCHW inside the modules and keep the JAX package's layouts at the public
functions. Hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use (:mod:`.utils.cuda_build`).
"""

__version__ = '0.1.0'
