"""The port's hand-written Hopper kernels and their wrappers.

``flash_attention`` — the forward of the TPU flash-attention kernel, in CUDA
C++ (``csrc/flash_fwd.cu``), built and bound by ``_build``.
"""
