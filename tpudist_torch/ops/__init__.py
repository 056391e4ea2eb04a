"""The port's hand-written Hopper kernels and their wrappers.

- ``flash_attention`` — the TPU flash-attention kernels in CUDA C++: the
  forward (``csrc/flash_fwd.cu``) and the dQ and dKV backward passes
  (``csrc/flash_bwd.cu``), behind one ``autograd.Function``;
- ``fused_norm`` — the four fused BatchNorm epilogues
  (``csrc/fused_norm.cu``).

``_build`` compiles each source with ``nvcc`` at first use and loads it
through ctypes. ``dispatch`` (with its clients ``attention_dispatch`` and
``norm_dispatch``) decides where ``--flash auto`` and ``--fused-bn auto``
run each kernel; ``mixup`` mixes a batch inside the train step.
"""
