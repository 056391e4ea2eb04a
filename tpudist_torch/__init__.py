"""tpudist_torch — the PyTorch + CUDA port of tpudist for NVIDIA Hopper.

The JAX package ``tpudist`` is the reference; this package mirrors its
module names (``models.vit``, ``serve.engine``, ``ops.flash_attention``, …)
so a reader can find each counterpart. It imports torch and numpy, never
jax, flax or any ``tpudist`` module: what it needs from tpudist's jax-free
modules (the telemetry schema, the batching scheme) it keeps its own copy
of.

Entry points run on the CUDA card unless the caller asks for the CPU
(``_device.resolve_device``); on the CPU every hand-written kernel takes
its plain-PyTorch version, which is what the CPU tests hold against the
JAX package.
"""
