"""seal_tpu_torch: the PyTorch/CUDA port of ``seal_tpu`` for NVIDIA Hopper.

FM-index-constrained key generation (``decoding.generate.fm_index_generate``)
with BART, over a device FM-index (``index.device_index.TorchFMIndex``).
The device ops the JAX package leaves to XLA are hand-written kernels here
(``kernels/``: CUDA C++ for sm_90a and Triton), each beside a plain PyTorch
version that runs on CPU tensors.  Imports torch, numpy and the jax-free
host modules of ``seal_tpu`` (``index.fm_index``, ``index.suffix_array``,
``cpp.native``), never jax.
"""
