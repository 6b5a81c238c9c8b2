"""seal_tpu_torch: the PyTorch/CUDA port of ``seal_tpu`` for NVIDIA Hopper.

FM-index-constrained key generation (``decoding.generate.fm_index_generate``)
with BART, over a device FM-index (``index.device_index.TorchFMIndex``).
The device ops the JAX package leaves to XLA are hand-written kernels here
(``kernels/``: CUDA C++ for sm_90a and Triton), each beside a plain PyTorch
version that runs on CPU tensors.  Imports torch and numpy, never jax and
nothing of ``seal_tpu``: the host modules it needs from there have copies
here (``index.fm_index``, ``index.suffix_array``, ``cpp.native``,
``retrieval.document``, ``utils.profiling``).
"""
