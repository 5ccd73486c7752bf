"""Hand-written CUDA kernels for the stitch data path (``csrc/``), their
ctypes wrappers (``stitch_copy``, ``stitched_attention``), plain PyTorch
versions (``ref``) and the device-dispatching entry points (``ops``)."""
