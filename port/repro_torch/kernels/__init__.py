"""Hand-written Hopper kernels (``repro_torch/csrc``), their plain PyTorch
versions (``ref``) and the device-dispatching wrappers (``ops``)."""
