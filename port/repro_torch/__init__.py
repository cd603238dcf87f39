"""PyTorch/CUDA port of the ``repro`` tensor-completion package.

Module names mirror ``src/repro/`` one to one so each counterpart is easy to
find. The port imports torch and numpy only (never jax, never ``repro``);
its entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CUDA tensor every kernel wrapper launches its hand-written Hopper
kernel (``repro_torch/csrc``) or raises; on a CPU tensor it runs the plain
PyTorch version in ``repro_torch.kernels.ref``.
"""
