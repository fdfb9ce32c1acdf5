"""PyTorch/CUDA port of the group-sparse OT system (the JAX package is ``repro``).

The package mirrors ``repro`` module by module.  Plain tensor code is
PyTorch; each Pallas TPU kernel on the ported path is a CUDA C++ kernel for
Hopper (``sm_90a``) under ``repro_torch/kernels/csrc``, built with ``nvcc``
at first use and bound through ``ctypes``.  Every kernel wrapper keeps a
plain PyTorch version beside it, used only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
without a CUDA device they raise ``RuntimeError`` instead of quietly
running on the host.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
