"""Batch-invariant row sums: the one reduction form of the solver's per-problem sums.

The L-BFGS inner products and norms, the dual value's marginal terms and
the per-group delta norms of the screening bounds all sum the last axis of
a ``(..., D)`` tensor once per problem.  PyTorch's reductions may choose
their order from the number of rows too (on the card; on the CPU for rows
long enough to be split between threads), so the same problem would get
other low bits alone than inside a batch.  :func:`row_sum` launches
``row_sum_kernel`` (``csrc/reduce.cu``), whose order depends on ``D``
alone: thread t of ``row_sum_threads(D)`` sums elements t, t + T, ... in
order, each warp reduces by an xor butterfly, and the warp partials are
added in warp order.  Its plain version, used for CPU tensors, is
``torch.sum``, taken row by row where rows are long (another order than the
kernel's: they agree to f32 tolerance).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# Rows shorter than this are never split between CPU threads (ATen's grain
# size), so one torch.sum over many of them sums each as it would alone.
_CPU_SPLIT_ROW = 32768


def row_sum_threads(D: int) -> int:
    """Threads per row of the kernel: fixed by the row length alone."""
    return 32 if D <= 32 else (128 if D <= 4096 else 512)


def row_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_sum`: ``torch.sum``, batch-invariant on the CPU."""
    D = int(x.shape[-1])
    if D < _CPU_SPLIT_ROW or x.numel() == D:
        return torch.sum(x, dim=-1)
    rows = x.reshape(-1, D)
    return torch.stack([torch.sum(rows[r : r + 1], dim=-1)[0]
                        for r in range(rows.shape[0])]).reshape(x.shape[:-1])


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x (..., D)`` f32 summed over its last axis -> ``(...)``, batch-invariant."""
    if not x.is_cuda:
        return row_sum_ref(x)
    if x.dtype != torch.float32:
        raise NotImplementedError(f"row_sum takes float32, got {x.dtype}")
    lead, D = tuple(x.shape[:-1]), int(x.shape[-1])
    R = 1
    for s in lead:
        R *= int(s)
    if R == 0 or D == 0:
        return torch.zeros(lead, dtype=x.dtype, device=x.device)
    xc = x.contiguous()
    out = torch.empty(lead, dtype=torch.float32, device=x.device)
    _build.check(_build.library().row_sum_launch(xc.data_ptr(), out.data_ptr(), R, D,
                                                 row_sum_threads(D),
                                                 _build.stream_handle(x.device)),
                 "row_sum_launch")
    _build.record_launch("row_sum")
    return out
