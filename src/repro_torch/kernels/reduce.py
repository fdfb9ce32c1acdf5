"""Batch-invariant row sums and inner products: the one reduction form of the solver's sums.

The L-BFGS inner products and norms, the dual value's marginal terms and
the per-group delta norms of the screening bounds all sum the last axis of
a ``(..., D)`` tensor once per problem.  PyTorch's reductions may choose
their order from the number of rows too (on the card; on the CPU for rows
long enough to be split between threads), so the same problem would get
other low bits alone than inside a batch.  :func:`row_sum` launches
``row_reduce_kernel<false>`` (``csrc/reduce.cu``), whose order depends on ``D``
alone: thread t of ``row_sum_threads(D)`` sums elements t, t + T, ... in
order, each warp reduces by an xor butterfly, and the warp partials are
added in warp order.  Its plain version, used for CPU tensors, is
``torch.sum``, taken row by row where rows are long (another order than the
kernel's: they agree to f32 tolerance).  :func:`row_dot` sums ``a * b``
in the same order with each product rounded on its own, in one launch
(``row_reduce_kernel<true>``), so it gives the bits of ``row_sum(a * b)``;
its plain version is exactly that.
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


def row_dot_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_dot`: ``row_sum_ref(a * b)``."""
    return row_sum_ref(a * b)


def _launch(entry: str, name: str, *xs: torch.Tensor) -> torch.Tensor:
    """Launch ``entry`` on the f32 rows of ``xs`` (one shape) -> their (...) sums."""
    for x in xs:
        if x.dtype != torch.float32:
            raise NotImplementedError(f"{name} takes float32, got {x.dtype}")
    lead, D = tuple(xs[0].shape[:-1]), int(xs[0].shape[-1])
    R = 1
    for s in lead:
        R *= int(s)
    if R == 0 or D == 0:
        return torch.zeros(lead, dtype=torch.float32, device=xs[0].device)
    xs = [x.contiguous() for x in xs]
    out = torch.empty(lead, dtype=torch.float32, device=xs[0].device)
    _build.check(getattr(_build.library(), entry)(
        *(x.data_ptr() for x in xs), out.data_ptr(), R, D, row_sum_threads(D),
        _build.stream_handle(xs[0].device)), entry)
    _build.record_launch(name)
    return out


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x (..., D)`` f32 summed over its last axis -> ``(...)``, batch-invariant."""
    if not x.is_cuda:
        return row_sum_ref(x)
    return _launch("row_sum_launch", "row_sum", x)


def row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b, -1)`` for f32 ``a, b (..., D)`` (broadcast), batch-invariant.

    Bitwise ``row_sum(a * b)``, in one launch on the card.
    """
    if not a.is_cuda:
        return row_dot_ref(a, b)
    if b.device != a.device:
        raise ValueError(f"row_dot: operands on {a.device} and {b.device}")
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return _launch("row_dot_launch", "row_dot", a, b)
