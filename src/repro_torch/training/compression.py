"""Gradient compression: int8 with error feedback (torch), as ``repro.training.compression``.

Each gradient leaf, plus the residual the last step left, is quantized
to int8 with one float32 scale per tensor and dequantized; the new
residual carries the quantization error into the next step (Seide et
al. 2014; Karimireddy et al. 2019).  The trainer applies it to the
gradients before the optimizer: it models the wire format of a
cross-pod all-reduce (4 x fewer bytes than float32).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def init_error_state(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Returns ``(g_hat float32, new_err)``, ``g_hat = dequant(quant(g + err))``."""
    x = g.float() + err
    q, scale = _q8(x)
    g_hat = q.float() * scale
    return g_hat, x - g_hat


def apply_error_feedback(grads: Params, err_state: Params) -> Tuple[Params, Params]:
    """Every leaf through :func:`compress_decompress`: ``(compressed grads, new errors)``."""
    out = {k: compress_decompress(g, err_state[k]) for k, g in grads.items()}
    return {k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()}


def wire_bytes_saved(params: Params) -> Tuple[int, int]:
    """(float32 bytes, int8 bytes) per all-reduce, for reporting."""
    n = sum(int(p.numel()) for p in params.values())
    return 4 * n, n + 4 * len(params)
