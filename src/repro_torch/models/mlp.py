"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper), as ``repro.models.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ParamInit, swiglu


class MLP(nn.Module):
    """``init_mlp`` / ``apply_mlp``: the JAX leaves and shapes, ``(d_model, d_ff)`` first."""

    def __init__(self, mk: ParamInit, d_model: int, d_ff: int, act: str = "swiglu"):
        super().__init__()
        self.act = act
        if act == "swiglu":
            self.w_gate = mk((d_model, d_ff))
            self.w_up = mk((d_model, d_ff))
        else:
            self.w_in = mk((d_model, d_ff))
            self.b_in = mk((d_ff,), init="zeros")
            self.b_out = mk((d_model,), init="zeros")
        self.w_down = mk((d_ff, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.act == "swiglu":
            h = swiglu(x @ self.w_gate.to(dt), x @ self.w_up.to(dt))
        else:
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(x @ self.w_in.to(dt) + self.b_in.to(dt), approximate="tanh")
        out = h @ self.w_down.to(dt)
        if self.act != "swiglu":
            out = out + self.b_out.to(dt)
        return out
