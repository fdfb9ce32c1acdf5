"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper), as ``repro.models.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ParamInit, swiglu
from repro_torch.sharding import partition as P


class MLP(nn.Module):
    """``init_mlp`` / ``apply_mlp``: the JAX leaves and shapes, ``(d_model, d_ff)`` first."""

    def __init__(self, mk: ParamInit, d_model: int, d_ff: int, act: str = "swiglu"):
        super().__init__()
        self.act = act
        if act == "swiglu":
            self.w_gate = mk((d_model, d_ff), ("embed", "mlp"))
            self.w_up = mk((d_model, d_ff), ("embed", "mlp"))
        else:
            self.w_in = mk((d_model, d_ff), ("embed", "mlp"))
            self.b_in = mk((d_ff,), ("mlp",), init="zeros")
            self.b_out = mk((d_model,), ("embed_act",), init="zeros")
        self.w_down = mk((d_ff, d_model), ("mlp", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """On a mesh the rank computes its block of ``mlp`` (column-parallel up, row-parallel
        down) and all-reduces the output over the axes that split it."""
        dt = x.dtype
        w = lambda name: P.weight(self, name).to(dt)
        if self.act == "swiglu":
            h = swiglu(x @ w("w_gate"), x @ w("w_up"))
        else:
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(x @ w("w_in") + w("b_in"), approximate="tanh")
        h = P.constrain(h, "batch", "seq", "mlp")
        out = P.reduce_split(self, "w_down", 0, h @ w("w_down"))
        if self.act != "swiglu":
            out = out + w("b_out")
        return P.constrain(out, "batch", "seq", "embed_act")
