"""Model-definition substrate: parameter construction, norms, rotary, masking (torch).

Counterpart of ``repro.models.common``.  Parameters are ``nn.Parameter``s
of ``nn.Module``s, built by :class:`ParamInit` from a seeded
``torch.Generator`` as the JAX ``ParamMaker`` builds them ("normal": a
float32 normal times ``scale``, then the parameter dtype; "ones";
"zeros").  The JAX abstract mode is the ``meta`` device: a model built
there allocates nothing and still has every shape.

Each function casts where its JAX twin casts (``astype``): the norms,
rotary and the softmax compute in float32 and return the input's dtype;
``cross_entropy`` takes float32 logits.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``'bfloat16'``, ``'float32'``, ...)."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


class ParamInit:
    """Makes the parameters of a model, as the JAX ``ParamMaker`` does.

    ``generator`` draws the normal inits; it must live on ``device`` (a
    ``meta`` device needs none and allocates nothing).
    """

    def __init__(self, dtype: str, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.dtype = torch_dtype(dtype)
        self.device = torch.device(device)
        self.generator = generator
        if self.device.type != "meta" and generator is None:
            raise ValueError("a generator is needed to initialize parameters off the meta device")

    def __call__(self, shape: Sequence[int], init: str = "normal",
                 scale: float = 0.02) -> nn.Parameter:
        shape = tuple(int(s) for s in shape)
        if self.device.type == "meta":
            value = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif init == "zeros":
            value = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            value = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "normal":
            value = (torch.randn(shape, generator=self.generator, dtype=torch.float32,
                                 device=self.device) * scale).to(self.dtype)
        else:
            raise ValueError(init)
        return nn.Parameter(value)


# ---------------------------------------------------------------------------
# numerics


class Norm(nn.Module):
    """``init_norm`` / ``apply_norm``: RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``)."""

    def __init__(self, mk: ParamInit, d: int, kind: str = "rmsnorm", eps: float = 1e-5):
        super().__init__()
        self.kind, self.eps = kind, eps
        self.scale = mk((d,), init="ones")
        if kind == "layernorm":
            self.bias = mk((d,), init="zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "layernorm":
            return layernorm(x, self.scale, self.bias, self.eps)
        return rmsnorm(x, self.scale, self.eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def rotary_cos_sin(positions: torch.Tensor, dim: int,
                   theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, dim/2), float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with cos/sin (..., S, D/2) broadcast over heads."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def causal_mask(q_len: int, kv_len: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(q_len, kv_len) additive mask; queries are the LAST q_len positions."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(k_pos <= q_pos, zero, torch.full((), -1e30, dtype=dtype, device=device))


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


def softmax_fp32(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=dim)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over all positions (+ optional z-loss); logits (..., V)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    ce = torch.mean(lse - ll)
    zl = z_loss * torch.mean(torch.square(lse)) if z_loss else 0.0
    return ce + zl, ce


def count_params(model: nn.Module) -> int:
    """Scalar parameters of a module (``meta`` ones included)."""
    return sum(int(p.numel()) for p in model.parameters())
