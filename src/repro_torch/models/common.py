"""Model-definition substrate: parameter construction, norms, rotary, masking (torch).

Counterpart of ``repro.models.common``.  Parameters are ``nn.Parameter``s
of ``nn.Module``s, built by :class:`ParamInit` from a seeded
``torch.Generator`` as the JAX ``ParamMaker`` builds them, each carrying
its leaf's logical axes (``logical_axes``) ("normal": a
float32 normal times ``scale``, then the parameter dtype; "ones";
"zeros"; "slog", Mamba's ``A_log``: each row ``log(1..d_state)`` in
float32 with the JAX package's bits, then the parameter dtype).  The JAX
abstract mode is the ``meta`` device: a model built there allocates
nothing and still has every shape.

Each function casts where its JAX twin casts (``astype``): the norms,
rotary and the softmax compute in float32 and return the input's dtype;
``cross_entropy`` takes float32 logits.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.partition import weight

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
    ``meta`` device needs none and allocates nothing).  ``place(value, axes)``,
    where given, takes each leaf as it is drawn and returns the block to keep
    (a rank's block on a mesh), so that no more than one whole leaf is ever
    held; the parameter then records the leaf's ``full_shape``.
    """

    def __init__(self, dtype: str, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 place: Optional[Callable[[torch.Tensor, Tuple], torch.Tensor]] = None):
        self.dtype = torch_dtype(dtype)
        self.device = torch.device(device)
        self.generator = generator
        self.place = place
        if self.device.type != "meta" and generator is None:
            raise ValueError("a generator is needed to initialize parameters off the meta device")

    def __call__(self, shape: Sequence[int], axes: Optional[Sequence[Optional[str]]] = None,
                 init: str = "normal", scale: float = 0.02) -> nn.Parameter:
        """A parameter of ``shape`` whose dimensions carry the logical ``axes`` (the JAX
        leaf's, read by ``logical_axes``; a block's leaves have no leading ``layers``;
        None: every dimension replicated)."""
        shape = tuple(int(s) for s in shape)
        axes = (None,) * len(shape) if axes is None else tuple(axes)
        if len(axes) != len(shape):
            raise ValueError(f"{len(axes)} logical axes {tuple(axes)} for shape {shape}")
        if self.device.type == "meta":
            value = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif init == "zeros":
            value = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            value = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "normal":
            value = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                                device=self.device).mul_(scale).to(self.dtype)
        elif init == "slog":                # Mamba's A_log: each row log(1..d_state)
            steps = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=self.device)
            value = xla_log_f32(steps).expand(shape).to(self.dtype).clone()
        else:
            raise ValueError(init)
        if self.place is not None and self.device.type != "meta":
            value = self.place(value, axes)
        param = nn.Parameter(value)
        param.logical_axes = tuple(axes)
        if tuple(value.shape) != shape:
            param.full_shape = shape
        return param


def logical_axes(module: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """name -> logical axes of each parameter of ``module`` (as ``ParamInit`` made it)."""
    return {name: p.logical_axes for name, p in module.named_parameters()}


# XLA:CPU's float32 log: the Cephes polynomial, in the order of its LLVM IR
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of positive, finite, normal float32 ``x`` as the JAX package computes it
    on the CPU, bit for bit: XLA's polynomial, not a correctly rounded log (``torch.log``
    differs by one ulp at 7, 47, 49, ...).  Each multiply-add the backend fuses is one
    float64 multiply-add rounded once to float32 (a float32 product is exact in float64)."""
    def fma(a, b, c):
        return (torch.as_tensor(a, dtype=torch.float32).double() * b.double()
                + torch.as_tensor(c, dtype=torch.float32).double()).float()

    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 1056964608).view(torch.float32)      # mantissa in [0.5, 1)
    low = m < 0.707106781186547524
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    z = x * x
    x3 = z * x
    p = _LOG_P
    a, b, c = fma(p[0], x, p[1]), fma(p[3], x, p[4]), fma(p[6], x, p[7])
    a, b, c = fma(a, x, p[2]), fma(b, x, p[5]), fma(c, x, p[8])
    y = fma(fma(fma(a, x3, b), x3, c), x3, _LOG_Q1 * e)
    return fma(_LOG_Q2, e, fma(-0.5, z, x) + y)


# ---------------------------------------------------------------------------
# numerics


class Norm(nn.Module):
    """``init_norm`` / ``apply_norm``: RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``)."""

    def __init__(self, mk: ParamInit, d: int, kind: str = "rmsnorm", eps: float = 1e-5):
        super().__init__()
        self.kind, self.eps = kind, eps
        self.scale = mk((d,), ("embed_act",), init="ones")
        if kind == "layernorm":
            self.bias = mk((d,), ("embed_act",), init="zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "layernorm":
            return layernorm(x, weight(self, "scale"), weight(self, "bias"), self.eps)
        return rmsnorm(x, weight(self, "scale"), self.eps)


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
