"""Recurrent blocks (torch): Mamba (jamba's SSM layer) and xLSTM's mLSTM and sLSTM, as
``repro.models.ssm``.

Mamba is the Mamba-1 selective scan, ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t``
and ``y_t = C_t . h_t`` with a decay per (channel, state), between an
input projection with a causal depthwise conv and a gated output
projection.  mLSTM is chunkwise gated linear attention with a matrix
memory and the q.n normalizer; sLSTM an exp-gated scalar-memory
recurrence with per-head recurrent weights and the m-stabilizer.  All
three are plain PyTorch: the JAX ``lax.scan`` over positions (the
selective scan, sLSTM) and over chunks (mLSTM) is a Python loop.  The
conv helpers (``_causal_conv``, ``_conv_step``) serve Mamba and mLSTM.

Each module keeps its JAX leaves' names and shapes and runs the JAX
function's three paths: training (no state), prefill (S > 1 from a state,
the state out) and decode (S == 1 with a state).  The recurrent state
computes in float32 (float64 for a float64 model); its dicts are
``{"conv", "ssm"}`` (Mamba), ``{"conv", "C", "n"}`` (mLSTM) and ``{"h",
"c", "n", "m"}`` (sLSTM).

Departures from the reference (ROADMAP queue C), each where the reference
raises or gives NaN; wherever it runs, the results are its own:
  * the intra-chunk gate is ``exp(where(mask, decay, -inf))``, the same
    values as JAX's ``where(mask, exp(decay), 0)``, whose masked exponent
    overflows once a chunk's summed log-forget passes about 88 and turns
    the backward into 0 * inf = NaN;
  * S is cut into JAX's chunks, ``c = S // max(S // chunk, 1)`` each, plus
    one short last chunk with the remainder, where JAX's reshape raises
    (mLSTM) or its assertion fails (Mamba's scan, whose values do not
    depend on the chunks: they only set where training recomputes);
  * prefill's conv state is the last ``K - 1`` rows of the input
    left-padded with zeros (the conv's own zero history), so a prompt of
    1 or 2 tokens leaves a state that decode can read (mLSTM and Mamba).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamInit, rmsnorm

State = Dict[str, torch.Tensor]
CONV_K = 4                                   # mLSTM's conv taps (``init_mlstm``)
SLSTM_GATES = ("i", "f", "z", "o")


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The recurrence's dtype: float32, or float64 for a float64 model."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (C, K) -> (B, S, C); the K taps summed in
    order in x's dtype, as the JAX Python ``sum``."""
    K, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    w = w.to(x.dtype)
    y = xp[:, 0:S, :] * w[:, 0]
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * w[:, i]
    return y + b.to(x.dtype)


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's conv: x_t (B, C), conv_state (B, K - 1, C) -> (y (B, C), next state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)          # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return y, window[:, 1:, :]


def chunk_bounds(S: int, chunk: int) -> List[Tuple[int, int]]:
    """(start, length) of each chunk: JAX's ``max(S // chunk, 1)`` chunks of
    ``S // max(S // chunk, 1)`` positions, then the remainder (a departure: JAX raises)."""
    n = max(S // chunk, 1)
    c = S // n
    bounds = [(i * c, c) for i in range(n)]
    if n * c < S:
        bounds.append((n * c, S - n * c))
    return bounds


# ---------------------------------------------------------------------------
# Mamba (jamba's SSM layer)


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, dt rank, state size)."""
    s = cfg.ssm
    return s.expand * cfg.d_model, s.dt_rank or math.ceil(cfg.d_model / 16), s.d_state


def _scan_chunk(h, u, dt, A, Bm, Cm):
    """The recurrence over one chunk from ``h`` (B, di, st): (ys (B, c, di), h).  Each step
    as JAX's: ``dA = exp(dt A)``, ``h = dA * h + dBu``, ``y = einsum(h, C)``; ``dA`` and
    ``dBu`` are elementwise, so they are taken for the whole chunk at once."""
    dA = torch.exp(dt[..., None] * A)                                  # (B, c, di, st)
    dBu = (dt * u)[..., None] * Bm[:, :, None, :]
    ys = []
    for t in range(u.shape[1]):
        h = dA[:, t] * h + dBu[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def _selective_scan(u, dt, A, Bm, Cm, chunk: int, h0: Optional[torch.Tensor] = None):
    """Mamba-1 recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t``, ``y_t = C_t . h_t``:
    u, dt (B, S, di); A (di, st); Bm, Cm (B, S, st).  Returns (ys (B, S, di), h_final
    (B, di, st)), from ``h0`` or zeros.

    The chunks (``chunk_bounds``) only set where a backward pass recomputes: with
    gradients on, each chunk runs under ``torch.utils.checkpoint``, as JAX's
    ``jax.checkpoint(chunk_fn)``, so the backward keeps one state a chunk."""
    B, S, di = u.shape
    h = h0 if h0 is not None else torch.zeros((B, di, A.shape[1]), dtype=u.dtype,
                                               device=u.device)
    remat = torch.is_grad_enabled()
    ys = []
    for s0, c in chunk_bounds(S, chunk):
        args = (h, u[:, s0:s0 + c], dt[:, s0:s0 + c], A, Bm[:, s0:s0 + c], Cm[:, s0:s0 + c])
        y, h = checkpoint(_scan_chunk, *args, use_reentrant=False) if remat else \
            _scan_chunk(*args)
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h


class Mamba(nn.Module):
    """``init_mamba`` / ``apply_mamba``: in-projection to ``xin`` and the gate ``z``, the
    causal conv and silu, ``x_proj`` to dt (through ``dt_w``, ``dt_b``, softplus), B and
    C, the selective scan with ``A = -exp(A_log)`` plus ``D`` times the conv output, then
    times ``silu(z)`` and the out-projection.

    Decode (one token with a state) steps the conv from the state's ``conv`` and the
    scan from its ``ssm``, the same step as the scan's.  Prefill (S > 1 with a state)
    runs the conv from the zero history, as JAX's does, but starts the scan from the
    state's ``ssm``: every caller prefills from a zero state, where the two agree."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        di, dtr, st = mamba_dims(cfg)
        self.cfg = cfg
        self.in_proj = mk((d, 2 * di), ("embed", "mlp"))
        self.conv_w = mk((di, cfg.ssm.d_conv), ("mlp", "conv"))
        self.conv_b = mk((di,), ("mlp",), init="zeros")
        self.x_proj = mk((di, dtr + 2 * st), ("mlp", None))
        self.dt_w = mk((dtr, di), (None, "mlp"))
        self.dt_b = mk((di,), ("mlp",), init="zeros")
        self.A_log = mk((di, st), ("mlp", "state"), init="slog")
        self.D = mk((di,), ("mlp",), init="ones")
        self.out_proj = mk((di, d), ("mlp", "embed"))

    def forward(self, x: torch.Tensor, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
        """x (B, S, d_model) -> (y, new state: None without ``state``)."""
        cfg = self.cfg
        dt_, wide = x.dtype, _wide(x.dtype)
        di, dtr, st = mamba_dims(cfg)
        S = x.shape[1]
        xin, z = torch.split(x @ self.in_proj.to(dt_), di, dim=-1)
        A = -torch.exp(self.A_log.to(wide))
        K = cfg.ssm.d_conv
        if state is None or S > 1:
            xc = F.silu(_causal_conv(xin, self.conv_w, self.conv_b))
            conv = F.pad(xin, (0, 0, K - 1, 0))[:, -(K - 1):, :]
        else:
            xc, conv = _conv_step(xin[:, 0, :], state["conv"], self.conv_w, self.conv_b)
            xc = F.silu(xc)[:, None, :]
        proj = xc @ self.x_proj.to(dt_)
        delta = F.softplus((proj[..., :dtr] @ self.dt_w.to(dt_)).to(wide) + self.dt_b.to(wide))
        Bm, Cm = proj[..., dtr:dtr + st].to(wide), proj[..., dtr + st:].to(wide)
        y, h = _selective_scan(xc.to(wide), delta, A, Bm, Cm, cfg.ssm.chunk,
                               None if state is None else state["ssm"])
        y = (y + self.D.to(wide) * xc.to(wide)).to(dt_) * F.silu(z)
        new_state = None if state is None else {"conv": conv, "ssm": h}
        return y @ self.out_proj.to(dt_), new_state


def mamba_make_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, device=None) -> State:
    """A zero Mamba state: the conv tail (B, d_conv - 1, di) in ``dtype``, the scan's
    state (B, di, d_state) float32 (float64 for a float64 model)."""
    di, _, st = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, di, st), dtype=_wide(dtype), device=device),
    }


def mamba_state_struct(cfg: ModelConfig, batch: int, dtype: torch.dtype) -> State:
    """The state's shapes and dtypes on the ``meta`` device."""
    return mamba_make_state(cfg, batch, dtype, device="meta")


def mamba_state_logical_axes() -> Dict[str, Tuple]:
    return {"conv": ("batch", None, "mlp"), "ssm": ("batch", "mlp", "state")}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, chunkwise)


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(inner width rounded up to the heads, head width)."""
    di = int(cfg.ssm.proj_factor * cfg.d_model)
    di = -(-di // cfg.num_heads) * cfg.num_heads
    return di, di // cfg.num_heads


def _mlstm_chunkwise(q, k, v, log_f, i_gate, chunk: int,
                     carry0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     keep_carry: bool = True):
    """Chunkwise gated linear attention with matrix memory and normalizer.

    q, k, v (B, S, H, dh); log_f, i_gate (B, S, H).  Per head:
      C_t = f_t C_{t-1} + i_t k_t v_t^T,  n_t = f_t n_{t-1} + i_t k_t,
      h_t = (q_t C_t) / max(|q_t . n_t|, 1).
    Returns (h (B, S, H, dh), (C (B, H, dh, dh), n (B, H, dh)) or None).  The chunk
    state is computed only where a later chunk or ``keep_carry`` needs it; without
    ``carry0`` the first chunk skips the zero state's terms (adding them changes no
    value).
    """
    B, S, H, dh = q.shape
    bounds = chunk_bounds(S, chunk)
    C, n = carry0 if carry0 is not None else (None, None)
    hs = []
    for j, (s0, c) in enumerate(bounds):
        sl = slice(s0, s0 + c)
        qq, kk, vv, lf, ii = q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], i_gate[:, sl]
        L = torch.cumsum(lf, dim=1)                                   # (B, c, H)
        dec_q = torch.exp(L)                                          # chunk start to t
        # intra-chunk: A[t, s] = exp(L_t - L_s) i_s (q_t . k_s) for s <= t
        scores = torch.einsum("bthd,bshd->bhts", qq, kk)
        decay = L[:, :, None, :] - L[:, None, :, :]                   # (B, t, s, H)
        mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
        gates = torch.exp(torch.where(mask[None, :, :, None], decay,
                                      torch.full((), -math.inf, dtype=decay.dtype,
                                                 device=decay.device)))
        gates = gates.permute(0, 3, 1, 2)
        ig = ii.permute(0, 2, 1)[:, :, None, :]
        y = torch.einsum("bhts,bshd->bthd", scores * gates * ig, vv)
        n_tot = torch.einsum("bhts,bshd->bthd", gates * ig, kk)
        if C is not None:                                             # inter-chunk
            y = y + torch.einsum("bthd,bhde->bthe", qq * dec_q[..., None], C)
            n_tot = n_tot + dec_q[..., None] * n[:, None, :, :]
        denom = torch.maximum(torch.abs(torch.einsum("bthd,bthd->bth", qq, n_tot)),
                              torch.ones((), dtype=q.dtype, device=q.device))
        hs.append(y / denom[..., None])
        if j + 1 < len(bounds) or keep_carry:                         # state to chunk end
            Lc = L[:, -1:, :]
            w = torch.exp(Lc - L) * ii                                # (B, c, H)
            dec_c = torch.exp(Lc)[:, 0]                               # (B, H)
            kv = torch.einsum("bshd,bshe->bhde", kk * w[..., None], vv)
            kn = torch.einsum("bshd,bsh->bhd", kk, w)
            C = kv if C is None else dec_c[:, :, None, None] * C + kv
            n = kn if n is None else dec_c[:, :, None] * n + kn
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)
    return h, ((C, n) if keep_carry else None)


class MLSTM(nn.Module):
    """``init_mlstm`` / ``apply_mlstm``: up-projection, causal conv, block-diagonal q / k /
    v per head, sigmoid input and log-sigmoid forget gates, the chunkwise memory, then
    ``out_norm`` times ``silu(z)`` and the down-projection."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        di, dh = mlstm_dims(cfg)
        self.cfg = cfg
        self.up_proj = mk((d, 2 * di), ("embed", "mlp"))
        self.conv_w = mk((di, CONV_K), ("mlp", "conv"))
        self.conv_b = mk((di,), ("mlp",), init="zeros")
        self.wq = mk((H, dh, dh), ("heads", None, None))
        self.wk = mk((H, dh, dh), ("heads", None, None))
        self.wv = mk((H, dh, dh), ("heads", None, None))
        self.w_i = mk((di, H), ("mlp", "heads"))
        self.b_i = mk((H,), ("heads",), init="zeros")
        self.w_f = mk((di, H), ("mlp", "heads"))
        self.b_f = mk((H,), ("heads",), init="ones")
        self.out_norm = mk((di,), ("mlp",), init="ones")
        self.down_proj = mk((di, d), ("mlp", "embed"))

    def forward(self, x: torch.Tensor, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
        """x (B, S, d_model) -> (y, new state: None without ``state``)."""
        cfg = self.cfg
        dt_, wide = x.dtype, _wide(x.dtype)
        di, dh = mlstm_dims(cfg)
        H = cfg.num_heads
        B, S, _ = x.shape
        xu, z = torch.split(x @ self.up_proj.to(dt_), di, dim=-1)
        gate = lambda inp, w, b: (inp @ w.to(dt_)).to(wide) + b.to(wide)

        if state is None or S > 1:
            xc = F.silu(_causal_conv(xu, self.conv_w, self.conv_b))
            xch, xuh = xc.reshape(B, S, H, dh), xu.reshape(B, S, H, dh)
            q = torch.einsum("bshd,hde->bshe", xch, self.wq.to(dt_))
            k = torch.einsum("bshd,hde->bshe", xch, self.wk.to(dt_)) / math.sqrt(dh)
            v = torch.einsum("bshd,hde->bshe", xuh, self.wv.to(dt_))
            log_f = F.logsigmoid(gate(xc, self.w_f, self.b_f))
            i_gate = torch.sigmoid(gate(xc, self.w_i, self.b_i))
            carry0 = None if state is None else (state["C"], state["n"])
            h, carry = _mlstm_chunkwise(q.to(wide), k.to(wide), v.to(wide), log_f, i_gate,
                                        cfg.ssm.mlstm_chunk, carry0, state is not None)
            h = h.reshape(B, S, di).to(dt_)
            new_state = None
            if state is not None:
                conv = F.pad(xu, (0, 0, CONV_K - 1, 0))[:, -(CONV_K - 1):, :]
                new_state = {"conv": conv, "C": carry[0], "n": carry[1]}
        else:
            x_t = xu[:, 0, :]
            xc_t, conv = _conv_step(x_t, state["conv"], self.conv_w, self.conv_b)
            xc_t = F.silu(xc_t)
            xch, xuh = xc_t.reshape(B, H, dh), x_t.reshape(B, H, dh)
            q = torch.einsum("bhd,hde->bhe", xch, self.wq.to(dt_)).to(wide)
            k = torch.einsum("bhd,hde->bhe", xch, self.wk.to(dt_)).to(wide) / math.sqrt(dh)
            v = torch.einsum("bhd,hde->bhe", xuh, self.wv.to(dt_)).to(wide)
            f = torch.sigmoid(gate(xc_t, self.w_f, self.b_f))
            ig = torch.sigmoid(gate(xc_t, self.w_i, self.b_i))
            Cm = f[:, :, None, None] * state["C"] + ig[:, :, None, None] * torch.einsum(
                "bhd,bhe->bhde", k, v)
            n = f[:, :, None] * state["n"] + ig[:, :, None] * k
            denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                                  torch.ones((), dtype=wide, device=x.device))
            h = (torch.einsum("bhd,bhde->bhe", q, Cm) / denom[..., None]).reshape(
                B, 1, di).to(dt_)
            new_state = {"conv": conv, "C": Cm, "n": n}

        h = rmsnorm(h, self.out_norm, cfg.rms_eps) * F.silu(z)
        return h @ self.down_proj.to(dt_), new_state


def mlstm_make_state(cfg: ModelConfig, batch: int, dtype: torch.dtype, device=None) -> State:
    """A zero mLSTM state: the conv tail in ``dtype``, the memory float32 (float64 for a
    float64 model)."""
    di, dh = mlstm_dims(cfg)
    H, wide = cfg.num_heads, _wide(dtype)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, di), dtype=dtype, device=device),
        "C": torch.zeros((batch, H, dh, dh), dtype=wide, device=device),
        "n": torch.zeros((batch, H, dh), dtype=wide, device=device),
    }


def mlstm_state_struct(cfg: ModelConfig, batch: int, dtype: torch.dtype) -> State:
    """The state's shapes and dtypes on the ``meta`` device."""
    return mlstm_make_state(cfg, batch, dtype, device="meta")


def mlstm_state_logical_axes() -> Dict[str, Tuple]:
    return {
        "conv": ("batch", None, "mlp"),
        "C": ("batch", "heads", None, None),
        "n": ("batch", "heads", None),
    }


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, step scan)


class SLSTM(nn.Module):
    """``init_slstm`` / ``apply_slstm``: exp-gated scalar memory with per-head recurrent
    weights ``r_*`` and the m-stabilizer, then ``out_norm`` and a 4/3 gated FFN."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        dh = d // H
        self.cfg = cfg
        for g in SLSTM_GATES:
            setattr(self, f"w_{g}", mk((d, d), ("embed", "mlp")))
            setattr(self, f"r_{g}", mk((H, dh, dh), ("heads", None, None), scale=0.01))
            setattr(self, f"b_{g}", mk((d,), ("mlp",), init="ones" if g == "f" else "zeros"))
        self.out_norm = mk((d,), ("embed_act",), init="ones")
        f = -(-4 * d // 3 // 8) * 8
        self.ffn_gate = mk((d, f), ("embed", "mlp"))
        self.ffn_up = mk((d, f), ("embed", "mlp"))
        self.ffn_down = mk((f, d), ("mlp", "embed"))

    def forward(self, x: torch.Tensor, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
        """x (B, S, d_model) -> (y, new state: None without ``state``)."""
        cfg = self.cfg
        dt_, wide = x.dtype, _wide(x.dtype)
        d, H = cfg.d_model, cfg.num_heads
        dh = d // H
        B, S, _ = x.shape
        cat = lambda name, dim: torch.cat([getattr(self, f"{name}_{g}") for g in SLSTM_GATES],
                                          dim=dim)
        # the four gates side by side, head-major (S, H, B, 4 dh) as the recurrent product
        # (H, B, dh) @ (H, dh, 4 dh) gives them: one product and add a step
        pre = ((x @ cat("w", 1).to(dt_)).to(wide) + cat("b", 0).to(wide)).reshape(
            B, S, 4, H, dh).permute(1, 3, 0, 2, 4).reshape(S, H, B, 4 * dh)
        R = cat("r", -1).to(wide)
        one = torch.ones((), dtype=wide, device=x.device)
        if state is None:
            h = c = n = m = torch.zeros((H, B, dh), dtype=wide, device=x.device)
        else:
            h, c, n, m = (state[k].transpose(0, 1) for k in ("h", "c", "n", "m"))
        hs = []
        for pre_t in pre.unbind(0):
            it, ft, zt, ot = torch.split(torch.baddbmm(pre_t, h, R), dh, dim=-1)
            zt, ot = torch.tanh(zt), torch.sigmoid(ot)
            fm = ft + m
            m_new = torch.maximum(fm, it)
            i_e = torch.exp(it - m_new)
            f_e = torch.exp(fm - m_new)
            c = f_e * c + i_e * zt
            n = f_e * n + i_e
            h = ot * c / torch.maximum(torch.abs(n), one)
            m = m_new
            hs.append(h)
        y = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, S, d).to(dt_)
        new_state = None if state is None else {
            k: v.transpose(0, 1) for k, v in (("h", h), ("c", c), ("n", n), ("m", m))}
        y = rmsnorm(y, self.out_norm, cfg.rms_eps)
        u = F.silu(y @ self.ffn_gate.to(dt_)) * (y @ self.ffn_up.to(dt_))
        return y + u @ self.ffn_down.to(dt_), new_state


def slstm_make_state(cfg: ModelConfig, batch: int, device=None,
                     dtype: torch.dtype = torch.float32) -> State:
    """A zero sLSTM state, float32 (float64 for a float64 model)."""
    H = cfg.num_heads
    return {k: torch.zeros((batch, H, cfg.d_model // H), dtype=_wide(dtype), device=device)
            for k in ("h", "c", "n", "m")}


def slstm_state_struct(cfg: ModelConfig, batch: int) -> State:
    return slstm_make_state(cfg, batch, device="meta")


def slstm_state_logical_axes() -> Dict[str, Tuple]:
    return {k: ("batch", "heads", None) for k in ("h", "c", "n", "m")}
