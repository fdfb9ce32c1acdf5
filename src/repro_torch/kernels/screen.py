"""Screening verdicts and tile flags (paper Eq. 6/7): CUDA kernel K1 + plain version.

Counterpart of ``repro.kernels.screen.screen_pallas``, which the JAX solver
vmaps over the problem axis; here one kernel covers the B axis.  Per entry

  z_bar = z~ + ||[d_alpha_[l]]_+|| + sqrt(g_l) [d_beta_j]_+
  z_low = k~ - ||d_alpha_[l]|| - sqrt(g_l)|d_beta_j| - o~ - ||[d_alpha_[l]]_-||
          - sqrt(g_l)[-d_beta_j]_+
  verdict = ACTIVE in N, ZERO where z_bar <= tau_l, ACTIVE where a CHECK
            entry has z_low > tau_l, CHECK otherwise,

and a tile's flag is 1 unless every entry of it is ZERO.  With
``emit_verdict=False`` only the flags are written.  The CUDA source is
``csrc/screen.cu``; see its opening note for the design.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.screening import ACTIVE, CHECK, ZERO
from repro_torch.kernels import _build
from repro_torch.kernels.gradpsi import _record_launch, tau_row


def screen_batched_ref(z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g, *, tau,
                       tile_l: int, tile_n: int, emit_verdict: bool = True):
    """Plain version of K1, in exactly the kernel's (and ``_verdict_tile``'s) op order.

    z, k, o (B, L_pad, n_pad) f32; act (B, L_pad, n_pad) int8; da_* and
    sqrt_g (B, L_pad); db (B, n_pad); tau scalar or (L_pad,).  Returns
    (verdict (B, L_pad, n_pad) int32 or None, flags (B, Lt, Nt) int32).
    """
    B, L, n = z.shape
    tau_c = tau_row(tau, L, z.device)[:, None]
    dap, daf, dan, sg = (x[..., :, None] for x in (da_plus, da_full, da_neg, sqrt_g))
    dbr = db[..., None, :]
    zbar = z + dap + sg * torch.clamp_min(dbr, 0.0)
    zlow = k - daf - sg * torch.abs(dbr) - o - dan - sg * torch.clamp_min(-dbr, 0.0)
    v = torch.where(zbar <= tau_c, ZERO, CHECK)
    v = torch.where(act != 0, ACTIVE, v)
    v = torch.where(torch.logical_and(v == CHECK, zlow > tau_c), ACTIVE, v).to(torch.int32)
    vt = v.reshape(B, L // tile_l, tile_l, n // tile_n, tile_n)
    flags = torch.any(torch.any(vt != ZERO, dim=-1), dim=-2).to(torch.int32)
    return (v if emit_verdict else None), flags


def screen_batched(z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g, *, tau,
                   tile_l: int, tile_n: int,
                   emit_verdict: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K1: batched screening kernel; plain version for CPU tensors."""
    if not z.is_cuda:
        return screen_batched_ref(z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g,
                                  tau=tau, tile_l=tile_l, tile_n=tile_n,
                                  emit_verdict=emit_verdict)
    B, L_pad, n_pad = z.shape
    if L_pad % tile_l or n_pad % tile_n:
        raise ValueError(f"(L_pad={L_pad}, n_pad={n_pad}) not multiples of "
                         f"({tile_l}, {tile_n})")
    if not 1 <= tile_n <= 1024:
        raise ValueError(f"tile_n={tile_n}: one thread per column, at most 1024")
    tau_g = tau_row(tau, L_pad, z.device)
    expect = {
        "z": (z, torch.float32, (B, L_pad, n_pad)),
        "k": (k, torch.float32, (B, L_pad, n_pad)),
        "o": (o, torch.float32, (B, L_pad, n_pad)),
        "act": (act, torch.int8, (B, L_pad, n_pad)),
        "da_plus": (da_plus, torch.float32, (B, L_pad)),
        "da_full": (da_full, torch.float32, (B, L_pad)),
        "da_neg": (da_neg, torch.float32, (B, L_pad)),
        "db": (db, torch.float32, (B, n_pad)),
        "sqrt_g": (sqrt_g, torch.float32, (B, L_pad)),
        "tau": (tau_g, torch.float32, (L_pad,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != z.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {z.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    flags = torch.empty((B, L_pad // tile_l, n_pad // tile_n), dtype=torch.int32,
                        device=z.device)
    verdict = (torch.empty((B, L_pad, n_pad), dtype=torch.int32, device=z.device)
               if emit_verdict else None)
    lib = _build.library()
    err = lib.screen_launch(
        z.data_ptr(), k.data_ptr(), o.data_ptr(), act.data_ptr(), da_plus.data_ptr(),
        da_full.data_ptr(), da_neg.data_ptr(), db.data_ptr(), sqrt_g.data_ptr(),
        tau_g.data_ptr(), flags.data_ptr(), None if verdict is None else verdict.data_ptr(),
        B, L_pad, n_pad, tile_l, tile_n, _build.stream_handle(z.device))
    _build.check(err, "screen_launch")
    _record_launch("screen_batched")
    return verdict, flags
