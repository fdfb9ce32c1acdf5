"""Screening (paper Eq. 6/7) and snapshot norms: CUDA kernels K1 and K4 + plain versions.

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

K4, :func:`snapshot_norms_fact_batched`, replaces
``repro.kernels.screen.snapshot_norms_fact_pallas``: the snapshot norms
z~ = ||[f]_+||, k~ = ||f||, o~ = ||[f]_-|| per group with the cost rebuilt
from samples and padded group members masked before the sums (at d <= 2
``snapshot_reg_kernel``, from registers and one staging of the real rows
per CTA; above, the chunked loader).  The chunked kernel's body over the
dense cost, :func:`snapshot_norms_dense_batched`, takes the dense route's
snapshots.  Both sum the members in order, as the
plain ``core.dual.snapshot_norms``, so the two routes and the plain
versions give the same bits (``csrc/snapshot.cu``).  The cost may be
stored in bf16 (``precision='bf16'``): the kernel upcasts each value on
load, the plain versions with ``.float()``, so the snapshots bound exactly
the rounded cost the gradient kernels integrate.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.dual import member_norms
from repro_torch.core.screening import ACTIVE, CHECK, ZERO
from repro_torch.kernels import _build
from repro_torch.kernels.gradpsi import (
    CTA_SMEM_BUDGET_BYTES,
    FACT_REG_D,
    _check_cuda_inputs,
    _check_screen_operands,
    d_chunk,
    factorized_cost_tile,
    tau_row,
)


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
    _check_screen_operands(z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g, tau_g)
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
    _build.record_launch("screen_batched")
    return verdict, flags


# -- K4: snapshot norms ------------------------------------------------------

def snapshot_norms_dense_ref(alpha, beta, C, mask, *, num_groups: int, group_size: int):
    """Plain snapshot norms on a dense cost.

    alpha (B, L_pad*g), beta (B, n_pad), C (B, L_pad*g, n_pad) f32 or bf16
    (upcast first), mask (L_pad*g,) shared by the batch or (B, L_pad*g) per
    problem, nonzero on real rows -> (z~, k~, o~) each (B, L_pad, n_pad).
    """
    F = alpha[..., :, None] + beta[..., None, :] - C.float()
    return member_norms(F, mask != 0, num_groups, group_size)


def snapshot_norms_fact_ref(alpha, beta, x, x_sq, y, y_sq, mask, *, num_groups: int,
                            group_size: int):
    """Plain version of K4: the cost rebuilt by ``factorized_cost_tile``, then the dense norms."""
    return snapshot_norms_dense_ref(alpha, beta, factorized_cost_tile(x, x_sq, y, y_sq), mask,
                                    num_groups=num_groups, group_size=group_size)


def snapshot_loader_dc(tile_l: int, g: int, tile_n: int, d: int) -> int:
    """The ``dc`` argument of K4's launch: 0 for ``snapshot_reg_kernel`` (``d <=
    FACT_REG_D``, one group's records, real-row count and mask in shared
    memory), else the chunked loader's :func:`d_chunk`."""
    if d <= FACT_REG_D and 17 * g + 4 <= CTA_SMEM_BUDGET_BYTES:
        return 0
    return d_chunk(tile_l, g, tile_n, d)


def _snapshot_checks(alpha, beta, mask, num_groups, group_size, tile_l, tile_n):
    B, n_pad = beta.shape
    L_pad, g = num_groups, group_size
    if L_pad % tile_l or n_pad % tile_n:
        raise ValueError(f"(L_pad={L_pad}, n_pad={n_pad}) not multiples of "
                         f"({tile_l}, {tile_n})")
    if not 1 <= tile_n <= 1024:
        raise ValueError(f"tile_n={tile_n}: one thread per column, at most 1024")
    if tuple(alpha.shape) != (B, L_pad * g):
        raise ValueError(f"alpha {tuple(alpha.shape)} != {(B, L_pad * g)}")
    if tuple(mask.shape) not in ((L_pad * g,), (B, L_pad * g)) or mask.dtype != torch.int8 \
            or mask.device != alpha.device or not mask.is_contiguous():
        raise ValueError(f"mask: expected contiguous int8 {(L_pad * g,)} or "
                         f"{(B, L_pad * g)} on {alpha.device}, got {tuple(mask.shape)}")
    stride = 0 if mask.dim() == 1 else L_pad * g
    kw = dict(dtype=torch.float32, device=alpha.device)
    return B, n_pad, stride, tuple(torch.empty((B, L_pad, n_pad), **kw) for _ in range(3))


def snapshot_norms_dense_batched(alpha, beta, C, mask, *, num_groups: int, group_size: int,
                                 tile_l: int, tile_n: int):
    """K4's body on the dense cost (f32 or bf16): (z~, k~, o~) each (B, L_pad, n_pad)."""
    if not alpha.is_cuda:
        return snapshot_norms_dense_ref(alpha, beta, C, mask, num_groups=num_groups,
                                        group_size=group_size)
    B, n_pad, stride, (z, k, o) = _snapshot_checks(alpha, beta, mask, num_groups, group_size,
                                                   tile_l, tile_n)
    if tuple(C.shape) != (B, num_groups * group_size, n_pad):
        raise ValueError(f"C {tuple(C.shape)} != {(B, num_groups * group_size, n_pad)}")
    code = _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta)), (),
                              (("C", C),))
    err = _build.library().snapshot_dense_launch(
        alpha.data_ptr(), beta.data_ptr(), C.data_ptr(), mask.data_ptr(), z.data_ptr(),
        k.data_ptr(), o.data_ptr(), B, stride, num_groups, group_size, n_pad, tile_l, tile_n,
        code, _build.stream_handle(alpha.device))
    _build.check(err, "snapshot_dense_launch")
    _build.record_launch("snapshot_norms_dense_batched")
    return z, k, o


def snapshot_norms_fact_batched(alpha, beta, x, x_sq, y, y_sq, mask, *, num_groups: int,
                                group_size: int, tile_l: int, tile_n: int):
    """K4: snapshot norms on the factorized cost, (z~, k~, o~) each (B, L_pad, n_pad).

    x (B, L_pad*g, d), x_sq (B, L_pad*g), y (B, n_pad, d), y_sq (B, n_pad),
    all f32 or all bf16; the int8 row mask is (L_pad*g,), shared by the
    batch, or (B, L_pad*g), one row per problem (the kernel's mask stride).
    """
    if not alpha.is_cuda:
        return snapshot_norms_fact_ref(alpha, beta, x, x_sq, y, y_sq, mask,
                                       num_groups=num_groups, group_size=group_size)
    B, n_pad, stride, (z, k, o) = _snapshot_checks(alpha, beta, mask, num_groups, group_size,
                                                   tile_l, tile_n)
    m_pad, d = num_groups * group_size, x.shape[-1]
    want = {"x": (B, m_pad, d), "x_sq": (B, m_pad), "y": (B, n_pad, d), "y_sq": (B, n_pad)}
    for name, t in (("x", x), ("x_sq", x_sq), ("y", y), ("y_sq", y_sq)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {want[name]}")
    code = _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta)), (),
                              (("x", x), ("x_sq", x_sq), ("y", y), ("y_sq", y_sq)))
    err = _build.library().snapshot_fact_launch(
        alpha.data_ptr(), beta.data_ptr(), x.data_ptr(), x_sq.data_ptr(), y.data_ptr(),
        y_sq.data_ptr(), mask.data_ptr(), z.data_ptr(), k.data_ptr(), o.data_ptr(), B, stride,
        num_groups, group_size, n_pad, d, snapshot_loader_dc(tile_l, group_size, tile_n, d),
        tile_l, tile_n, code, _build.stream_handle(alpha.device))
    _build.check(err, "snapshot_fact_launch")
    _build.record_launch("snapshot_norms_fact_batched")
    return z, k, o
