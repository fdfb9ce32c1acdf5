"""The gradient kernels' reductions, modelled in float32 on the CPU.

gradpsi.cu sums a tile's row values over a warp by a reduce-scatter (each
xor step keeps half of the rows, 16 shuffles for 16 rows), and its slot
reduction skips the slots of dead tiles, which it leaves uninitialized.
After the compact kernel it learns which tiles are live from marks the
kernel writes into uninitialized memory, checked against the schedule.
The bits the main path's fingerprints hold were taken with the xor
butterfly ``rt::warp_sum`` run once per row and with a sum over
zero-filled slots, so both must give those orders' bits.  These tests
model each order in plain float32 PyTorch (one add at a time, as the
kernels round) and check that on seeded inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gradpsi as tgp

LANES, ROWS = 32, 16


def butterfly(v: torch.Tensor) -> torch.Tensor:
    """``rt::warp_sum`` on each column of ``v`` (32 lanes, R): v += shfl_xor(v, off)."""
    lane = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lane ^ off]
    return v


def reduce_scatter(v: torch.Tensor) -> torch.Tensor:
    """gradpsi.cu's ``warp_sums16`` on v (32 lanes, 16 rows) -> (32,): lane l's result."""
    lane = torch.arange(LANES)
    v = v.clone()
    h = ROWS // 2
    for off in (16, 8, 4, 2):
        hi = ((lane & off) != 0)[:, None]
        send = torch.where(hi, v[:, :h], v[:, h:2 * h])
        keep = torch.where(hi, v[:, h:2 * h], v[:, :h])
        v = keep + send[lane ^ off]                 # own half plus the partner's copy
        h //= 2
    out = v[:, 0]
    return out + out[lane ^ 1]


def _rows(rng, kind):
    """(32 lanes, 16 rows) of float32 whose sum depends on the order of the adds."""
    if kind == "wide":
        v = rng.normal(size=(LANES, ROWS)) * 10.0 ** rng.integers(-8, 8, (LANES, ROWS))
    elif kind == "sparse":
        v = np.where(rng.random((LANES, ROWS)) < 0.2, rng.normal(size=(LANES, ROWS)), 0.0)
        v[rng.random((LANES, ROWS)) < 0.1] = -0.0
    else:                     # the body's row values: T = s [f]_+ / gamma >= 0
        v = rng.exponential(size=(LANES, ROWS)) * (rng.random((LANES, ROWS)) < 0.6)
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("kind", ["wide", "sparse", "plan"])
def test_reduce_scatter_gives_the_butterfly_bits(kind):
    rng = np.random.default_rng({"wide": 0, "sparse": 1, "plan": 2}[kind])
    differs_from_sequential = 0
    for _ in range(200):
        v = _rows(rng, kind)
        want = butterfly(v)                         # every lane holds each row's sum
        got = reduce_scatter(v)
        lane = torch.arange(LANES)
        assert torch.equal(got.view(torch.int32), want[lane, lane >> 1].view(torch.int32))
        seq = torch.zeros(ROWS)
        for l in range(LANES):
            seq = seq + v[l]
        differs_from_sequential += int(not torch.equal(seq, want[0]))
    if kind == "wide":        # the inputs do tell summation orders apart
        assert differs_from_sequential > 100


def _ordered(part: torch.Tensor, live: torch.Tensor = None) -> torch.Tensor:
    """Sum part (B, S, I) over S in ascending order, one f32 add at a time, from +0;
    with ``live`` (B, S, I) only the live slots."""
    acc = torch.zeros(part.shape[0], part.shape[2])
    for s in range(part.shape[1]):
        nxt = acc + part[:, s]
        acc = nxt if live is None else torch.where(live[:, s], nxt, acc)
    return acc


def _slot_case(rng, flags_kind, B=2, Lt=5, Nt=7, tile_l=2, g=3, tile_n=4):
    """Slots a gradient call leaves behind: live tiles' values, garbage where dead."""
    m_pad, n_pad = Lt * tile_l * g, Nt * tile_n
    flags = {"random": rng.random((B, Lt, Nt)) < 0.4, "dead": np.zeros((B, Lt, Nt), bool),
             "live": np.ones((B, Lt, Nt), bool)}[flags_kind]
    big = lambda shape: (rng.normal(size=shape) * 10.0 ** rng.integers(-6, 6, shape))
    ga, gb, ps = big((B, Nt, m_pad)), big((B, Lt, n_pad)), big((B, Lt, Nt))
    ga[rng.random(ga.shape) < 0.1] = -0.0
    live_ga = np.repeat(flags.transpose(0, 2, 1), tile_l * g, axis=2)         # (B, Nt, m_pad)
    live_gb = np.repeat(flags, tile_n, axis=2)                                 # (B, Lt, n_pad)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    zero_filled = tuple(t(np.where(m, x, 0.0)) for x, m in ((ga, live_ga), (gb, live_gb),
                                                             (ps, flags)))
    garbage = tuple(t(np.where(m, x, np.nan)) for x, m in ((ga, live_ga), (gb, live_gb),
                                                           (ps, flags)))
    lives = tuple(torch.from_numpy(m) for m in (live_ga, live_gb, flags))
    return zero_filled, garbage, lives


@pytest.mark.parametrize("flags_kind", ["random", "dead", "live"])
def test_skipping_dead_slots_gives_the_zero_filled_bits(flags_kind):
    rng = np.random.default_rng(5)
    for _ in range(20):
        (ga0, gb0, ps0), (ga, gb, ps), (lga, lgb, lps) = _slot_case(rng, flags_kind)
        B = ga.shape[0]
        # zero-filled slots, every slot added in ascending order; psi over lt,
        # then over jt
        want = (_ordered(ga0), _ordered(gb0),
                _ordered(_ordered(ps0).reshape(B, -1, 1)).reshape(B))
        # slot_reduce_kernel: the same order over the live slots only
        got = (_ordered(ga, lga), _ordered(gb, lgb),
               _ordered(_ordered(ps, lps).reshape(B, -1, 1)).reshape(B))
        for x, y in zip(got, want):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        # and the plain version's torch.sum (another order) within the float32
        # error bound of any order: (terms - 1) u sum |x|
        u = 2.0 ** -24
        bounds = ((ga0.shape[1] - 1) * u * ga0.abs().sum(1), (gb0.shape[1] - 1) * u *
                  gb0.abs().sum(1), (ps0[0].numel() - 1) * u * ps0.abs().sum((1, 2)))
        for x, y, e in zip(got, tgp._reduce_slots_ref(ga0, gb0, ps0), bounds):
            assert bool(((x.double() - y.double()).abs() <= 2 * e.double()).all())
        if flags_kind == "dead":
            assert all(not bool(x.view(torch.int32).any()) for x in got)   # +0 everywhere


def _marked_live(mark, sched, num_active, Lt, Nt):
    """slot_reduce_kernel's ``tile_live`` after the compact kernel: tile t is
    live if its mark s, read as unsigned, is below num_active and schedule
    entry s is tile t."""
    s = mark.long()
    ok = (s >= 0) & (s < num_active)
    ids = (sched[0].long() * Lt + sched[1].long()) * Nt + sched[2].long()
    return ok & (ids[s.clamp(0, ids.numel() - 1)] == torch.arange(mark.numel()))


@pytest.mark.parametrize("held", ["random", "stale", "small"])
@pytest.mark.parametrize("flags_kind", ["random", "dead", "live"])
def test_compact_marks_give_exactly_the_scheduled_tiles(flags_kind, held):
    """Whatever the marks' memory held, the tiles taken as live are the
    schedule's: a mark can pass only by naming an entry that holds its tile."""
    rng = np.random.default_rng(7)
    B, Lt, Nt = 2, 5, 7
    BT = B * Lt * Nt
    for _ in range(20):
        flags = torch.from_numpy({"random": rng.random((B, Lt, Nt)) < 0.4,
                                  "dead": np.zeros((B, Lt, Nt), bool),
                                  "live": np.ones((B, Lt, Nt), bool)}[flags_kind]).int()
        sched, nact = tgp.build_batch_tile_schedule(flags)
        if held == "random":
            mark = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, BT).astype(np.int32))
        elif held == "small":          # every value names a real schedule entry
            mark = torch.from_numpy(rng.integers(0, max(int(nact), 1), BT).astype(np.int32))
        else:                          # another call's marks: every tile was scheduled
            other, _ = tgp.build_batch_tile_schedule(torch.ones_like(flags))
            mark = torch.empty(BT, dtype=torch.int32)
            ids = (other[0].long() * Lt + other[1].long()) * Nt + other[2].long()
            mark[ids] = torch.arange(BT, dtype=torch.int32)
        for s in range(int(nact)):     # gradpsi_compact_kernel: entry s marks its tile
            mark[(int(sched[0, s]) * Lt + int(sched[1, s])) * Nt + int(sched[2, s])] = s
        live = _marked_live(mark, sched, int(nact), Lt, Nt)
        assert torch.equal(live, flags.reshape(-1) != 0)
