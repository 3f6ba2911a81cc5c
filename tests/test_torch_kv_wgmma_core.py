"""kv_shuttle.cu's Hopper ``wgmma`` core, its Python side, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu_kv_shuttle.py``).
Here: which core a launch takes, decided by the operands alone (aligned
projections on ``wgmma``; unaligned ones on ``mma_sync``; ``pure`` on the row
copy), on the shapes the card tests use; the op recorder's round order at the
core's 128-row tiles (``_units``, ``check_log``) against a brute-force
enumeration of the tiles; and a plain emulation of the core's swapped 3xTF32
arithmetic (``csrc/wg_tile.cuh``) at the KV cell's depth, K = 4096, against
float64 and the cell's ``row_rel_err`` limit.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_shuttle as kv
from repro_torch.kernels import window

# tests/test_torch_gpu_kv_shuttle.py's shapes (T, d, dk)
GPU_SHAPES = [(256, 128, 64), (200, 96, 40), (130, 67, 65), (4096, 512, 128),
              (192, 100, 200), (320, 36, 12)]
KV_CELL_LIMIT = 5e-5       # bench/checks/mistral-7b-kv.prefill_handoff.json


# ------------------------------------------------------------ the core's choice


@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_aligned_projections_take_the_wgmma_core(shape):
    T, d, dk = shape
    x, w = torch.zeros((2, T, d)), torch.zeros((d, dk))
    want = "wgmma" if d % 4 == 0 and dk % 4 == 0 else "mma_sync"
    assert kv.core_for(x, w, w) == want
    assert kv.core_for(x, pure=True) == "copy"


def test_an_unaligned_base_takes_the_mma_sync_core():
    x = torch.zeros(2 * 256 * 128 + 1)[1:].view(2, 256, 128)
    w = torch.zeros((128, 64))
    assert kv.core_for(x, w, w) == "mma_sync"
    assert kv.core_for(torch.zeros((2, 256, 128)), w, w) == "wgmma"


def test_every_core_names_a_kernel_and_a_tile():
    assert sorted(kv.CORE_IDS.values()) == [0, 1, 2]
    assert kv.TILE_ROWS == {"wgmma": 128, "mma_sync": 64}
    kv.CORE_LAUNCHES["wgmma"] += 1
    kv.reset_launches()
    assert not kv.CORE_LAUNCHES


# ------------------------------------------------------------ the round order


def _brute_order(rows, width, kv_chunk, fused, bm):
    """Every (half, m-tile, column tile) of the two projections, sorted by
    the contract: unfused, all of K (row-major over tiles), then all of V;
    fused, by row group (kv_chunk rows when that is a multiple of the tile
    height, else one tile), K before V within a group."""
    tiles = [(h, mt, ct) for h in (0, 1) for mt in range(-(-rows // bm))
             for ct in range(-(-width // 128))]
    if not fused:
        return sorted(tiles)
    group = kv_chunk if kv_chunk % bm == 0 else bm
    return sorted(tiles, key=lambda t: (t[1] * bm // group, t[0], t[1], t[2]))


def _synth_log(rounds_per_cta, contexts, recv_per_cta):
    """A probe log as the card writes it (push, retire past the cap,
    drain, then the decode CTA's receives)."""
    rows = []
    for rounds, recv in zip(rounds_per_cta, recv_per_cta):
        evs, depth = [], 0
        for edge, tile in rounds:
            if depth == contexts:
                evs.append([window.EV_RETIRE, 0, 0, 0])
                depth -= 1
            evs.append([window.EV_PUSH, edge, tile, 0])
            depth += 1
        evs += [[window.EV_RETIRE, 0, 0, 0]] * depth
        evs.append([window.EV_DRAIN, 0, 0, 0])
        evs += [[window.EV_RECV, e, c, 0] for e, c in recv]
        rows.append(evs)
    cap = max(len(r) for r in rows)
    events = torch.zeros((len(rows), cap, 4), dtype=torch.int32)
    for i, r in enumerate(rows):
        events[i, :len(r)] = torch.tensor(r, dtype=torch.int32)
    counts = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    return window.decode(events, counts)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv_chunk", [32, 64, 1024])
def test_round_order_at_128_row_tiles(fused, kv_chunk):
    rows, width, grid, contexts = 2048, 256, 5, 2
    want = _brute_order(rows, width, kv_chunk, fused, 128)
    assert kv._units(rows, width, kv_chunk if fused else rows, fused, False,
                     1) == [h for h, _, _ in want]
    if fused:   # chunk c complete no later than chunk c + 1
        last = {}
        for pos, (_, mt, _) in enumerate(want):
            for c in range(mt * 128 // kv_chunk,
                           (mt * 128 + 127) // kv_chunk + 1):
                last[c] = pos
        assert [last[c] for c in sorted(last)] == sorted(last.values())
    order = [(h, u) for u, (h, _, _) in enumerate(want)]
    # the decode CTA: one receive a chunk (a K / V pair)
    recv = [(0, c) for c in range(rows // (kv_chunk if fused else rows))]
    events = _synth_log([order[pid::grid - 1] for pid in range(grid - 1)]
                        + [[]], contexts, [[]] * (grid - 1) + [recv])
    meta = dict(rows=rows, width=width, pure=False, unit_rows=1, grid=grid,
                contexts=contexts, chained=True, fused=fused, counter=fused,
                kv_chunk=kv_chunk if fused else None)
    got = kv.check_log(events, **meta)
    assert got["rounds"] == len(want)
    with pytest.raises(window.WindowLogError):   # the 64-row order
        kv.check_log(events, core="mma_sync", **meta)


# ------------------------------------------------------------ the arithmetic


def _tf32(a):
    """hi: a rounded to TF32 (half an ulp added to the magnitude, the 13
    low bits cleared), as mma.cuh's split_tf32."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _read(a):
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _add_rz(acc, p):
    """acc + p in float32, rounded toward zero (the tensor core's sum)."""
    exact = acc.double() + p
    got = exact.float()
    over = got.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(got, torch.zeros_like(got)),
                       got)


def _swapped_3xtf32(x, w, part_depth=128, drop=None):
    """C = x w as the wgmma core computes it, transposed: A = w^T split in
    registers, B = x^T split once (hi rounded in place, lo = x - hi); each
    8-deep k step adds w_lo x_hi, w_hi x_lo, w_hi x_hi (small terms first)
    into a partial through the tensor core's truncating sum; every
    ``part_depth`` the partial joins the f32 sum (round to nearest).
    ``drop`` leaves one product out."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = x - xh, w - wh
    terms = [("lo_hi", _read(wl), xh), ("hi_lo", wh, _read(xl)),
             ("hi_hi", wh, xh)]
    terms = [(a, b) for name, a, b in terms if name != drop]
    acc = torch.zeros((x.shape[0], w.shape[1]))
    part = torch.zeros_like(acc)
    for k0 in range(0, x.shape[1], 8):
        for a, b in terms:
            part = _add_rz(part, b[:, k0:k0 + 8].double()
                           @ a[k0:k0 + 8].double())
        if (k0 + 8) % part_depth == 0 or k0 + 8 >= x.shape[1]:
            acc = acc + part
            part = torch.zeros_like(acc)
    return acc


def _row_rel_err(got, want):
    return float(((got.double() - want).norm(dim=-1)
                  / want.norm(dim=-1)).max())


@pytest.fixture(scope="module")
def kv_cell_operands():
    """The KV cell's depth and weight scale (d 4096, normal / sqrt(d)),
    cut to 32 token rows and 32 columns."""
    rng = np.random.default_rng(30)
    d = 4096
    x = torch.from_numpy(rng.standard_normal((32, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, 32)) / math.sqrt(d))
                         .astype(np.float32))
    return x, w, x.double() @ w.double()


def test_the_split_rounds_hi_and_keeps_lo_exact(kv_cell_operands):
    x, w, _ = kv_cell_operands
    for a in (x, w):
        hi = _tf32(a)
        assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
        lo = a - hi
        assert torch.equal(hi.double() + lo.double(), a.double())
        assert bool((lo.abs() <= a.abs() * 2.0 ** -11).all())


def test_swapped_3xtf32_meets_the_kv_cells_limit(kv_cell_operands):
    x, w, want = kv_cell_operands
    err = _row_rel_err(_swapped_3xtf32(x, w), want)
    assert err < KV_CELL_LIMIT / 10, err


@pytest.mark.parametrize("drop", ["lo_hi", "hi_lo"])
def test_a_dropped_product_fails_the_kv_cells_limit(kv_cell_operands, drop):
    x, w, want = kv_cell_operands
    err = _row_rel_err(_swapped_3xtf32(x, w, drop=drop), want)
    assert err > KV_CELL_LIMIT, err
