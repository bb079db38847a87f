"""K4's and K5's staged-tile decisions on the CPU.

No card and no JAX here.  ``tiles.staged_share`` (K4) and
``tiles.grads_staged_share`` (K5) must count the tiles that stage their
corner box exactly as a loop over the kernels' tiles does
(``csrc/gather_tiles.cu``): K4 per ``tile_rows(C) x 32`` tile, where the
plane's rows are whole 128-byte chunks, a box that lies in the window K4
copies (``tile_rows(C) + 3`` rows of the chunks that 35 cells can span,
from the chunk of the box's first float); K5 per 8 x 32 tile, ``rows * cols * C`` floats within ``GRADS_BOX_FLOATS``.  Starts are
clamped to [0, size-2] first, the int32 extremes that NaN coordinates turn
into included.
"""

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.ops.kernels import tiles
from tests.test_torch_port_cuda import window_maps

torch.set_num_threads(2)


def _boxes(v0, u0, H, W, th):
    """(b, vmin, vmax, umin, umax) of the clamped starts of every th x 32
    tile of the maps [B,Hs,Ws], one tile at a time."""
    B, Hs, Ws = v0.shape
    for b in range(B):
        for y0 in range(0, Hs, th):
            for x0 in range(0, Ws, tiles.TILE_W):
                v = np.clip(v0[b, y0:y0 + th, x0:x0 + tiles.TILE_W], 0, H - 2)
                u = np.clip(u0[b, y0:y0 + th, x0:x0 + tiles.TILE_W], 0, W - 2)
                yield b, v.min(), v.max(), u.min(), u.max()


def _window(C):
    """K4's window at C channels: (rows, floats of a row), from 35 cells
    that start anywhere in a 32-float chunk."""
    return tiles.tile_rows(C) + 3, 32 * -(-(35 * C + 31) // 32)


def _k4_share(v0, u0, H, W, C):
    rows, floats = _window(C)
    if W * C % 32 or rows * floats > tiles.BOX_FLOATS:  # no window: every tile reads F
        return 0.0
    return np.mean([vhi - vlo + 2 <= rows and (uhi + 2) * C - ulo * C // 32 * 32 <= floats
                    for _, vlo, vhi, ulo, uhi in _boxes(v0, u0, H, W, tiles.tile_rows(C))])


def _k5_share(v0, u0, H, W, C):
    return np.mean([(vhi - vlo + 2) * (uhi - ulo + 2) * C <= tiles.GRADS_BOX_FLOATS
                    for _, vlo, vhi, ulo, uhi in _boxes(v0, u0, H, W, tiles.GRADS_TILE_H)])


def _starts(coords, B, H, W, Hs, Ws, seed):
    """Corner starts [B,Hs,Ws] int32: uniform over and past the plane,
    smooth sub-pixel flow of the grid scaled onto the plane, the same with a
    few samples half the plane away, or zoomed out 4x about the centre with
    a few starts at the int32 extremes."""
    rng = np.random.RandomState(seed)
    if coords == "random":
        return (rng.randint(-3, H + 2, (B, Hs, Ws)).astype(np.int32),
                rng.randint(-3, W + 2, (B, Hs, Ws)).astype(np.int32))
    y, x = np.meshgrid(np.arange(Hs), np.arange(Ws), indexing="ij")
    v = y * (H / Hs) + 0.8 * np.cos(x / 11.0) + 0.2 + np.zeros((B, 1, 1))
    u = x * (W / Ws) + 0.8 * np.sin(y / 9.0) + 0.3 + np.zeros((B, 1, 1))
    if coords == "teleported":
        b, i, j = rng.randint(0, B, 5), rng.randint(0, Hs, 5), rng.randint(0, Ws, 5)
        v[b, i, j] = (v[b, i, j] + H / 2) % (H - 1)
        u[b, i, j] = (u[b, i, j] + W / 2) % (W - 1)
    if coords == "offplane":
        v, u = (v - H / 2) * 4 + H / 2, (u - W / 2) * 4 + W / 2
    v0, u0 = np.floor(v).astype(np.int32), np.floor(u).astype(np.int32)
    if coords == "offplane":
        for m, extreme in ((v0, -2**31), (u0, 2**31 - 1), (v0, 2**31 - 1)):
            m[rng.randint(0, B, 3), rng.randint(0, Hs, 3), rng.randint(0, Ws, 3)] = extreme
    return v0, u0


@pytest.mark.parametrize("C", [1, 3, 4, 6, 10, 17, 40])
@pytest.mark.parametrize("coords", ["random", "smooth", "teleported", "offplane"])
@pytest.mark.parametrize("B,H,W,Hs,Ws", [
    (2, 120, 160, 120, 160),
    (3, 45, 50, 45, 50),     # ragged tiles at the bottom and right
    (2, 96, 448, 83, 301),   # a ragged grid scaled onto a larger plane
    (1, 7, 9, 7, 9),         # one tile holds the plane: its last row ends the plane
])
def test_staged_shares_match_a_per_tile_count(C, coords, B, H, W, Hs, Ws):
    v0, u0 = _starts(coords, B, H, W, Hs, Ws, seed=C)
    v0_t, u0_t = torch.from_numpy(v0), torch.from_numpy(u0)
    assert tiles.staged_share(v0_t, u0_t, H, W, C) == pytest.approx(
        _k4_share(v0, u0, H, W, C), abs=1e-12)
    assert tiles.grads_staged_share(v0_t, u0_t, H, W, C) == pytest.approx(
        _k5_share(v0, u0, H, W, C), abs=1e-12)


@pytest.mark.parametrize("C", [1, 3, 6, 10, 15, 16, 17, 32, 128])
def test_tile_rows_fit_the_box_of_a_smooth_tile(C):
    """The most rows, up to 16, whose window (3 rows and columns more than
    the tile, the columns rounded out to whole chunks) fits a buffer; fewer
    only where it must.  Up to C=15 a 16-row tile's window fits; at C=128
    none does, and no tile stages."""
    th = tiles.tile_rows(C)
    floats = _window(C)[1]
    fits = [(t + 3) * floats <= tiles.BOX_FLOATS for t in (16, 8, 4, 2, 1)]
    assert th == ((16, 8, 4, 2, 1)[fits.index(True)] if any(fits) else 1)
    assert (th == 16) == (C <= 15)
    assert tiles.has_window(640, C) == any(fits) == (C != 128)


@pytest.mark.parametrize("C", [6, 10])
def test_a_box_at_capacity_stages_and_one_row_more_does_not(C):
    """Identity starts, except that image 0's first tile spans a box that
    fills K4's window exactly, its second one row more and its third one
    column more: only the first of the three stages."""
    B, H, W, Hs, Ws = 2, 96, 160, 40, 80
    (v0, u0), n_global = window_maps(B, H, W, Hs, Ws, C)
    n_tiles = B * -(-Hs // tiles.tile_rows(C)) * -(-Ws // tiles.TILE_W)
    share = tiles.staged_share(torch.from_numpy(v0), torch.from_numpy(u0), H, W, C)
    assert share == pytest.approx(1.0 - n_global / n_tiles) == _k4_share(v0, u0, H, W, C)
