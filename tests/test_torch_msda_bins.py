"""The bins of the MSDA backward kernel's binned passes
(`csrc/msda_backward.cu`), on the CPU through their plain versions in
`tests/torch_msda_bins.py`: `bin_plan` (the tiles of each level),
`sample_bins` (the count and records passes' bin and record key of each
sample), `chunk_table` (the scan's chunks).

Hypothesis draws level shapes, tile sizes and locations that include exact
cell edges, 0, 1, NaN and far outside. The last test runs the chunk pass on
the host (records bin by bin; each chunk's value window, zero outside the
level; the dots of each record's corners from that window; the flush of the
window cells inside the level; d_loc and d_attn gathered back to sample
order) and holds all three gradients against
`ms_deform_attn_backward_plain` at 1e-5 of each one's scale in f32.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.torch_msda_bins import bin_plan, chunk_table, sample_bins, tile_region
from ziragroundingdino_torch.ops.msda import ms_deform_attn_backward_plain
from ziragroundingdino_torch.ops.msda_cuda import CHUNK, TILE

SETTINGS = settings(max_examples=60, deadline=None)
level_shapes = st.lists(st.tuples(st.integers(1, 40), st.integers(1, 40)), min_size=1,
                        max_size=4)
tiles = st.integers(1, 15)  # a record keeps the window cell in 4 bits a side


@SETTINGS
@given(shapes=level_shapes, tile=tiles)
def test_every_cell_lies_in_exactly_one_tile(shapes, tile):
    plan = bin_plan(shapes, tile)
    owned = [np.zeros(hw, int) for hw in shapes]
    for t in range(plan.n_tiles):
        lvl, y0, y1, x0, x1 = tile_region(plan, shapes, t)
        owned[lvl][y0:y1, x0:x1] += 1
        wl, wy0, wy1, wx0, wx1 = tile_region(plan, shapes, t, window=True)
        assert (wl, wy0, wx0) == (lvl, y0, x0) and wy1 >= y1 and wx1 >= x1
    for cells in owned:
        assert (cells == 1).all()


def _coordinate(draw, size):
    """A location in one of the level's units: an exact cell edge or centre
    (x = loc * size - 0.5 lands on an integer or half), 0, 1, NaN, far
    outside, or uniform across and past the level."""
    kind = draw(st.sampled_from(["edge", "centre", "special", "uniform"]))
    if kind == "edge":
        return (draw(st.integers(-2, size + 2)) + 0.5) / size
    if kind == "centre":
        return draw(st.integers(-2, size + 2)) / size
    if kind == "special":
        return draw(st.sampled_from([0.0, 1.0, -1e6, 1e6, float("nan"), -0.0]))
    return draw(st.floats(-0.3, 1.3))


@st.composite
def located(draw):
    shapes = draw(level_shapes)
    tile = draw(tiles)
    b, q, h, p = draw(st.integers(1, 2)), draw(st.integers(1, 6)), draw(st.integers(1, 3)), 2
    loc = np.zeros((b, q, h, len(shapes), p, 2), np.float32)
    for idx in np.ndindex(*loc.shape[:-1]):
        h_l, w_l = shapes[idx[3]]
        loc[idx] = (_coordinate(draw, w_l), _coordinate(draw, h_l))
    return shapes, tile, loc


def _corners(loc, shapes):
    """Per sample the top-left corner cell (x0, y0) and the valid bits of the
    four corners, computed as the plain backward computes them."""
    out = []
    for lvl, (h_l, w_l) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * w_l - 0.5)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * h_l - 0.5)
        valid = [((x0 + cx >= 0) & (x0 + cx < w_l) & (y0 + cy >= 0) & (y0 + cy < h_l))
                 for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1))]
        out.append((x0, y0, torch.stack(valid, -1)))
    return out


@SETTINGS
@given(case=located())
def test_binned_samples_keep_their_corners_in_the_window(case):
    """A sample with no valid corner gets no bin; every valid corner of a
    binned sample lies in its bin's window, and the record key gives back
    the query and the top-left corner."""
    shapes, tile, loc_np = case
    loc = torch.from_numpy(loc_np)
    b, q, h = loc.shape[:3]
    plan = bin_plan(shapes, tile)
    bins, keys = sample_bins(loc, shapes, plan)
    for lvl, (x0, y0, valid) in enumerate(_corners(loc, shapes)):
        for idx in np.ndindex(*x0.shape):
            bb, qq, hh, _ = idx
            bin_ = bins[bb, qq, hh, lvl, idx[3]].item()
            if not valid[idx].any():
                assert bin_ == -1
                continue
            assert bin_ // plan.n_tiles == bb * h + hh
            wl, wy0, wy1, wx0, wx1 = tile_region(plan, shapes, bin_ % plan.n_tiles, window=True)
            assert wl == lvl
            for k, (cy, cx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                if valid[idx][k]:
                    y, x = int(y0[idx]) + cy, int(x0[idx]) + cx
                    assert wy0 <= y < wy1 and wx0 <= x < wx1
            key = keys[bb, qq, hh, lvl, idx[3]].item()
            assert key >> 8 == qq
            assert (wy0 + ((key >> 4) & 15) - 1, wx0 + (key & 15) - 1) == (int(y0[idx]),
                                                                            int(x0[idx]))


@SETTINGS
@given(counts=st.lists(st.integers(0, 5000), min_size=1, max_size=40),
       chunk=st.integers(1, 2048))
def test_chunk_table_covers_each_bin_exactly(counts, chunk):
    table = chunk_table(torch.tensor(counts), chunk).tolist()
    assert len(table) <= len(counts) + -(-sum(counts) // chunk)
    start = 0
    for i, c in enumerate(counts):
        mine = [row for row in table if row[0] == i]
        assert all(0 < end - begin <= chunk for _, begin, end in mine)
        assert [r[1] for r in mine] == ([start] + [r[2] for r in mine[:-1]] if mine else [])
        assert (mine[-1][2] if mine else start) == start + c
        start += c
    assert [row[0] for row in table] == sorted(row[0] for row in table)


def _binned_backward(shapes, value, loc, attn, g, tile, chunk):
    """(d_value, d_loc, d_attn) as the binned passes compute them: the
    records of each bin in sample order, split into chunks; per chunk the
    value window of the bin's window and the row and column before it (zero
    outside the level), each record's corner dots from it, and the d_value
    window whose cells inside the level go to d_value; each record's d_loc
    and d_attn gathered back to its sample (zero for an unbinned one).
    Every chunk's windows are filled, and every record's corners read and
    summed, at once: one gather through an index tensor of each chunk's
    window cells, one `index_add_` of the records' corners into the d_value
    windows, and one `index_add_` of the window cells inside the level
    into d_value (the flush)."""
    b, s, h, d = value.shape
    plan = bin_plan(shapes, tile)
    bins, keys = sample_bins(loc, shapes, plan)
    flat = bins.flatten()
    binned = torch.nonzero(flat >= 0).flatten()
    rec_sample = binned[torch.argsort(flat[binned], stable=True)]  # each record's sample
    rec_key = keys.flatten()[rec_sample]
    fx, fy = [], []
    for lvl, (h_l, w_l) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w_l - 0.5
        y = loc[:, :, :, lvl, :, 1] * h_l - 0.5
        fx.append(x - torch.floor(x))
        fy.append(y - torch.floor(y))
    rec_fx = torch.stack(fx, 3).flatten()[rec_sample]
    rec_fy = torch.stack(fy, 3).flatten()[rec_sample]
    rec_a = attn.flatten()[rec_sample]
    table = chunk_table(torch.bincount(flat[rec_sample], minlength=b * h * plan.n_tiles), chunk)
    win, side = tile + 1, tile + 2
    starts = np.cumsum([0] + [hh_ * ww_ for hh_, ww_ in shapes])

    # each chunk's (b, h), level and window origin (the tile's first cell)
    n_chunks = len(table)
    bh, t = table[:, 0] // plan.n_tiles, table[:, 0] % plan.n_tiles
    c_b, c_h = bh // h, bh % h
    region = [tile_region(plan, shapes, ti, window=True) for ti in t.tolist()]
    c_lvl = torch.tensor([r[0] for r in region])
    c_oy = torch.tensor([r[1] for r in region])
    c_ox = torch.tensor([r[3] for r in region])
    c_hl = torch.tensor(shapes)[c_lvl, 0]
    c_wl = torch.tensor(shapes)[c_lvl, 1]
    c_row0 = (c_b * s + torch.from_numpy(starts)[c_lvl]) * h + c_h  # row of cell (0, 0)

    def cells(n, off):
        """[n_chunks, n * n] level (y, x) of each chunk's n x n cells from
        its origin + off, their rows in [B * S * H, D] and whether they lie
        inside the level."""
        vy, vx = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
        y = c_oy[:, None] + off + vy.flatten()[None]
        x = c_ox[:, None] + off + vx.flatten()[None]
        inside = (y >= 0) & (y < c_hl[:, None]) & (x >= 0) & (x < c_wl[:, None])
        rows = c_row0[:, None] + (y * c_wl[:, None] + x) * h
        return torch.where(inside, rows, 0), inside

    # the value windows: side x side cells from one before the origin
    rows, inside = cells(side, -1)
    vwin = value.reshape(-1, d)[rows] * inside[..., None]  # [n_chunks, side * side, D]

    rec_chunk = torch.repeat_interleave(torch.arange(n_chunks), table[:, 2] - table[:, 1])
    key = rec_key
    lx, ly = (key & 15) - 1, ((key >> 4) & 15) - 1
    qq = key >> 8
    gv = g.reshape(b, -1, h, d)[c_b[rec_chunk], qq, c_h[rec_chunk]]  # [n, D]
    ox, oy = c_ox[rec_chunk], c_oy[rec_chunk]
    h_l, w_l = c_hl[rec_chunk], c_wl[rec_chunk]
    da, dx, dy = (torch.zeros(len(key)) for _ in range(3))
    windows = torch.zeros(n_chunks * win * win, d)
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        wx, wy = (rec_fx if cx else 1 - rec_fx), (rec_fy if cy else 1 - rec_fy)
        dot = (gv * vwin[rec_chunk, (ly + 1 + cy) * side + lx + 1 + cx]).sum(-1)
        da += wx * wy * dot
        dx += (1 if cx else -1) * wy * dot
        dy += wx * (1 if cy else -1) * dot
        # the flush's validity: from the window cell and the level's size
        ok = ((lx + cx >= 0) & (ox + lx + cx < w_l) & (ly + cy >= 0) & (oy + ly + cy < h_l))
        cell = rec_chunk * win * win + (ly + cy) * win + lx + cx
        windows.index_add_(0, cell[ok], ((wx * wy * rec_a)[:, None] * gv)[ok])
    rec_out = torch.stack((da, rec_a * dx * w_l, rec_a * dy * h_l), 1)

    # the flush: each window's cells inside the level into d_value
    rows, inside = cells(win, 0)
    d_value = torch.zeros(b * s * h, d)
    d_value.index_add_(0, rows[inside], windows.reshape(n_chunks, win * win, d)[inside])
    d_attn = torch.zeros(flat.numel())
    d_loc = torch.zeros(flat.numel(), 2)
    d_attn[rec_sample] = rec_out[:, 0]
    d_loc[rec_sample] = rec_out[:, 1:]
    return d_value.reshape(b, s, h, d), d_loc.reshape(loc.shape), d_attn.reshape(attn.shape)


@pytest.mark.parametrize("case, tile, chunk", [
    ("hot", TILE, CHUNK), ("hot", TILE, 7), ("main_tail", TILE, 5), ("ragged_b2", 3, 4),
    ("far_out", 1, 3)])
def test_binned_accumulation_matches_plain(case, tile, chunk):
    from tests.test_torch_msda import _grad_out, _inputs

    shapes, value, loc, attn = _inputs(case)
    t = [torch.from_numpy(x) for x in (value, loc, attn, _grad_out(case))]
    want = ms_deform_attn_backward_plain(t[0], shapes, t[1], t[2], t[3])
    got = _binned_backward(shapes, *t, tile, chunk)
    for name, x, w in zip(("d_value", "d_loc", "d_attn"), got, want):
        scale = w.abs().max().item()
        assert (x - w).abs().max().item() <= 1e-5 * scale, name
