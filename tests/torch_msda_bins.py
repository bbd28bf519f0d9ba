"""Plain versions of the bins of the MSDA backward kernel's binned passes
(`ziragroundingdino_torch/csrc/msda_backward.cu`): the tiles of each level
(`bin_plan`, `tile_region`), each sample's bin and record key as the count
and records passes compute them (`sample_bins`), and the scan's chunk table
(`chunk_table`). `tests/test_torch_msda_bins.py` holds them against the
kernel's rules on the CPU; `chip_smoke.py` counts with them what the binned
design moves at a shape.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ziragroundingdino_torch.ops.msda_cuda import CHUNK, TILE


class BinPlan(NamedTuple):
    """The d_value tiles of one (b, h), as `bin_plan` in the kernel lays them
    out: each level cut into `tile` x `tile` cells, row by row, levels in
    order."""

    tile: int
    tiles_x: Tuple[int, ...]  # tiles per row of each level
    first: Tuple[int, ...]  # first tile of each level, then the number of tiles

    @property
    def n_tiles(self) -> int:
        return self.first[-1]


def bin_plan(spatial_shapes: Sequence[Tuple[int, int]], tile: int = TILE) -> BinPlan:
    tiles_x, first, t = [], [], 0
    for h_l, w_l in spatial_shapes:
        tiles_x.append(-(-int(w_l) // tile))
        first.append(t)
        t += tiles_x[-1] * -(-int(h_l) // tile)
    return BinPlan(tile, tuple(tiles_x), tuple(first) + (t,))


def tile_region(plan: BinPlan, spatial_shapes, t: int, window: bool = False):
    """(level, y0, y1, x0, x1): the cells [y0, y1) x [x0, x1) of the level
    that tile t owns, or with `window` the cells of its window (one more
    cell past its right and bottom edges), clipped to the level."""
    level = max(i for i, f in enumerate(plan.first[:-1]) if f <= t)
    h_l, w_l = spatial_shapes[level]
    ty, tx = divmod(t - plan.first[level], plan.tiles_x[level])
    side = plan.tile + 1 if window else plan.tile
    y0, x0 = ty * plan.tile, tx * plan.tile
    return level, y0, min(y0 + side, h_l), x0, min(x0 + side, w_l)


def sample_bins(sampling_locations: torch.Tensor, spatial_shapes, plan: BinPlan):
    """Each sample's bin as the count and records passes compute it, on any
    device: (bin [B, Q, H, L, P] int64, (b * H + h) * n_tiles + the tile of
    its top-left corner cell (y0, x0), -1 counted as 0, or -1 for a sample
    with no valid corner; key, the record's q << 8 | (ly + 1) << 4 |
    (lx + 1), (ly, lx) = (y0, x0) less the tile's first cell)."""
    b, q, h = sampling_locations.shape[:3]
    dev = sampling_locations.device
    bins = torch.full(sampling_locations.shape[:-1], -1, dtype=torch.int64, device=dev)
    keys = torch.zeros_like(bins)
    bh = (torch.arange(b, device=dev)[:, None, None, None] * h
          + torch.arange(h, device=dev)[None, None, :, None])  # [B, 1, H, 1]
    q_idx = torch.arange(q, device=dev)[None, :, None, None]
    t_side = plan.tile
    for lvl, (h_l, w_l) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl].float()  # [B, Q, H, P, 2]
        x0 = torch.floor(loc[..., 0] * w_l - 0.5)
        y0 = torch.floor(loc[..., 1] * h_l - 0.5)
        valid = ((((x0 >= 0) & (x0 < w_l)) | ((x0 + 1 >= 0) & (x0 + 1 < w_l)))
                 & (((y0 >= 0) & (y0 < h_l)) | ((y0 + 1 >= 0) & (y0 + 1 < h_l))))
        ix = torch.where(valid, x0, 0.0).long()
        iy = torch.where(valid, y0, 0.0).long()
        tx = ix.clamp(min=0) // t_side
        ty = iy.clamp(min=0) // t_side
        tile = plan.first[lvl] + ty * plan.tiles_x[lvl] + tx
        local = (iy - ty * t_side + 1) << 4 | (ix - tx * t_side + 1)
        bins[:, :, :, lvl] = torch.where(valid, bh * plan.n_tiles + tile, -1)
        keys[:, :, :, lvl] = torch.where(valid, q_idx << 8 | local, 0)
    return bins, keys


def chunk_table(counts: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The scan on the host: each bin's count of records split into chunks
    of at most `chunk`, in bin order; [n_chunks, 3] int64 rows (bin, first
    record, end record), records laid out bin after bin."""
    counts = counts.long()
    starts = torch.cumsum(counts, 0) - counts
    per = (counts + chunk - 1) // chunk
    bin_ = torch.repeat_interleave(torch.arange(len(counts), device=counts.device), per)
    k = torch.arange(len(bin_), device=counts.device) - (torch.cumsum(per, 0) - per)[bin_]
    begin = starts[bin_] + k * chunk
    end = torch.minimum(begin + chunk, starts[bin_] + counts[bin_])
    return torch.stack((bin_, begin, end), 1)
