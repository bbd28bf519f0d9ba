// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the hand-written backward of the JAX package's MSDA, the
// custom-VJP rule `_quad_bwd` with `_quad_table_adjoint` (ops/msda.py,
// `ms_deform_attn_quad`). It computes the same three gradients without a
// quad table. For out[b, q, h*D + c] = sum_{l, p, corner} valid * w_corner
// * attn[b, q, h, l, p] * value[b, row, h, c] (the forward, msda_forward.cu)
// and g = grad_out:
//   d_value[b, row, h, c] += valid * w_corner * attn * g[b, q, h*D + c],
//   d_attn[b, q, h, l, p]  = sum_corner valid * w_corner * <g, v_corner>,
//   d_loc[b, q, h, l, p]   = attn * sum_corner valid * (dw/dx, dw/dy)
//                            * <g, v_corner> * (w_l, h_l),
// where x = loc_x * w_l - 0.5, the corner weights are products of
// (x - floor(x)) and its complement (and the same in y), floor has a zero
// gradient and validity is a constant mask decided on the float
// coordinates exactly as the forward decides it.
//
// Bound. Bytes: at the encoder shape (B=1, S=Q=20197, H=8, D=32, L=P=4,
// bf16 value) each input read once and each output written once is ~93 MB,
// ~28 us at 3.35 TB/s (decoder, Q=900: ~24 MB, ~7 us). The arithmetic is
// far below the card's rate. What a kernel really moves is L2 traffic: the
// corner gather of the forward again (~662 MB per encoder call in bf16) and
// the scatter of d_value, 4 corners x D f32 adds per sample. Done with one
// float4 atomic add per corner and 4 channels in L2 (the single-pass
// kernel), the scatter is 82.7 M vector atomics at the encoder shape, 1.32
// GB of f32 adds, taken at the L2's atomic rate: three quarters of the
// call. The TPU's answer, a per-(b, h) quad table of f32 rows, would be 85
// MB at the encoder shape, beyond the 50 MB L2.
//
// Two paths, chosen by the caller from the call's size:
//   * single pass (msda_backward_single_pass_*, msda_backward_main with
//     kScatter): the main pass below adds each valid corner's w * attn * g
//     to d_value with a float4 atomic. Cheapest for small calls (the
//     decoder's), whose atomics are few and spread.
//   * binned (msda_backward_*): bin the samples by the d_value cells they
//     write, and sum each bin in shared memory. Five launches on the
//     caller's stream:
//   1. count (msda_bin_count): each level is cut into kTile x kTile-cell
//      tiles; a sample with a valid corner belongs to the bin (b, h, tile of
//      its top-left corner cell (y0, x0), -1 counted as 0), whose window,
//      the tile plus one cell past its right and bottom edges, holds all its
//      valid corners. A block counts its samples in a shared histogram of
//      the (b, h)'s tiles, then adds each nonzero count to the bin's global
//      count: one global atomic per (block, bin), not per sample.
//   2. scan (msda_bin_scan, one block): the exclusive scan of the counts
//      gives each bin its range of records; the same pass splits each bin
//      into chunks of at most kChunk records (the chunk table), so that a
//      hot bin spreads over many blocks.
//   3. records (msda_bin_records): the count's blocks again write one
//      16-byte record per binned sample into its bin's range (query and
//      window cell, fx, fy, attn), the block's places reserved through its
//      histogram: one global atomic per (block, bin).
//   4. main (msda_backward_main): d_loc and d_attn with the forward's
//      mapping. kLanes lanes serve one (b, q, h) item, one 16-byte chunk of
//      the D channels a lane; a block's loc/attn rows are staged in shared
//      memory with 16-byte loads; a sample's four corner loads are issued
//      together, one sample at a time (few registers, so many warps an SM);
//      d_loc and d_attn are summed over an item's lanes with
//      __shfl_xor_sync (every lane reaches every shuffle: past the end of the
//      last tile a lane computes on the tile's last item and writes nothing)
//      and written back through the staged slots.
//   5. accumulate (msda_backward_accumulate): one block per chunk sorts its
//      records by cell in shared memory; groups of lanes take whole cells,
//      and a run of records on one cell sums w_corner * attn * g of its four
//      corners in registers and stores them once (no shared f32 atomics:
//      on Hopper they are compare-and-swap loops). Then each window cell
//      sums the four runs that reach it and goes to the f32 d_value with one
//      float4 atomic per 4 channels: ~2.5 M at the encoder shape instead of
//      82.7 M.
// The caller zeroes d_value and the bin counts and casts d_value to the
// value dtype afterwards. L and P are template parameters of the main pass
// for the main path's L=P=4; other (L, P) run its generic instantiation.

#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kTile = 8;             // cells per side of a tile (at most 15: 4 key bits)
constexpr int kWin = kTile + 1;      // cells per side of a tile's window
constexpr int kChunk = 1024;         // records of one accumulate block, at most
constexpr int kMaxTiles = 8192;      // tiles of one (b, h) over all levels
constexpr int kMaxQ = 1 << 24;       // queries: a record keeps q in 24 bits
constexpr int kBinQueries = 64;      // queries of one count or records block
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kAccThreads = 128;
constexpr int kGLoads = 8;           // g loads a lane has in flight in the accumulate pass

// The tiles of every level: tiles per row and the first tile of each level
// among the (b, h)'s tiles; first[l] = n_tiles for l >= L.
struct Bins {
  int tiles_x[kMaxLevels];
  int first[kMaxLevels + 1];
};

inline bool bin_plan(const Levels& lv, int L, Bins* bn) {
  *bn = Bins{};
  int t = 0;
  for (int l = 0; l < L; ++l) {
    bn->tiles_x[l] = (lv.w[l] + kTile - 1) / kTile;
    bn->first[l] = t;
    t += bn->tiles_x[l] * ((lv.h[l] + kTile - 1) / kTile);
    if (t > kMaxTiles) return false;
  }
  for (int l = L; l <= kMaxLevels; ++l) bn->first[l] = t;
  return true;
}

// Level shapes and tiles in shared memory: h, w, tiles per row, first tile.
struct SharedLevels {
  int h[kMaxLevels], w[kMaxLevels], tiles_x[kMaxLevels], first[kMaxLevels + 1];
};

__device__ __forceinline__ void copy_levels(const Levels& lv, const Bins& bn, SharedLevels* s) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      s->h[i] = lv.h[i];
      s->w[i] = lv.w[i];
      s->tiles_x[i] = bn.tiles_x[i];
      s->first[i] = bn.first[i];
    }
    s->first[kMaxLevels] = bn.first[kMaxLevels];
  }
}

// One sample's top-left corner cell (x0, y0) as floats, its fractions and a
// bit per valid corner, (y0, x0), (y0, x1), (y1, x0), (y1, x1); rounded as
// the forward rounds them.
struct Cell {
  float x0, y0, fx, fy;
  unsigned valid;
};

__device__ __forceinline__ Cell cell_of(float lx, float ly, int h_l, int w_l) {
  const float fw = (float)w_l;
  const float fh = (float)h_l;
  const float x = __fmul_rn(lx, fw) - 0.5f;
  const float y = __fmul_rn(ly, fh) - 0.5f;
  Cell c;
  c.x0 = floorf(x);
  c.y0 = floorf(y);
  c.fx = x - c.x0;
  c.fy = y - c.y0;
  const float x1 = c.x0 + 1.f;
  const float y1 = c.y0 + 1.f;
  const bool vx0 = c.x0 >= 0.f && c.x0 < fw;
  const bool vx1 = x1 >= 0.f && x1 < fw;
  const bool vy0 = c.y0 >= 0.f && c.y0 < fh;
  const bool vy1 = y1 >= 0.f && y1 < fh;
  c.valid = (vy0 && vx0 ? 1u : 0u) | (vy0 && vx1 ? 2u : 0u) | (vy1 && vx0 ? 4u : 0u) |
            (vy1 && vx1 ? 8u : 0u);
  return c;
}

// The tile of a binned sample (c.valid != 0, so x0 in [-1, w_l - 1] and y0
// in [-1, h_l - 1]) among its (b, h)'s tiles, and its top-left corner's
// place in the tile's window as the record keeps it: (ly + 1) << 4 |
// (lx + 1), lx = x0 - the tile's first column, in [-1, kTile - 1].
__device__ __forceinline__ int tile_of(const Cell& c, int tiles_x, int first, unsigned* local) {
  const int ix = (int)c.x0;
  const int iy = (int)c.y0;
  const int tx = max(ix, 0) / kTile;
  const int ty = max(iy, 0) / kTile;
  *local = (unsigned)((iy - ty * kTile + 1) << 4 | (ix - tx * kTile + 1));
  return first + ty * tiles_x + tx;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The bin block of a count or records launch: kBinQueries queries of one
// (b, h).
struct BinBlock {
  int bh, b, h, q0, nq;
};

__device__ __forceinline__ BinBlock bin_block(int Q, int H) {
  const int q_blocks = (Q + kBinQueries - 1) / kBinQueries;
  BinBlock bb;
  bb.bh = blockIdx.x / q_blocks;  // b * H + h
  bb.b = bb.bh / H;
  bb.h = bb.bh - bb.b * H;
  bb.q0 = (blockIdx.x - bb.bh * q_blocks) * kBinQueries;
  bb.nq = min(kBinQueries, Q - bb.q0);
  return bb;
}

// Sample j of a bin block (query q0 + j / (L*P), sample j % (L*P)): its
// level and cell; *offset is its index among the samples of loc and attn.
__device__ __forceinline__ Cell sample_cell(const float* __restrict__ loc, const BinBlock& bb,
                                            int j, int Q, int H, int k1, int P,
                                            const SharedLevels& s, int* level, int64_t* offset) {
  const int r = j / k1;
  const int sample = j - r * k1;
  *level = sample / P;
  *offset = ((int64_t)(bb.b * Q + bb.q0 + r) * H + bb.h) * k1 + sample;
  const float2 xy = *reinterpret_cast<const float2*>(loc + 2 * *offset);
  return cell_of(xy.x, xy.y, s.h[*level], s.w[*level]);
}

// 1. Bin counts; counts [B * H * n_tiles] are zeroed by the caller. A block
// counts its samples in a shared histogram of the (b, h)'s tiles, then adds
// each nonzero count to the bin's.
__global__ void __launch_bounds__(kBinThreads)
msda_bin_count(const float* __restrict__ loc, int* __restrict__ counts, int Q, int H, int L,
               int P, Levels lv, Bins bn) {
  extern __shared__ int s_hist[];
  __shared__ SharedLevels s_lv;
  const BinBlock bb = bin_block(Q, H);
  const int n_tiles = bn.first[kMaxLevels];
  const int k1 = L * P;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) s_hist[i] = 0;
  copy_levels(lv, bn, &s_lv);
  __syncthreads();
  for (int j = threadIdx.x; j < bb.nq * k1; j += blockDim.x) {
    int l;
    int64_t offset;
    const Cell c = sample_cell(loc, bb, j, Q, H, k1, P, s_lv, &l, &offset);
    unsigned local;
    if (c.valid) atomicAdd(&s_hist[tile_of(c, s_lv.tiles_x[l], s_lv.first[l], &local)], 1);
  }
  __syncthreads();
  int* dst = counts + (int64_t)bb.bh * n_tiles;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x)
    if (s_hist[i]) atomicAdd(dst + i, s_hist[i]);
}

// Inclusive scan of (x, y) over the warp.
__device__ __forceinline__ int2 warp_scan(int2 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, v.x, o);
    const int c = __shfl_up_sync(0xffffffffu, v.y, o);
    if (lane >= o) {
      v.x += a;
      v.y += c;
    }
  }
  return v;
}

// Exclusive scan of each thread's (x, y) over the block, in thread order;
// s_warp holds 32 int2. Every thread of the block calls it; a barrier must
// come before s_warp is used again.
__device__ __forceinline__ int2 block_scan(int2 mine, int2* s_warp) {
  const int2 incl = warp_scan(mine);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    const int2 w = lane < n_warps ? s_warp[lane] : make_int2(0, 0);
    const int2 wi = warp_scan(w);
    if (lane < n_warps) s_warp[lane] = wi;
  }
  __syncthreads();
  const int2 before = warp ? s_warp[warp - 1] : make_int2(0, 0);
  return make_int2(before.x + incl.x - mine.x, before.y + incl.y - mine.y);
}

// 2. One block: bins[i] (a count) becomes the bin's first record, the fill
// cursor of the records pass; bins[n_bins] the number of chunks; chunks[k] =
// (bin, first record, end record, 0) for each chunk of at most kChunk
// records, in bin order.
__global__ void __launch_bounds__(kScanThreads)
msda_bin_scan(int* __restrict__ bins, int n_bins, int4* __restrict__ chunks) {
  __shared__ int2 s_warp[32];
  const int per = (n_bins + blockDim.x - 1) / blockDim.x;
  const int lo = min(n_bins, (int)threadIdx.x * per);
  const int hi = min(n_bins, lo + per);
  int2 mine = make_int2(0, 0);  // (records, chunks) of this thread's bins
  for (int i = lo; i < hi; ++i) {
    const int c = bins[i];
    mine.x += c;
    mine.y += (c + kChunk - 1) / kChunk;
  }
  const int2 first = block_scan(mine, s_warp);
  int rec = first.x;
  int chunk = first.y;
  for (int i = lo; i < hi; ++i) {
    const int c = bins[i];
    bins[i] = rec;
    for (int k = 0; k < c; k += kChunk)
      chunks[chunk++] = make_int4(i, rec + k, rec + min(c, k + kChunk), 0);
    rec += c;
  }
  if (threadIdx.x == blockDim.x - 1) bins[n_bins] = chunk;
}

// 3. Records. The count's blocks again: each binned sample's tile and rank
// among the block's samples there; one global atomic per (block, bin)
// reserves the block's records in the bin's range (fill: each bin's next
// free record, the scan's output); then the block writes its records tile
// by tile, so that neighbouring threads store neighbouring records (16-byte
// records stored one by one in sample order would each write part of a
// sector). A record: q << 8 | its top-left corner's place in the window,
// fx, fy, attn.
__global__ void __launch_bounds__(kBinThreads)
msda_bin_records(const float* __restrict__ loc, const float* __restrict__ attn,
                 int* __restrict__ fill, uint4* __restrict__ records, int Q, int H, int L, int P,
                 Levels lv, Bins bn) {
  extern __shared__ int s_hist[];  // per tile: count, then first place in the block's order
  __shared__ SharedLevels s_lv;
  __shared__ int2 s_warp[32];
  __shared__ int s_binned;
  const BinBlock bb = bin_block(Q, H);
  const int n_tiles = bn.first[kMaxLevels];
  const int k1 = L * P;
  const int n = bb.nq * k1;
  int* s_base = s_hist + n_tiles;          // per tile: the block's first record in the bin
  int* s_key = s_base + n_tiles;           // per sample: tile << 13 | rank, or -1
  int* s_order = s_key + kBinQueries * k1;  // the block's binned samples, tile by tile
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) s_hist[i] = 0;
  copy_levels(lv, bn, &s_lv);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int l;
    int64_t offset;
    const Cell c = sample_cell(loc, bb, j, Q, H, k1, P, s_lv, &l, &offset);
    int key = -1;
    if (c.valid) {
      unsigned local;
      const int t = tile_of(c, s_lv.tiles_x[l], s_lv.first[l], &local);
      key = t << 13 | atomicAdd(&s_hist[t], 1);  // rank < kBinQueries * kMaxSamples < 2^13
    }
    s_key[j] = key;
  }
  __syncthreads();
  // a contiguous run of tiles a thread: reserve, then place the tiles
  int* fill_bh = fill + (int64_t)bb.bh * n_tiles;
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = min(n_tiles, (int)threadIdx.x * per);
  const int hi = min(n_tiles, lo + per);
  int mine = 0;
  for (int i = lo; i < hi; ++i) {
    const int c = s_hist[i];
    mine += c;
    if (c) s_base[i] = atomicAdd(fill_bh + i, c);
  }
  int place = block_scan(make_int2(mine, 0), s_warp).x;
  for (int i = lo; i < hi; ++i) {
    const int c = s_hist[i];
    s_hist[i] = place;
    place += c;
  }
  if (threadIdx.x == blockDim.x - 1) s_binned = place;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int key = s_key[j];
    if (key >= 0) s_order[s_hist[key >> 13] + (key & 8191)] = j;
  }
  __syncthreads();
  for (int at = threadIdx.x; at < s_binned; at += blockDim.x) {
    int l;
    int64_t offset;
    const Cell c = sample_cell(loc, bb, s_order[at], Q, H, k1, P, s_lv, &l, &offset);
    unsigned local;
    const int t = tile_of(c, s_lv.tiles_x[l], s_lv.first[l], &local);
    __stcg(records + s_base[t] + at - s_hist[t],
           make_uint4((unsigned)(bb.q0 + s_order[at] / k1) << 8 | local, __float_as_uint(c.fx),
                      __float_as_uint(c.fy), __float_as_uint(__ldg(attn + offset))));
  }
}

// The four corners of one sample as the main pass uses them: row offsets
// (in elements, from the item's lane base; an invalid corner gets row 0 of
// the level), the fractions and the valid bits.
struct Corners {
  int off[4];
  float fx, fy;
  unsigned valid;
};

__device__ __forceinline__ Corners corners(float lx, float ly, int h_l, int w_l, int start,
                                           int row_stride) {
  const Cell c = cell_of(lx, ly, h_l, w_l);
  const int ix0 = c.valid & 5u ? (int)c.x0 : 0;
  const int ix1 = c.valid & 10u ? (int)c.x0 + 1 : 0;
  const int iy0 = c.valid & 3u ? (int)c.y0 : 0;
  const int iy1 = c.valid & 12u ? (int)c.y0 + 1 : 0;
  Corners k;
  k.off[0] = (start + iy0 * w_l + ix0) * row_stride;
  k.off[1] = (start + iy0 * w_l + ix1) * row_stride;
  k.off[2] = (start + iy1 * w_l + ix0) * row_stride;
  k.off[3] = (start + iy1 * w_l + ix1) * row_stride;
  k.fx = c.fx;
  k.fy = c.fy;
  k.valid = c.valid;
  return k;
}

template <int kLanes>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One sample: its d_attn and d_loc. loc_s/attn_s are the item's
// shared-memory slots of the sample; lane 0 of an active item overwrites
// them with d_loc/d_attn. With kScatter (the single-pass kernel), each
// valid corner also adds w * attn * g to its d_value row with Hopper's
// 16-byte vector atomic: the lanes of an item take neighbouring float4
// groups of the row (lane, lane + kLanes, ...; ga holds g in that order),
// so one warp instruction adds whole 32-byte sectors.
template <typename T, int D, bool kScatter>
__device__ __forceinline__ void sample(float* loc_s, float* attn_s, int h_l, int w_l, int start,
                                       int row_stride, const T* __restrict__ base,
                                       float* __restrict__ dbase, const float* g, const float* ga,
                                       int lane, bool active) {
  using Sp = Split<T, D>;
  using Word = typename Sp::Word;
  const float a = *attn_s;
  const Corners c = corners(loc_s[0], loc_s[1], h_l, w_l, start, row_stride);
  Word v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __ldg(reinterpret_cast<const Word*>(base + c.off[i]));

  const float fx = c.fx, fy = c.fy;
  const float gx = 1.f - fx, gy = 1.f - fy;
  // corner i: weight wx[i & 1] * wy[i >> 1]; d/dx: sx[i & 1] * wy[i >> 1];
  // d/dy: wx[i & 1] * sx[i >> 1]
  const float wx[2] = {gx, fx}, wy[2] = {gy, fy}, sx[2] = {-1.f, 1.f};
  float da = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!(c.valid & (1u << i))) continue;
    float vf[Sp::kVec];
    unpack<T, D>(v[i], vf);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < Sp::kVec; ++j) dot = fmaf(g[j], vf[j], dot);
    const float w = __fmul_rn(wx[i & 1], wy[i >> 1]);
    da = fmaf(w, dot, da);
    dx = fmaf(sx[i & 1] * wy[i >> 1], dot, dx);
    dy = fmaf(wx[i & 1] * sx[i >> 1], dot, dy);
    if (kScatter && active) {
      const float wa = w * a;
      float* dst = dbase + c.off[i];
#pragma unroll
      for (int j = 0; j < Sp::kVec / 4; ++j)
        atomicAdd(reinterpret_cast<float4*>(dst + 4 * j * Sp::kLanes),
                  make_float4(wa * ga[4 * j], wa * ga[4 * j + 1], wa * ga[4 * j + 2],
                              wa * ga[4 * j + 3]));
    }
  }
  da = lane_sum<Sp::kLanes>(da);
  dx = lane_sum<Sp::kLanes>(dx);
  dy = lane_sum<Sp::kLanes>(dy);
  // every lane of the item has read the sample's slots before they are
  // overwritten
  __syncwarp();
  if (active && lane == 0) {
    *attn_s = da;
    loc_s[0] = a * dx * (float)w_l;
    loc_s[1] = a * dy * (float)h_l;
  }
}

// 4. d_loc and d_attn: the forward's mapping over a tile of consecutive
// (b, q, h) items; with kScatter also d_value, by atomics (the single-pass
// kernel of small calls). kL = kP = 0: L and P are taken at run time (the
// generic instantiation).
template <typename T, int D, int kL, int kP, bool kScatter>
__global__ void __launch_bounds__(kThreads)
msda_backward_main(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attn, const T* __restrict__ grad_out,
                   float* __restrict__ d_value, float* __restrict__ d_loc,
                   float* __restrict__ d_attn, int n_items, int Q, int H, int S, int L_rt,
                   int P_rt, Levels lv) {
  using Sp = Split<T, D>;
  constexpr bool kStatic = kL > 0;
  static_assert(!kStatic || (kL * kP) % 4 == 0, "static (L, P) needs L*P % 4 == 0");
  const int L = kStatic ? kL : L_rt;
  const int P = kStatic ? kP : P_rt;
  const int k1 = L * P;
  const int k2 = 2 * k1;
  const int st1 = padded(k1, kStatic);
  const int st2 = padded(k2, kStatic);
  const int tile = blockDim.x / Sp::kLanes;
  const int item0 = blockIdx.x * tile;
  const int n_tile = min(tile, n_items - item0);

  extern __shared__ float4 smem[];
  float* s_loc = reinterpret_cast<float*>(smem);
  float* s_attn = s_loc + tile * st2;
  __shared__ int s_lv[3 * kMaxLevels];
  copy_levels(lv, s_lv);
  constexpr int V = kStatic ? 4 : 1;
  stage<V>(s_loc, loc + (int64_t)item0 * k2, n_tile, k2, st2);
  stage<V>(s_attn, attn + (int64_t)item0 * k1, n_tile, k1, st1);
  __syncthreads();

  // past the tile's end a lane computes on the tile's last item, so that
  // every lane of the warp reaches every shuffle, and writes nothing
  const int slot = threadIdx.x / Sp::kLanes;
  const bool active = slot < n_tile;
  const int local = active ? slot : n_tile - 1;
  const int lane = threadIdx.x - slot * Sp::kLanes;
  const int item = item0 + local;  // (b * Q + q) * H + h
  const int h = item % H;
  const int b = item / (Q * H);
  const int row_stride = H * D;
  const int64_t row_base = (int64_t)b * S * row_stride + h * D;
  const T* base = value + row_base + lane * Sp::kVec;
  float* dbase = kScatter ? d_value + row_base + 4 * lane : nullptr;
  float* my_loc = s_loc + local * st2;
  float* my_attn = s_attn + local * st1;
  // g: the lane's chunk, for the dots; ga: with kScatter, the channels of
  // the lane's atomic adds (float4 groups lane, lane + kLanes, ...)
  const T* g_item = grad_out + (int64_t)item * D;
  float g[Sp::kVec], ga[Sp::kVec];
  unpack<T, D>(__ldcs(reinterpret_cast<const typename Sp::Word*>(g_item + lane * Sp::kVec)), g);
  if constexpr (kScatter) {
#pragma unroll
    for (int j = 0; j < Sp::kVec; ++j)
      ga[j] = to_float(g_item[4 * (lane + (j / 4) * Sp::kLanes) + j % 4]);
  }
  // one sample at a time: a lane has its 4 corner loads in flight, and the
  // few registers that takes let more warps share an SM than a level's 16
  // loads together would (more loads in flight in all)
  if constexpr (kStatic) {
#pragma unroll
    for (int l = 0; l < kL; ++l)
#pragma unroll
      for (int p = 0; p < kP; ++p)
        sample<T, D, kScatter>(my_loc + 2 * (kP * l + p), my_attn + kP * l + p, s_lv[l],
                               s_lv[kMaxLevels + l], s_lv[2 * kMaxLevels + l], row_stride, base,
                               dbase, g, ga, lane, active);
  } else {
    for (int l = 0; l < L; ++l) {
      const int h_l = s_lv[l];
      const int w_l = s_lv[kMaxLevels + l];
      const int start = s_lv[2 * kMaxLevels + l];
      for (int p = 0; p < P; ++p)
        sample<T, D, kScatter>(my_loc + 2 * (l * P + p), my_attn + l * P + p, h_l, w_l, start,
                               row_stride, base, dbase, g, ga, lane, active);
    }
  }
  __syncthreads();
  unstage<V>(d_loc + (int64_t)item0 * k2, s_loc, n_tile, k2, st2);
  unstage<V>(d_attn + (int64_t)item0 * k1, s_attn, n_tile, k1, st1);
}

// The entry of a level table picked by a run-time level, with constant
// indices only (no local copy of the kernel parameter).
template <int N>
__device__ __forceinline__ int pick(const int (&a)[N], int l) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = i == l ? a[i] : v;
  return v;
}

// The window cell of a record's top-left corner, (ly + 1) * kWin + lx + 1.
__device__ __forceinline__ int cell_key(unsigned key) {
  return (int)((key >> 4) & 15u) * kWin + (int)(key & 15u);
}

// 4 channels of g as floats.
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// A run's four corner sums (4 channels) into its cell's entries; the run
// alone holds its cell.
template <int kQuads>
__device__ __forceinline__ void put_run(float4* sums, int cell, const float4 (&acc)[4]) {
  if (cell < 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) sums[(cell * 4 + i) * kQuads] = acc[i];
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Dynamic shared memory of an accumulate block: the runs' sums, kWin^2
// cells x 4 corners x D floats, and the chunk's records.
constexpr size_t acc_smem_bytes(int D) {
  return sizeof(float) * kWin * kWin * 4 * D + sizeof(uint4) * kChunk;
}

// 5. d_value. One block per chunk (blocks past the chunk count return at
// once). The block sorts its records by the window cell of their top-left
// corner (a counting sort in shared memory), and groups of D / 4 lanes, four
// channels a lane, walk slices of the sorted records that start and end on
// a cell's edge: a run of records on one cell sums its four corners'
// w * attn * g in registers and stores them in the cell's entries. Then
// each window cell inside the level (its corners' validity) sums the entries
// of the four runs that reach it and adds them to d_value with one float4
// atomic per 4 channels (none for a sum of zeros).
template <typename T, int D>
__global__ void __launch_bounds__(kAccThreads)
msda_backward_accumulate(const T* __restrict__ grad_out, const uint4* __restrict__ records,
                         const int4* __restrict__ chunks, const int* __restrict__ n_chunks,
                         float* __restrict__ d_value, int Q, int H, int S, Levels lv, Bins bn) {
  constexpr int kCells = kWin * kWin;  // a run's cell: its top-left corner (ly + 1, lx + 1)
  constexpr int kQuads = D / 4;
  constexpr int kGroups = kAccThreads / kQuads;
  constexpr int kPer = kChunk / kAccThreads;  // records a thread sorts, at most
  static_assert(kChunk % kAccThreads == 0 && kAccThreads % kQuads == 0 && D % 4 == 0,
                "unsupported D");
  extern __shared__ float4 s_sum[];   // [cell][corner][D]: the runs' sums (acc_smem_bytes)
  uint4* s_rec = reinterpret_cast<uint4*>(s_sum + kCells * 4 * kQuads);  // sorted records
  __shared__ int s_start[kCells];  // per cell: count, then next sorted place
  if ((int)blockIdx.x >= *n_chunks) return;
  const int4 ck = chunks[blockIdx.x];
  const int n = ck.z - ck.y;
  const int n_tiles = bn.first[kMaxLevels];
  const int bh = ck.x / n_tiles;
  const int t = ck.x - bh * n_tiles;
  int l = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) l += t >= bn.first[i];
  const int h_l = pick(lv.h, l);
  const int w_l = pick(lv.w, l);
  const int tiles_x = pick(bn.tiles_x, l);
  const int ty = (t - pick(bn.first, l)) / tiles_x;
  const int oy = ty * kTile;  // the window's first cell, in the level
  const int ox = (t - pick(bn.first, l) - ty * tiles_x) * kTile;
  const int b = bh / H;
  const int h = bh - b * H;
  for (int i = threadIdx.x; i < kCells * 4 * kQuads; i += blockDim.x)
    s_sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < kCells; i += blockDim.x) s_start[i] = 0;
  __syncthreads();

  // a counting sort of the records by cell: count, scan, place
  uint4 rec[kPer];
  int cell_of_rec[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kAccThreads;
    rec[k] = i < n ? __ldcs(records + ck.y + i) : make_uint4(0u, 0u, 0u, 0u);
    cell_of_rec[k] = i < n ? cell_key(rec[k].x) : -1;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (cell_of_rec[k] >= 0) atomicAdd(&s_start[cell_of_rec[k]], 1);
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive scan of the counts, kPerLane cells a lane
    constexpr int kPerLane = (kCells + 31) / 32;
    int v[kPerLane], sum = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int idx = threadIdx.x * kPerLane + j;
      v[j] = idx < kCells ? s_start[idx] : 0;
      sum += v[j];
    }
    int run = warp_scan(make_int2(sum, 0)).x - sum;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int idx = threadIdx.x * kPerLane + j;
      if (idx < kCells) s_start[idx] = run;
      run += v[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (cell_of_rec[k] >= 0) s_rec[atomicAdd(&s_start[cell_of_rec[k]], 1)] = rec[k];
  __syncthreads();  // s_start[c] is now the end of cell c's records

  const int grp = threadIdx.x / kQuads;
  const int quad = threadIdx.x - grp * kQuads;
  float4* sums = s_sum + quad;
  const T* g_bh = grad_out + ((int64_t)b * Q * H + h) * D + 4 * quad;
  const int64_t q_stride = (int64_t)H * D;
  // group g takes the records from the end of the cell that holds place
  // n * g / kGroups - 1 on, so that every cell's records fall to one group
  const int q0 = n * grp / kGroups;
  const int q1 = n * (grp + 1) / kGroups;
  const int p_begin = q0 == 0 ? 0 : s_start[cell_key(s_rec[q0 - 1].x)];
  const int p1 = grp == kGroups - 1 ? n : q1 == 0 ? 0 : s_start[cell_key(s_rec[q1 - 1].x)];
  float4 acc[4] = {};
  int cur = -1;
  for (int p0 = p_begin; p0 < p1; p0 += kGLoads) {
    // a batch of records, their g in flight together; past the slice's end
    // a batch repeats its last record with attn and g zero (it adds 0 to
    // the same run, and no per-record guard stays live across the batch)
    uint4 r[kGLoads];
    float4 gv[kGLoads];
#pragma unroll
    for (int k = 0; k < kGLoads; ++k) {
      r[k] = s_rec[min(p0 + k, p1 - 1)];
      if (p0 + k >= p1) r[k].w = 0u;
    }
#pragma unroll
    for (int k = 0; k < kGLoads; ++k) {
      gv[k] = load_quad(g_bh + (r[k].x >> 8) * q_stride);
      if (p0 + k >= p1) gv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kGLoads; ++k) {
      const int cell = cell_key(r[k].x);
      if (cell != cur) {
        put_run<kQuads>(sums, cur, acc);
        cur = cell;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float fx = __uint_as_float(r[k].y), fy = __uint_as_float(r[k].z);
      const float a = __uint_as_float(r[k].w);
      const float gx = 1.f - fx, gy = 1.f - fy;
      const float w[4] = {__fmul_rn(gx, gy) * a, __fmul_rn(fx, gy) * a, __fmul_rn(gx, fy) * a,
                          __fmul_rn(fx, fy) * a};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i].x = fmaf(w[i], gv[k].x, acc[i].x);
        acc[i].y = fmaf(w[i], gv[k].y, acc[i].y);
        acc[i].z = fmaf(w[i], gv[k].z, acc[i].z);
        acc[i].w = fmaf(w[i], gv[k].w, acc[i].w);
      }
    }
  }
  put_run<kQuads>(sums, cur, acc);
  __syncthreads();

  // window cell (y, x) takes corner 3 of the run on (y, x), corner 2 of the
  // run on (y, x + 1), corner 1 of (y + 1, x), corner 0 of (y + 1, x + 1);
  // a run on top-left corner (ly, lx) has index (ly + 1) * kWin + lx + 1
  const int64_t row0 = (int64_t)b * S + pick(lv.start, l);  // cell 0 of the level
  for (int i = threadIdx.x; i < kCells * kQuads; i += blockDim.x) {
    const int cell = i / kQuads;
    const int q4 = i - cell * kQuads;
    const int y = cell / kWin;
    const int x = cell - y * kWin;
    if (oy + y >= h_l || ox + x >= w_l) continue;
    float4 sum = s_sum[((y * kWin + x) * 4 + 3) * kQuads + q4];
    if (x < kTile) add4(sum, s_sum[((y * kWin + x + 1) * 4 + 2) * kQuads + q4]);
    if (y < kTile) add4(sum, s_sum[(((y + 1) * kWin + x) * 4 + 1) * kQuads + q4]);
    if (y < kTile && x < kTile)
      add4(sum, s_sum[(((y + 1) * kWin + x + 1) * 4) * kQuads + q4]);
    if (sum.x == 0.f && sum.y == 0.f && sum.z == 0.f && sum.w == 0.f) continue;
    const int64_t row = row0 + (int64_t)(oy + y) * w_l + ox + x;
    atomicAdd(reinterpret_cast<float4*>(d_value + (row * H + h) * D) + q4, sum);
  }
}

template <typename T, int D, bool kScatter>
cudaError_t launch_main(const void* value, const void* loc, const void* attn,
                        const void* grad_out, void* d_value, void* d_loc, void* d_attn,
                        int n_items, int Q, int H, int S, int L, int P, const Levels& lv,
                        cudaStream_t stream) {
  constexpr int kLanes = Split<T, D>::kLanes;
  const bool is_static = L == 4 && P == 4;
  const int tile = kThreads / kLanes;
  auto kernel = is_static ? msda_backward_main<T, D, 4, 4, kScatter>
                          : msda_backward_main<T, D, 0, 0, kScatter>;
  kernel<<<(n_items + tile - 1) / tile, kThreads, smem_bytes(kLanes, L * P, is_static),
           stream>>>((const T*)value, (const float*)loc, (const float*)attn, (const T*)grad_out,
                     (float*)d_value, (float*)d_loc, (float*)d_attn, n_items, Q, H, S, L, P, lv);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* value, const void* loc, const void* attn, const void* grad_out,
             void* d_value, void* d_loc, void* d_attn, int* bins, int4* chunks, uint4* records,
             int B, int Q, int H, int S, int L, int P, const Levels& lv, const Bins& bn,
             cudaStream_t stream) {
  const int n_tiles = bn.first[kMaxLevels];
  const int n_bins = B * H * n_tiles;
  const int n_items = B * Q * H;
  const int n_samples = n_items * L * P;
  constexpr size_t acc_smem = acc_smem_bytes(D);
  const int bin_blocks = B * H * ((Q + kBinQueries - 1) / kBinQueries);

  msda_bin_count<<<bin_blocks, kBinThreads, n_tiles * sizeof(int), stream>>>(
      (const float*)loc, bins, Q, H, L, P, lv, bn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  msda_bin_scan<<<1, kScanThreads, 0, stream>>>(bins, n_bins, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = 2 * (n_tiles + kBinQueries * L * P) * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(msda_bin_records, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  msda_bin_records<<<bin_blocks, kBinThreads, smem, stream>>>(
      (const float*)loc, (const float*)attn, bins, records, Q, H, L, P, lv, bn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_main<T, D, false>(value, loc, attn, grad_out, nullptr, d_loc, d_attn, n_items, Q,
                                 H, S, L, P, lv, stream);
  if (err != cudaSuccess) return (int)err;

  if (acc_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(msda_backward_accumulate<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)acc_smem);
    if (err != cudaSuccess) return (int)err;
  }
  // at most one chunk per bin plus one per kChunk records
  msda_backward_accumulate<T, D><<<n_bins + (n_samples + kChunk - 1) / kChunk, kAccThreads,
                                   acc_smem, stream>>>((const T*)grad_out, records, chunks,
                                                       bins + n_bins, (float*)d_value, Q, H, S,
                                                       lv, bn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* value, const void* loc, const void* attn, const void* grad_out,
           void* d_value, void* d_loc, void* d_attn, void* bins, void* chunks, void* records,
           int B, int S, int H, int D, int Q, int L, int P, const int* level_hw, void* stream,
           bool binned) {
  Levels lv;
  int64_t n_items;
  const cudaError_t checked = plan(B, S, H, D, Q, L, P, level_hw, &lv, &n_items);
  if (checked != cudaSuccess) return (int)checked;
  Bins bn;
  // sample, record, bin and chunk indices are 32-bit
  if (binned && (!bin_plan(lv, L, &bn) || Q >= kMaxQ || n_items * L * P > INT32_MAX ||
                 (int64_t)B * H * bn.first[kMaxLevels] + n_items * L * P / kChunk + 2 >
                     INT32_MAX))
    return (int)cudaErrorInvalidValue;
  if (n_items == 0) return (int)cudaSuccess;
  const int n = (int)n_items;
  cudaStream_t st = (cudaStream_t)stream;
#define MSDA_BWD_CASE(DD)                                                                    \
  case DD:                                                                                   \
    return binned ? launch_d<T, DD>(value, loc, attn, grad_out, d_value, d_loc, d_attn,      \
                                    (int*)bins, (int4*)chunks, (uint4*)records, B, Q, H, S,  \
                                    L, P, lv, bn, st)                                        \
                  : (int)launch_main<T, DD, true>(value, loc, attn, grad_out, d_value, d_loc, \
                                                  d_attn, n, Q, H, S, L, P, lv, st);
  switch (D) {
    MSDA_BWD_CASE(4)
    MSDA_BWD_CASE(8)
    MSDA_BWD_CASE(16)
    MSDA_BWD_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSDA_BWD_CASE
}

}  // namespace

// value [B, S, H, D] (f32 or bf16), loc [B, Q, H, L, P, 2] f32,
// attn [B, Q, H, L, P] f32, grad_out [B, Q, H*D] (value dtype); d_value
// [B, S, H, D] f32, zeroed by the caller; d_loc, d_attn f32 of loc's and
// attn's shapes. All contiguous and 16-byte aligned; D in {4, 8, 16, 32};
// L*P <= 31. level_hw is a host array of L (h, w) pairs. Returns a
// cudaError_t code.
//
// msda_backward_*: the binned passes. Scratch: bins, B*H*n_tiles + 1 int32,
// zeroed by the caller (n_tiles: the tiles of kTile x kTile cells of all
// levels, at most kMaxTiles); chunks, 4 int32 for each of B*H*n_tiles +
// ceil(n_samples / kChunk) chunks; records, 4 int32 per sample (n_samples =
// B*Q*H*L*P); Q < 2^24.
extern "C" int msda_backward_f32(const void* value, const void* loc, const void* attn,
                                 const void* grad_out, void* d_value, void* d_loc, void* d_attn,
                                 void* bins, void* chunks, void* records, int B, int S, int H,
                                 int D, int Q, int L, int P, const int* level_hw, void* stream) {
  return launch<float>(value, loc, attn, grad_out, d_value, d_loc, d_attn, bins, chunks, records,
                       B, S, H, D, Q, L, P, level_hw, stream, true);
}

extern "C" int msda_backward_bf16(const void* value, const void* loc, const void* attn,
                                  const void* grad_out, void* d_value, void* d_loc, void* d_attn,
                                  void* bins, void* chunks, void* records, int B, int S, int H,
                                  int D, int Q, int L, int P, const int* level_hw, void* stream) {
  return launch<__nv_bfloat16>(value, loc, attn, grad_out, d_value, d_loc, d_attn, bins, chunks,
                               records, B, S, H, D, Q, L, P, level_hw, stream, true);
}

// msda_backward_single_pass_*: one launch, d_value by float4 atomics in L2
// (the kernel of calls below the binned passes' size).
extern "C" int msda_backward_single_pass_f32(const void* value, const void* loc, const void* attn,
                                             const void* grad_out, void* d_value, void* d_loc,
                                             void* d_attn, int B, int S, int H, int D, int Q,
                                             int L, int P, const int* level_hw, void* stream) {
  return launch<float>(value, loc, attn, grad_out, d_value, d_loc, d_attn, nullptr, nullptr,
                       nullptr, B, S, H, D, Q, L, P, level_hw, stream, false);
}

extern "C" int msda_backward_single_pass_bf16(const void* value, const void* loc,
                                              const void* attn, const void* grad_out,
                                              void* d_value, void* d_loc, void* d_attn, int B,
                                              int S, int H, int D, int Q, int L, int P,
                                              const int* level_hw, void* stream) {
  return launch<__nv_bfloat16>(value, loc, attn, grad_out, d_value, d_loc, d_attn, nullptr,
                               nullptr, nullptr, B, S, H, D, Q, L, P, level_hw, stream, false);
}

// The bins' layout constants, which the caller sizes its scratch by:
// out = {kTile, kChunk, kMaxTiles, kMaxQ}. Returns their number.
extern "C" int msda_backward_constants(int* out) {
  out[0] = kTile;
  out[1] = kChunk;
  out[2] = kMaxTiles;
  out[3] = kMaxQ;
  return 4;
}
