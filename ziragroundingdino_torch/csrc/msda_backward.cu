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
// bf16 value) each input read once and each output written once is value
// 10.3 MB + loc 20.7 MB + attn 10.3 MB + grad_out 10.3 MB + the f32 d_value
// accumulator 20.7 MB + d_loc 20.7 MB + d_attn 10.3 MB ~= 103 MB, ~31 us at
// 3.35 TB/s; the decoder shape (Q=900) ~34 MB, ~10 us. The arithmetic is far
// below the card's rate. What the kernel really moves is L2 traffic: the
// corner gather of the forward again (4 corners x D channels per sample,
// ~662 MB per encoder call in bf16) and the f32 atomic adds into d_value,
// 4 corners x D x 4 B per sample, ~1.32 GB per encoder call (59 MB per
// decoder call). d_value (~21 MB) stays in the 50 MB L2, so the atomics
// resolve in L2, and the kernel is limited by the rate at which the L2
// takes atomic operations: fewer, wider ones are faster.
//
// Design: the forward's mapping.
//   * kLanes lanes serve one (b, q, h) item, each lane one 16-byte chunk of
//     the D channels of a row; the lane keeps its chunk of g in registers
//     for the dots.
//   * A block stages its tile's loc and attn in shared memory with
//     coalesced 16-byte loads, as the forward does; the same slots then
//     receive the item's d_loc and d_attn, which the block writes back
//     with coalesced stores.
//   * For a level, all corner loads of its samples are issued together
//     (16 with L=P=4; 8, two samples at a time, where one lane serves an
//     item: D * sizeof(T) <= 16 bytes). Each lane forms, per sample, its
//     partial of sum_corner w * <g, v>, sum_corner dw/dx * <g, v> and the
//     same in y;
//     the three are summed over the item's lanes with __shfl_xor_sync, so
//     every lane of the warp takes part in every shuffle (items past the
//     end of the last tile compute on a valid item and write nothing).
//   * Each valid corner adds w * attn * g to its d_value row with Hopper's
//     16-byte vector atomic (atomicAdd on float4, a RED of 4 floats, its
//     result unused); invalid corners add nothing. The lanes of an item
//     take neighbouring float4 groups of the row (lane, lane + kLanes, ...;
//     a second copy of g in that order sits in registers), so one warp
//     instruction adds whole 32-byte sectors. Scalar adds of a lane's own
//     chunk, 8 channels apart across lanes in bf16, took 6x as long at the
//     encoder shape.
//   * L and P are template parameters for the main path's L=P=4; other
//     (L, P) run the generic instantiation, one sample at a time.
// The caller zeroes d_value and casts it to the value dtype afterwards.

#include "msda_common.cuh"

namespace {

using namespace msda;

// The four corners of one sample, (y0, x0), (y0, x1), (y1, x0), (y1, x1):
// row offsets (in elements, from the item's lane base; an invalid corner
// gets row 0 of the level), the fractions fx = x - floor(x) and fy, and a
// bit per valid corner. Rounded as the forward rounds them.
struct Corners {
  int off[4];
  float fx, fy;
  unsigned valid;
};

__device__ __forceinline__ Corners corners(float lx, float ly, int h_l, int w_l, int start,
                                           int row_stride) {
  const float fw = (float)w_l;
  const float fh = (float)h_l;
  const float x = __fmul_rn(lx, fw) - 0.5f;
  const float y = __fmul_rn(ly, fh) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float x1 = x0 + 1.f;
  const float y1 = y0 + 1.f;
  const bool vx0 = x0 >= 0.f && x0 < fw;
  const bool vx1 = x1 >= 0.f && x1 < fw;
  const bool vy0 = y0 >= 0.f && y0 < fh;
  const bool vy1 = y1 >= 0.f && y1 < fh;
  const int ix0 = vx0 ? (int)x0 : 0;
  const int ix1 = vx1 ? (int)x1 : 0;
  const int iy0 = vy0 ? (int)y0 : 0;
  const int iy1 = vy1 ? (int)y1 : 0;
  Corners c;
  c.off[0] = (start + iy0 * w_l + ix0) * row_stride;
  c.off[1] = (start + iy0 * w_l + ix1) * row_stride;
  c.off[2] = (start + iy1 * w_l + ix0) * row_stride;
  c.off[3] = (start + iy1 * w_l + ix1) * row_stride;
  c.fx = x - x0;
  c.fy = y - y0;
  c.valid = (vy0 && vx0 ? 1u : 0u) | (vy0 && vx1 ? 2u : 0u) | (vy1 && vx0 ? 4u : 0u) |
            (vy1 && vx1 ? 8u : 0u);
  return c;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int kLanes>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NS samples of one level. loc_s/attn_s are the item's shared-memory slots
// of the level; lane 0 of an active item overwrites them with d_loc/d_attn.
template <typename T, int D, int NS>
__device__ __forceinline__ void level(float* loc_s, float* attn_s, int h_l, int w_l, int start,
                                      int row_stride, const T* __restrict__ base,
                                      float* __restrict__ dbase, const float* g,
                                      const float* ga, int lane, bool active) {
  using Sp = Split<T, D>;
  using Word = typename Sp::Word;
  float xy[2 * NS], a[NS];
  read_shared<2 * NS>(loc_s, xy);
  read_shared<NS>(attn_s, a);
  Corners c[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    c[s] = corners(xy[2 * s], xy[2 * s + 1], h_l, w_l, start, row_stride);
  Word v[4 * NS];
#pragma unroll
  for (int k = 0; k < 4 * NS; ++k)
    v[k] = __ldg(reinterpret_cast<const Word*>(base + c[k / 4].off[k % 4]));

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float fx = c[s].fx, fy = c[s].fy;
    const float gx = 1.f - fx, gy = 1.f - fy;
    // corner i: weight wx[i & 1] * wy[i >> 1]; d/dx: sx[i & 1] * wy[i >> 1];
    // d/dy: wx[i & 1] * sx[i >> 1]
    const float wx[2] = {gx, fx}, wy[2] = {gy, fy}, sx[2] = {-1.f, 1.f};
    float da = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!(c[s].valid & (1u << i))) continue;
      float vf[Sp::kVec];
      unpack<T, D>(v[4 * s + i], vf);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < Sp::kVec; ++j) dot = fmaf(g[j], vf[j], dot);
      const float w = __fmul_rn(wx[i & 1], wy[i >> 1]);
      da = fmaf(w, dot, da);
      dx = fmaf(sx[i & 1] * wy[i >> 1], dot, dx);
      dy = fmaf(wx[i & 1] * sx[i >> 1], dot, dy);
      if (active) {
        const float wa = w * a[s];
        float* dst = dbase + c[s].off[i];
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
    // every lane of the item has read the level's slots before they are
    // overwritten
    __syncwarp();
    if (active && lane == 0) {
      attn_s[s] = da;
      loc_s[2 * s] = a[s] * dx * (float)w_l;
      loc_s[2 * s + 1] = a[s] * dy * (float)h_l;
    }
  }
}

// kL = kP = 0: L and P are taken at run time (the generic instantiation).
template <typename T, int D, int kL, int kP>
__global__ void __launch_bounds__(kThreads)
msda_backward_kernel(const T* __restrict__ value, const float* __restrict__ loc,
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
  // a lane's atomic adds go to the float4 groups lane, lane + kLanes, ...
  float* dbase = d_value + row_base + 4 * lane;
  float* my_loc = s_loc + local * st2;
  float* my_attn = s_attn + local * st1;

  // g: the lane's chunk, for the dots; ga: the channels of the lane's atomic
  // adds (float4 groups lane, lane + kLanes, ...)
  const T* g_item = grad_out + (int64_t)item * D;
  float g[Sp::kVec], ga[Sp::kVec];
  unpack<T, D>(__ldcs(reinterpret_cast<const typename Sp::Word*>(g_item + lane * Sp::kVec)), g);
#pragma unroll
  for (int j = 0; j < Sp::kVec; ++j)
    ga[j] = to_float(g_item[4 * (lane + (j / 4) * Sp::kLanes) + j % 4]);
  if constexpr (kStatic) {
    // with one lane an item, a level's samples go two at a time: 16 loads
    // in flight left f32 D=4 with a spill
    constexpr int kGroup = Sp::kLanes == 1 ? 2 : kP;
    static_assert(kP % kGroup == 0, "kGroup must divide kP");
#pragma unroll
    for (int l = 0; l < kL; ++l)
#pragma unroll
      for (int p0 = 0; p0 < kP; p0 += kGroup)
        level<T, D, kGroup>(my_loc + 2 * (kP * l + p0), my_attn + kP * l + p0, s_lv[l],
                            s_lv[kMaxLevels + l], s_lv[2 * kMaxLevels + l], row_stride, base,
                            dbase, g, ga, lane, active);
  } else {
    for (int l = 0; l < L; ++l) {
      const int h_l = s_lv[l];
      const int w_l = s_lv[kMaxLevels + l];
      const int start = s_lv[2 * kMaxLevels + l];
      for (int p = 0; p < P; ++p)
        level<T, D, 1>(my_loc + 2 * (l * P + p), my_attn + l * P + p, h_l, w_l, start,
                       row_stride, base, dbase, g, ga, lane, active);
    }
  }
  __syncthreads();
  unstage<V>(d_loc + (int64_t)item0 * k2, s_loc, n_tile, k2, st2);
  unstage<V>(d_attn + (int64_t)item0 * k1, s_attn, n_tile, k1, st1);
}

template <typename T, int D>
int launch_d(const void* value, const void* loc, const void* attn, const void* grad_out,
             void* d_value, void* d_loc, void* d_attn, int n_items, int Q, int H, int S, int L,
             int P, const Levels& lv, cudaStream_t stream) {
  constexpr int kLanes = Split<T, D>::kLanes;
  const bool is_static = L == 4 && P == 4;
  const int tile = kThreads / kLanes;
  const size_t smem = smem_bytes(kLanes, L * P, is_static);
  const int blocks = (int)(((int64_t)n_items + tile - 1) / tile);
  auto kernel = is_static ? msda_backward_kernel<T, D, 4, 4> : msda_backward_kernel<T, D, 0, 0>;
  kernel<<<blocks, kThreads, smem, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (const T*)grad_out,
      (float*)d_value, (float*)d_loc, (float*)d_attn, n_items, Q, H, S, L, P, lv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* value, const void* loc, const void* attn, const void* grad_out,
           void* d_value, void* d_loc, void* d_attn, int B, int S, int H, int D, int Q, int L,
           int P, const int* level_hw, void* stream) {
  Levels lv;
  int64_t n_items;
  const cudaError_t checked = plan(B, S, H, D, Q, L, P, level_hw, &lv, &n_items);
  if (checked != cudaSuccess) return (int)checked;
  if (n_items == 0) return (int)cudaSuccess;
  const int n = (int)n_items;
  cudaStream_t st = (cudaStream_t)stream;
#define MSDA_BWD_CASE(DD)                                                                   \
  case DD:                                                                                  \
    return launch_d<T, DD>(value, loc, attn, grad_out, d_value, d_loc, d_attn, n, Q, H, S, \
                           L, P, lv, st);
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
extern "C" int msda_backward_f32(const void* value, const void* loc, const void* attn,
                                 const void* grad_out, void* d_value, void* d_loc, void* d_attn,
                                 int B, int S, int H, int D, int Q, int L, int P,
                                 const int* level_hw, void* stream) {
  return launch<float>(value, loc, attn, grad_out, d_value, d_loc, d_attn, B, S, H, D, Q, L, P,
                       level_hw, stream);
}

extern "C" int msda_backward_bf16(const void* value, const void* loc, const void* attn,
                                  const void* grad_out, void* d_value, void* d_loc, void* d_attn,
                                  int B, int S, int H, int D, int Q, int L, int P,
                                  const int* level_hw, void* stream) {
  return launch<__nv_bfloat16>(value, loc, attn, grad_out, d_value, d_loc, d_attn, B, S, H, D,
                               Q, L, P, level_hw, stream);
}
