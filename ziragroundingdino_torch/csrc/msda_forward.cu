// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel in the JAX package's ops/msda_pallas.py:
//   * _gather_rows_pallas   (scalar-prefetch row gather over a quad table),
//   * ms_deform_attn_pallas (quad-table build, per-sample row index and
//     masked corner weights x softmaxed attention, f32 sum over L*P*4).
// It computes the same value, out[b, q, h*D + c] =
//   sum_{l, p, corner} valid * bilinear_w * attn[b, q, h, l, p]
//                      * value[b, start_l + y*w_l + x, h, c],
// with p = loc * size - 0.5, corners of floor(p), validity tested on the
// float coordinates before any float->int cast, f32 accumulation and the
// output in the value dtype.
//
// Bound. Bytes: at the encoder shape (B=1, S=Q=20197, H=8, D=32, L=P=4,
// bf16 value) each input read once and the output written once is value
// 10.3 MB + loc 20.7 MB + attn 10.3 MB + out 10.3 MB ~= 52 MB, ~15.6 us at
// 3.35 TB/s; the decoder shape (Q=900) ~12 MB, ~3.6 us. The arithmetic
// (~0.66 GFLOP per encoder call) is far below the card's rate. What the
// kernel really moves is the corner gather: 4 corners x D channels for each
// of the L*P samples of each (b, q, h) item, 4 x 64 B x 16 x 161,576 ~= 662
// MB per encoder call (29.5 MB per decoder call). value (~10 MB) stays in
// the 50 MB L2, so that traffic is L2 traffic, and the kernel is limited by
// how many L2 loads it keeps in flight, then by L2 bandwidth.
//
// Design:
//   * kLanes lanes serve one (b, q, h) item, each lane one 16-byte chunk of
//     the D channels of a corner's row (8 bf16 or 4 f32; one 8-byte chunk
//     when the whole row is 8 bytes). At D=32 in bf16, 4 lanes cover a
//     corner's 64 B and a warp serves 8 items.
//   * A block serves a tile of consecutive items. Their loc and attn are
//     contiguous; the block copies them into shared memory with coalesced
//     16-byte loads (rows padded so that the 8 items of a warp read distinct
//     banks), and nothing is broadcast-loaded per lane. Consecutive items
//     are neighbouring queries, whose corners share L1 lines.
//   * For a level, every corner's row offset and weight is computed into
//     registers first; then all corner loads are issued without branches
//     (an invalid corner reads row 0 with weight 0); then they are summed.
//     With L=P=4 that is 16 independent 16-byte loads in flight per lane.
//   * L and P are template parameters for the main path's L=P=4, so the
//     level loop unrolls; other (L, P) run the generic instantiation, which
//     walks levels and points at run time, one sample (4 loads) at a time.
//     Level shapes are read from shared memory, never from a local array
//     indexed at run time, so no instantiation has a stack frame.
//   * 128 threads a block (kThreads): at bf16 D=32 a block serves 32 items,
//     so the decoder shape (7,200 items) still spreads over every SM. L*P
//     is at most kMaxSamples, so that the widest tile (128 items, at one
//     lane an item) stages its loc/attn in 48 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 31;  // L * P
// 32 items a block at bf16 D=32, so the decoder's 7,200 items make 225
// blocks for the 132 SMs.
constexpr int kThreads = 128;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <int BYTES>
struct Chunk;
template <>
struct Chunk<16> {
  using type = uint4;
};
template <>
struct Chunk<8> {
  using type = uint2;
};

// How the D channels of one row are split over the lanes of an item.
template <typename T, int D>
struct Split {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kBytes = kRowBytes < 16 ? kRowBytes : 16;
  static constexpr int kVec = kBytes / (int)sizeof(T);  // channels per lane
  static constexpr int kLanes = D / kVec;               // lanes per item
  static constexpr int kWords = kBytes / 4;
  using Word = typename Chunk<kBytes>::type;
  static_assert(kLanes * kVec == D && 32 % kLanes == 0, "unsupported D");
};

// acc[j] += wt * element j of the 32-bit word u (one f32 or two bf16).
__device__ __forceinline__ void add_word(float* acc, uint32_t u, float wt, float) {
  acc[0] = fmaf(wt, __uint_as_float(u), acc[0]);
}
__device__ __forceinline__ void add_word(float* acc, uint32_t u, float wt, __nv_bfloat16) {
  acc[0] = fmaf(wt, __uint_as_float(u << 16), acc[0]);
  acc[1] = fmaf(wt, __uint_as_float(u & 0xffff0000u), acc[1]);
}
__device__ __forceinline__ uint32_t pack_word(const float* a, float) {
  return __float_as_uint(a[0]);
}
__device__ __forceinline__ uint32_t pack_word(const float* a, __nv_bfloat16) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a[0], a[1]);
  return (uint32_t)__bfloat16_as_ushort(p.x) | ((uint32_t)__bfloat16_as_ushort(p.y) << 16);
}

// Row offsets (in elements, from the item's lane base) and weights of the
// four corners of one sample: (y0, x0), (y0, x1), (y1, x0), (y1, x1). An
// invalid corner gets row 0 of the level and weight 0. The products are
// rounded as the plain version rounds them (no fused multiply-add).
__device__ __forceinline__ void corners(float lx, float ly, float a, int h_l, int w_l,
                                        int start, int row_stride, int* off, float* wt) {
  const float fw = (float)w_l;
  const float fh = (float)h_l;
  const float x = __fmul_rn(lx, fw) - 0.5f;
  const float y = __fmul_rn(ly, fh) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
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
  off[0] = (start + iy0 * w_l + ix0) * row_stride;
  off[1] = (start + iy0 * w_l + ix1) * row_stride;
  off[2] = (start + iy1 * w_l + ix0) * row_stride;
  off[3] = (start + iy1 * w_l + ix1) * row_stride;
  const float gx = 1.f - fx;
  const float gy = 1.f - fy;
  wt[0] = vy0 && vx0 ? __fmul_rn(gx, gy) * a : 0.f;
  wt[1] = vy0 && vx1 ? __fmul_rn(fx, gy) * a : 0.f;
  wt[2] = vy1 && vx0 ? __fmul_rn(gx, fy) * a : 0.f;
  wt[3] = vy1 && vx1 ? __fmul_rn(fx, fy) * a : 0.f;
}

// N floats from shared memory; 16-byte reads when N is a multiple of 4
// (the caller keeps p 16-byte aligned then).
template <int N>
__device__ __forceinline__ void read_shared(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// NS samples of one level: every corner's offset and weight first, then all
// 4*NS loads, then the sum.
template <typename T, int D, int NS>
__device__ __forceinline__ void gather(const float* loc_s, const float* attn_s, int h_l,
                                       int w_l, int start, int row_stride,
                                       const T* __restrict__ base, float* acc) {
  using Sp = Split<T, D>;
  using Word = typename Sp::Word;
  float xy[2 * NS], a[NS];
  read_shared<2 * NS>(loc_s, xy);
  read_shared<NS>(attn_s, a);
  int off[4 * NS];
  float wt[4 * NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    corners(xy[2 * s], xy[2 * s + 1], a[s], h_l, w_l, start, row_stride, off + 4 * s,
            wt + 4 * s);
  Word v[4 * NS];
#pragma unroll
  for (int k = 0; k < 4 * NS; ++k) v[k] = __ldg(reinterpret_cast<const Word*>(base + off[k]));
#pragma unroll
  for (int k = 0; k < 4 * NS; ++k) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&v[k]);
#pragma unroll
    for (int i = 0; i < Sp::kWords; ++i)
      add_word(acc + i * (Sp::kVec / Sp::kWords), u[i], wt[k], T());
  }
}

// Copies n rows of k floats, contiguous in global memory, into shared memory
// rows of `stride` floats, V floats per load (V = 4: 16-byte loads; the
// caller keeps src 16-byte aligned and k, stride multiples of 4).
template <int V>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n, int k,
                                      int stride) {
  const int per_row = k / V;
  const int units = n * per_row;
  for (int j = threadIdx.x; j < units; j += blockDim.x) {
    const int r = j / per_row;
    const int c = j - r * per_row;
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(dst + r * stride)[c] =
          __ldcs(reinterpret_cast<const float4*>(src) + j);
    } else {
      dst[r * stride + c] = __ldcs(src + j);
    }
  }
}

// Shared-memory row strides of an item's loc (k2 = 2*L*P floats) and attn
// (k1 = L*P): padded so that the items of a warp start on distinct banks.
__host__ __device__ constexpr int padded(int k, bool wide) { return wide ? k + 4 : (k | 1); }

// Shared memory of a block whose items take `lanes` lanes each.
__host__ __device__ constexpr size_t smem_bytes(int lanes, int k1, bool wide) {
  return (size_t)(kThreads / lanes) * (padded(k1, wide) + padded(2 * k1, wide)) * sizeof(float);
}
static_assert(smem_bytes(1, kMaxSamples, false) <= 48 * 1024 &&
                  smem_bytes(1, 16, true) <= 48 * 1024,
              "a tile's staged loc/attn must fit 48 KB of shared memory");

// kL = kP = 0: L and P are taken at run time (the generic instantiation).
template <typename T, int D, int kL, int kP>
__global__ void __launch_bounds__(kThreads)
msda_forward_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, T* __restrict__ out, int n_items, int Q,
                    int H, int S, int L_rt, int P_rt, Levels lv) {
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
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      s_lv[i] = lv.h[i];
      s_lv[kMaxLevels + i] = lv.w[i];
      s_lv[2 * kMaxLevels + i] = lv.start[i];
    }
  }
  constexpr int V = kStatic ? 4 : 1;
  stage<V>(s_loc, loc + (int64_t)item0 * k2, n_tile, k2, st2);
  stage<V>(s_attn, attn + (int64_t)item0 * k1, n_tile, k1, st1);
  __syncthreads();

  const int local = threadIdx.x / Sp::kLanes;
  if (local >= n_tile) return;
  const int lane = threadIdx.x - local * Sp::kLanes;
  const int item = item0 + local;  // (b * Q + q) * H + h
  const int h = item % H;
  const int b = item / (Q * H);
  const int row_stride = H * D;
  const T* base = value + (int64_t)b * S * row_stride + h * D + lane * Sp::kVec;
  const float* my_loc = s_loc + local * st2;
  const float* my_attn = s_attn + local * st1;

  float acc[Sp::kVec];
#pragma unroll
  for (int i = 0; i < Sp::kVec; ++i) acc[i] = 0.f;
  if constexpr (kStatic) {
#pragma unroll
    for (int l = 0; l < kL; ++l)
      gather<T, D, kP>(my_loc + 2 * kP * l, my_attn + kP * l, s_lv[l], s_lv[kMaxLevels + l],
                       s_lv[2 * kMaxLevels + l], row_stride, base, acc);
  } else {
    for (int l = 0; l < L; ++l) {
      const int h_l = s_lv[l];
      const int w_l = s_lv[kMaxLevels + l];
      const int start = s_lv[2 * kMaxLevels + l];
      for (int p = 0; p < P; ++p)
        gather<T, D, 1>(my_loc + 2 * (l * P + p), my_attn + l * P + p, h_l, w_l, start,
                        row_stride, base, acc);
    }
  }

  typename Sp::Word o;
  uint32_t* u = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < Sp::kWords; ++i) u[i] = pack_word(acc + i * (Sp::kVec / Sp::kWords), T());
  *reinterpret_cast<typename Sp::Word*>(out + (int64_t)item * D + lane * Sp::kVec) = o;
}

template <typename T, int D>
int launch_d(const void* value, const void* loc, const void* attn, void* out, int n_items,
             int Q, int H, int S, int L, int P, const Levels& lv, cudaStream_t stream) {
  constexpr int kLanes = Split<T, D>::kLanes;
  const bool is_static = L == 4 && P == 4;
  const int tile = kThreads / kLanes;
  const size_t smem = smem_bytes(kLanes, L * P, is_static);
  const int blocks = (int)(((int64_t)n_items + tile - 1) / tile);
  if (is_static) {
    msda_forward_kernel<T, D, 4, 4><<<blocks, kThreads, smem, stream>>>(
        (const T*)value, (const float*)loc, (const float*)attn, (T*)out, n_items, Q, H, S,
        L, P, lv);
  } else {
    msda_forward_kernel<T, D, 0, 0><<<blocks, kThreads, smem, stream>>>(
        (const T*)value, (const float*)loc, (const float*)attn, (T*)out, n_items, Q, H, S,
        L, P, lv);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* value, const void* loc, const void* attn, void* out, int B, int S,
           int H, int D, int Q, int L, int P, const int* level_hw, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > kMaxSamples) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  int64_t start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = (int)start;
    start += (int64_t)lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const int64_t n_items = (int64_t)B * Q * H;
  // item indices and value offsets within a batch element are 32-bit
  if (n_items > INT32_MAX || (int64_t)S * H * D > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (n_items == 0) return (int)cudaSuccess;
  const int n = (int)n_items;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 4: return launch_d<T, 4>(value, loc, attn, out, n, Q, H, S, L, P, lv, st);
    case 8: return launch_d<T, 8>(value, loc, attn, out, n, Q, H, S, L, P, lv, st);
    case 16: return launch_d<T, 16>(value, loc, attn, out, n, Q, H, S, L, P, lv, st);
    case 32: return launch_d<T, 32>(value, loc, attn, out, n, Q, H, S, L, P, lv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// value [B, S, H, D] (f32 or bf16), loc [B, Q, H, L, P, 2] f32,
// attn [B, Q, H, L, P] f32, out [B, Q, H*D] (value dtype); all contiguous
// and 16-byte aligned; D in {4, 8, 16, 32}; L*P <= 31. level_hw is a host
// array of L (h, w) pairs. Returns a cudaError_t code.
extern "C" int msda_forward_f32(const void* value, const void* loc, const void* attn,
                                void* out, int B, int S, int H, int D, int Q, int L, int P,
                                const int* level_hw, void* stream) {
  return launch<float>(value, loc, attn, out, B, S, H, D, Q, L, P, level_hw, stream);
}

extern "C" int msda_forward_bf16(const void* value, const void* loc, const void* attn,
                                 void* out, int B, int S, int H, int D, int Q, int L, int P,
                                 const int* level_hw, void* stream) {
  return launch<__nv_bfloat16>(value, loc, attn, out, B, S, H, D, Q, L, P, level_hw, stream);
}
