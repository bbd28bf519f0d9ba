// What the MSDA forward and backward kernels share: the level table, the
// split of a row's D channels over the lanes of a (b, q, h) item, the
// staging of an item tile's loc/attn rows in shared memory, and the checks
// and level table of a launch. Included by msda_forward.cu and
// msda_backward.cu; each builds into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msda {

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

// The kVec channels of a lane's chunk, as floats.
__device__ __forceinline__ void unpack_word(uint32_t u, float* out, float) {
  out[0] = __uint_as_float(u);
}
__device__ __forceinline__ void unpack_word(uint32_t u, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(u << 16);
  out[1] = __uint_as_float(u & 0xffff0000u);
}
template <typename T, int D>
__device__ __forceinline__ void unpack(const typename Split<T, D>::Word& w, float* out) {
  using Sp = Split<T, D>;
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < Sp::kWords; ++i) unpack_word(u[i], out + i * (Sp::kVec / Sp::kWords), T());
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

// The reverse of `stage`: n shared-memory rows back to contiguous global
// memory.
template <int V>
__device__ __forceinline__ void unstage(float* __restrict__ dst, const float* src, int n, int k,
                                        int stride) {
  const int per_row = k / V;
  const int units = n * per_row;
  for (int j = threadIdx.x; j < units; j += blockDim.x) {
    const int r = j / per_row;
    const int c = j - r * per_row;
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(dst) + j, reinterpret_cast<const float4*>(src + r * stride)[c]);
    } else {
      __stcs(dst + j, src[r * stride + c]);
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

// The level table of a block, copied from the kernel parameter into shared
// memory by thread 0 (read after the block's first __syncthreads).
__device__ __forceinline__ void copy_levels(const Levels& lv, int* s_lv) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      s_lv[i] = lv.h[i];
      s_lv[kMaxLevels + i] = lv.w[i];
      s_lv[2 * kMaxLevels + i] = lv.start[i];
    }
  }
}

// Checks a launch's sizes and builds its level table. Returns cudaSuccess,
// or cudaErrorInvalidValue for sizes the kernels do not take.
inline cudaError_t plan(int B, int S, int H, int D, int Q, int L, int P, const int* level_hw,
                        Levels* lv, int64_t* n_items) {
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > kMaxSamples) return cudaErrorInvalidValue;
  *lv = Levels{};
  int64_t start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    lv->start[l] = (int)start;
    start += (int64_t)lv->h[l] * lv->w[l];
  }
  if (start != S) return cudaErrorInvalidValue;
  *n_items = (int64_t)B * Q * H;
  // item indices and value offsets within a batch element are 32-bit
  if (*n_items > INT32_MAX || (int64_t)S * H * D > INT32_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace msda
