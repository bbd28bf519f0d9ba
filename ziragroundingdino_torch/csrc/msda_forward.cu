// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel in the JAX package's ops/msda_pallas.py:
//   * _gather_rows_pallas   (scalar-prefetch row gather over a quad table),
//   * ms_deform_attn_pallas (quad-table build, per-sample row index and
//     masked corner weights x softmaxed attention, f32 sum over L*P*4).
// It computes the same value, out[b, q, h*D + c] =
//   sum_{l, p, corner} valid * bilinear_w * attn[b, q, h, l, p]
//                      * value[b, start_l + y*w_l + x, h, c],
// with p = loc * size - 0.5, corners of floor(p), f32 accumulation and the
// output in the value dtype.
//
// Bound: bytes. At the encoder shape (B=1, S=Q=20197, H=8, D=32, L=P=4,
// bf16 value) the least traffic is value 10.3 MB + loc 20.7 MB + attn
// 10.3 MB + out 10.3 MB ~= 52 MB, ~15.6 us at 3.35 TB/s; the decoder shape
// (Q=900) moves ~12 MB, ~3.6 us. The arithmetic (~0.66 GFLOP per encoder
// call) is far below the card's rate.
//
// Design: the TPU kernel packs a 4x-wide quad table so that one sample is
// one 128-lane row DMA; that table is written anew every layer. Here there
// is no table: one warp per (b, q, h), lane = channel, reads each corner
// straight from value [B, S, H, D]. At D=32 in bf16 a corner is one
// coalesced 64-byte read by the warp, and value (~10 MB) stays in the 50 MB
// L2, so the random corner reads are served from L2. loc and attn are
// warp-broadcast loads. Validity is tested on the float coordinates before
// any float->int cast, so far out-of-range locations are well defined.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_forward_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, T* __restrict__ out,
                    int64_t n_items, int S, int H, int D, int Q, int L, int P,
                    Levels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n_items) return;
  // item = (b * Q + q) * H + h
  const int h = (int)(item % H);
  const int64_t b = item / ((int64_t)Q * H);

  const int64_t n_samples = (int64_t)L * P;
  const float* loc_i = loc + item * n_samples * 2;
  const float* attn_i = attn + item * n_samples;
  const T* value_bh = value + b * (int64_t)S * H * D + (int64_t)h * D;
  T* out_i = out + item * D;
  const int64_t row_stride = (int64_t)H * D;

  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    const bool lane_on = c < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int h_l = lv.h[l];
      const int w_l = lv.w[l];
      const float fh = (float)h_l;
      const float fw = (float)w_l;
      const T* value_l = value_bh + (int64_t)lv.start[l] * row_stride;
      for (int p = 0; p < P; ++p) {
        const int s = l * P + p;
        const float x = __ldg(loc_i + 2 * s) * fw - 0.5f;
        const float y = __ldg(loc_i + 2 * s + 1) * fh - 0.5f;
        const float a = __ldg(attn_i + s);
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        const float fx = x - x0;
        const float fy = y - y0;
#pragma unroll
        for (int corner = 0; corner < 4; ++corner) {
          const int dy = corner >> 1;
          const int dx = corner & 1;
          const float xf = x0 + (float)dx;
          const float yf = y0 + (float)dy;
          const bool valid = xf >= 0.f && xf < fw && yf >= 0.f && yf < fh;
          if (valid && lane_on) {
            const float wgt = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy) * a;
            const int64_t row = (int64_t)((int)yf) * w_l + (int)xf;
            acc += wgt * to_f32(value_l[row * row_stride + c]);
          }
        }
      }
    }
    if (lane_on) out_i[c] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* value, const void* loc, const void* attn, void* out, int B,
           int S, int H, int D, int Q, int L, int P, const int* level_hw,
           void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const int64_t n_items = (int64_t)B * Q * H;
  if (n_items == 0) return (int)cudaSuccess;
  const int64_t blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  msda_forward_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                           (cudaStream_t)stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, n_items, S, H,
      D, Q, L, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// value [B, S, H, D] (f32 or bf16), loc [B, Q, H, L, P, 2] f32,
// attn [B, Q, H, L, P] f32, out [B, Q, H*D] (value dtype); all contiguous.
// level_hw is a host array of L (h, w) pairs. Returns a cudaError_t code.
extern "C" int msda_forward_f32(const void* value, const void* loc, const void* attn,
                                void* out, int B, int S, int H, int D, int Q, int L,
                                int P, const int* level_hw, void* stream) {
  return launch<float>(value, loc, attn, out, B, S, H, D, Q, L, P, level_hw, stream);
}

extern "C" int msda_forward_bf16(const void* value, const void* loc, const void* attn,
                                 void* out, int B, int S, int H, int D, int Q, int L,
                                 int P, const int* level_hw, void* stream) {
  return launch<__nv_bfloat16>(value, loc, attn, out, B, S, H, D, Q, L, P, level_hw,
                               stream);
}
