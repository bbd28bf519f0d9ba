// The core of the fusion layers' bi-directional attention for Hopper
// (sm_90a), on the inference path of models/fusion.py::BiMultiHeadAttention.
//
// Replaces no TPU kernel: the JAX package's models/fusion.py leaves this
// function to XLA (two einsums and two softmaxes over one [B, h, Nv, Nl]
// logit matrix). It was added because the port's PyTorch version of it was
// the largest device cost of every serving request: its softmax over the
// ~20k image rows (dim=-2) runs as PyTorch's strided cunn_SpatialSoftMax,
// which walks the rows of each of B*h*Nl columns serially, three times, and
// the [B, h, Nv, Nl] logits pass through device memory in f32 several times
// (~80% of a request's device time at 256 text tokens).
//
// It computes, for each batch item b and head h, with S = q_v k_l^T in f32
// (q_v already scaled by hd**-0.5):
//   out_v = softmax over Nl (S, keys masked by mask_l) val_l   image -> text
//   out_l = softmax over Nv (S^T, keys masked by mask_v) val_v text -> image
// A masked key's logit is -1e9 (models/layers.py NEG_INF), so a row whose
// keys are all masked averages them all, as the plain version does. Max,
// sum and rescale are f32; the probabilities are rounded to bf16 only as
// operands of the value products, which accumulate in f32; the outputs are
// bf16, written straight into [B, N, h*hd] at the head's columns. Padded
// image and text rows are computed like any other.
//
// Bound. At the serve-coco shape (B=2, h=4, hd=256, Nv=20197, Nl=256) the
// function reads q_v and val_v (82.7 MB each in bf16), k_l and val_l (1 MB
// each) and writes out_v (82.7 MB) and out_l: ~252 MB, 75 us at 3.35 TB/s.
// Its three products (S, P_v val_l, P_l^T val_v) are 63.5 GFLOP, 64 us at
// 989 TFLOP/s bf16. Bytes bound it, the tensor cores close behind.
//
// Design:
//   * Both directions are flash-attention forwards over the same logits,
//     with no softmax state in common, so one kernel template serves both:
//     queries, keys and values are rows of [B, N, ld] read in place at the
//     head's column offset (no head transposes), a chunk of keys at a time.
//     Image->text: the queries are q_v's rows, the keys k_l's (Nl <= 256,
//     8 chunks). Text->image: the queries are k_l's rows, the keys q_v's;
//     S is computed a second time there (21 GFLOP more at serve-coco, far
//     less than a B*h*Nv*Nl buffer), and neither logits nor probabilities
//     ever reach device memory.
//   * A block takes 64 query rows (kBM), 16 a warp; its Q tile stays in
//     shared memory and each 32-key chunk of K and V (kBN) is staged there
//     by cp.async (zero-filled past the end) in two stages, the next
//     chunk's loads in flight while this one is computed, one barrier a
//     chunk. Rows are padded by 16 bytes, so that ldmatrix's eight rows fall
//     on distinct banks. 101 KB of shared memory at hd=256; it and the
//     registers allow two blocks an SM.
//   * Products on the tensor cores by mma.sync m16n8k16 (bf16 operands, f32
//     accumulation); S's accumulator fragments are P's operand fragments, so
//     the probabilities never leave registers. The 16 x hd f32 output of a
//     warp is 128 registers a thread at hd=256, S's chunk 16 more (a
//     64-key chunk's 32 spilled); Q and K fragments are loaded from shared
//     memory for each 16-wide step, not held, so that nothing spills (ptxas
//     -v in the build log).
//   * Online softmax per row (the running max, the rescale of the output
//     and of the sum by exp(m_old - m_new)); a row's max and sum are shared
//     by the four lanes that hold it through two shuffles.
//   * Image->text writes out_v normalised, through the warp's own rows of
//     the Q tile, in 16-byte stores. Text->image has only B*h*ceil(Nl/64)
//     query tiles (32 at serve-coco, 4 at text 32), so Nv is split (as in
//     flash-decoding) into `splits` ranges, a function of the shapes alone
//     (ops/fusion_attn.py::split_plan: one wave of 2 blocks an SM); each
//     split writes
//     its unnormalised f32 output and its (max, sum) per row, and
//     fusion_attn_combine rescales and sums them into out_l. The query tile
//     is the fastest grid index, so the tiles of one split read its keys
//     from device memory once and from L2 after.
//   * One instance per head dim that a configuration runs (kHeadDims): 256
//     for every preset at full width, 32 for the tests' tiny model.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows a block
constexpr int kBN = 32;           // keys a chunk
constexpr int kPad = 8;           // bf16 elements (16 bytes) after each shared row
constexpr float kMaskedLogit = -1.0e9f;
constexpr int kHeadDims[] = {32, 256};

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(kBM + 4 * kBN) * (HD + kPad) * sizeof(__nv_bfloat16);
}

// One direction: queries attend over keys, each a row of [B, N, ld] bf16
// whose head h starts at column h * HD.
struct Pass {
  const __nv_bfloat16* q;         // [B, Nq, ld]
  const __nv_bfloat16* k;         // [B, Nk, ld]
  const __nv_bfloat16* v;         // [B, Nk, ld]
  const unsigned char* key_mask;  // [B, Nk], nonzero = valid; null: all valid
  __nv_bfloat16* out;             // [B, Nq, ld], normalised (one split)
  float* part_o;                  // [B*H, splits, Nq, HD], unnormalised (splits)
  float2* part_ml;                // [B*H, splits, Nq]: (row max, row sum)
  int H, Nq, Nk, ld, keys_per_split, splits;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for a 16x16 A (row-major fragment) and a 16x8 B (column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return (uint32_t)__bfloat16_as_ushort(p.x) | ((uint32_t)__bfloat16_as_ushort(p.y) << 16);
}

// ROWS rows of HD bf16 from rows [row0, row0 + ROWS) of `src` (row stride ld)
// into shared rows of HD + kPad; rows at or past `row_end` are zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int row_end, int ld) {
  constexpr int kChunks = HD / 8;
  static_assert((ROWS * kChunks) % kThreads == 0, "a tile is a whole number of passes");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < row_end;
    cp_async16(dst + r * (HD + kPad) + c * 8, src + (size_t)(in ? row0 + r : 0) * ld + c * 8,
               in ? 16 : 0);
  }
}

// Grid: (query tiles, splits, B*H). Each block: kBM query rows of one (b, h)
// over keys [y * keys_per_split, min(Nk, (y + 1) * keys_per_split)).
template <int HD, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) fusion_attn_kernel(const Pass p) {
  constexpr int kRow = HD + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBM * kRow;      // two stages of a chunk's keys
  __nv_bfloat16* sV = sK + 2 * kBN * kRow;  // and of its values

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // a fragment's row and column pair
  const int bh = blockIdx.z, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.x * kBM;
  const int k_begin = blockIdx.y * p.keys_per_split;
  const int k_end = min(p.Nk, k_begin + p.keys_per_split);
  const size_t col = (size_t)h * HD;
  const __nv_bfloat16* q = p.q + (size_t)b * p.Nq * p.ld + col;
  const __nv_bfloat16* k = p.k + (size_t)b * p.Nk * p.ld + col;
  const __nv_bfloat16* v = p.v + (size_t)b * p.Nk * p.ld + col;
  const unsigned char* mask = p.key_mask ? p.key_mask + (size_t)b * p.Nk : nullptr;

  load_rows<HD, kBM>(sQ, q, q0, p.Nq, p.ld);
  load_rows<HD, kBN>(sK, k, k_begin, k_end, p.ld);
  load_rows<HD, kBN>(sV, v, k_begin, k_end, p.ld);
  cp_async_commit();

  // ldmatrix row addresses of this lane: A (Q rows), B (K rows) and B^T (V rows)
  const __nv_bfloat16* qa = sQ + (warp * 16 + (lane & 15)) * kRow + (lane >> 4) * 8;
  const __nv_bfloat16* kb = sK + ((lane & 7) + ((lane >> 4) << 3)) * kRow + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* vb = sV + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRow + (lane >> 4) * 8;

  float o[HD / 8][4];  // rows g and g + 8 of the warp's 16, columns 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this lane's part of their running sums

  for (int c0 = k_begin, stage = 0; c0 < k_end; c0 += kBN, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk (and Q) landed; every warp is done with the other stage
    if (c0 + kBN < k_end) {  // the next chunk loads while this one is computed
      load_rows<HD, kBN>(sK + (stage ^ 1) * kBN * kRow, k, c0 + kBN, k_end, p.ld);
      load_rows<HD, kBN>(sV + (stage ^ 1) * kBN * kRow, v, c0 + kBN, k_end, p.ld);
      cp_async_commit();
    }
    const int at = stage * kBN * kRow;

    float s[kBN / 8][4];  // S of rows g, g + 8 and keys 8n + 2t, +1 of the chunk
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kb + at + np * 16 * kRow + kk * 16);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // keys past the range drop out; masked keys take the masked logit
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = c0 + n * 8 + 2 * t + j;
        if (key >= k_end) {
          s[n][j] = s[n][j + 2] = -INFINITY;
        } else if (mask != nullptr && !mask[key]) {
          s[n][j] = s[n][j + 2] = kMaskedLogit;
        }
        mx[0] = fmaxf(mx[0], s[n][j]);
        mx[1] = fmaxf(mx[1], s[n][j + 2]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_use);
      m[r] = m_new;
      mx[r] = m_use;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mx[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }


#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      uint32_t a[4];  // P of keys 16ks .. 16ks + 15 as an A fragment, in bf16
      a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + at + ks * 16 * kRow + np * 16);
        mma_bf16(o[2 * np], a, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0 and row0 + 8
  if constexpr (kSplit) {
    const size_t base = ((size_t)bh * p.splits + blockIdx.y) * p.Nq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < p.Nq) {
        float* dst = p.part_o + (base + row) * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
        if (t == 0) p.part_ml[base + row] = make_float2(m[r], l[r]);
      }
    }
  } else {
    // stage the warp's 16 output rows in its own rows of the Q tile (no
    // other warp reads them), then store whole 16-byte pieces of each row
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    __nv_bfloat16* stage = sQ + warp * 16 * kRow;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(stage + g * kRow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kRow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
    __syncwarp();
    constexpr int kChunks = HD / 8;
#pragma unroll
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks, c = i % kChunks;
      const int row = q0 + warp * 16 + r;
      if (row < p.Nq)
        *reinterpret_cast<uint4*>(p.out + ((size_t)b * p.Nq + row) * p.ld + col + c * 8) =
            *reinterpret_cast<const uint4*>(stage + r * kRow + c * 8);
    }
  }
}

// out[b, row, h * HD + c] = sum_s e^(m_s - M) o_s[c] / sum_s e^(m_s - M) l_s,
// M the largest m_s. Grid: (Nq, B*H), HD threads.
template <int HD>
__global__ void __launch_bounds__(HD) fusion_attn_combine(const float* part_o,
                                                         const float2* part_ml,
                                                         __nv_bfloat16* out, int H, int Nq,
                                                         int ld, int splits) {
  const int row = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const size_t first = (size_t)bh * splits * Nq + row;  // split s at first + s * Nq
  float top = -INFINITY;
  for (int s = 0; s < splits; ++s) top = fmaxf(top, part_ml[first + (size_t)s * Nq].x);
  float sum = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = first + (size_t)s * Nq;
    const float2 ml = part_ml[at];
    const float w = expf(ml.x - top);
    sum += w * ml.y;
    acc += w * part_o[at * HD + threadIdx.x];
  }
  out[((size_t)b * Nq + row) * ld + (size_t)h * HD + threadIdx.x] = __float2bfloat16(acc / sum);
}

template <int HD>
int launch(const void* q_v, const void* k_l, const void* val_v, const void* val_l,
           const void* mask_v, const void* mask_l, void* out_v, void* out_l, void* part_o,
           void* part_ml, int B, int H, int Nv, int Nl, int ld, int splits, int keys_per_split,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool ready = false;  // the shared memory limit is raised once a process
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(fusion_attn_kernel<HD, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fusion_attn_kernel<HD, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  using bf16 = __nv_bfloat16;
  using u8 = unsigned char;
  const Pass image{(const bf16*)q_v, (const bf16*)k_l, (const bf16*)val_l, (const u8*)mask_l,
                   (bf16*)out_v, nullptr, nullptr, H, Nv, Nl, ld, Nl, 1};
  fusion_attn_kernel<HD, false>
      <<<dim3((Nv + kBM - 1) / kBM, 1, B * H), kThreads, smem, stream>>>(image);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Pass text{(const bf16*)k_l, (const bf16*)q_v, (const bf16*)val_v, (const u8*)mask_v,
                  nullptr, (float*)part_o, (float2*)part_ml, H, Nl, Nv, ld, keys_per_split,
                  splits};
  fusion_attn_kernel<HD, true>
      <<<dim3((Nl + kBM - 1) / kBM, splits, B * H), kThreads, smem, stream>>>(text);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fusion_attn_combine<HD><<<dim3(Nl, B * H), HD, 0, stream>>>(
      (const float*)part_o, (const float2*)part_ml, (bf16*)out_l, H, Nl, ld, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The head dims instantiated, into dims[0 .. capacity); returns their count.
extern "C" int fusion_attn_head_dims(int* dims, int capacity) {
  const int n = (int)(sizeof(kHeadDims) / sizeof(kHeadDims[0]));
  for (int i = 0; i < n && i < capacity; ++i) dims[i] = kHeadDims[i];
  return n;
}

// q_v, k_l, val_v, val_l: [B, N, ld] bf16 (head h at columns h*hd .. h*hd + hd);
// mask_v [B, Nv], mask_l [B, Nl] bytes or null; out_v [B, Nv, ld], out_l
// [B, Nl, ld] bf16; part_o [B*H, splits, Nl, hd] and part_ml [B*H, splits,
// Nl, 2] f32 scratch. Returns the first CUDA error of the three launches.
extern "C" int fusion_attn_bf16(const void* q_v, const void* k_l, const void* val_v,
                                const void* val_l, const void* mask_v, const void* mask_l,
                                void* out_v, void* out_l, void* part_o, void* part_ml, int B,
                                int H, int hd, int Nv, int Nl, int ld, int splits,
                                int keys_per_split, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch<32>(q_v, k_l, val_v, val_l, mask_v, mask_l, out_v, out_l, part_o, part_ml,
                        B, H, Nv, Nl, ld, splits, keys_per_split, s);
    case 256:
      return launch<256>(q_v, k_l, val_v, val_l, mask_v, mask_l, out_v, out_l, part_o, part_ml,
                         B, H, Nv, Nl, ld, splits, keys_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
