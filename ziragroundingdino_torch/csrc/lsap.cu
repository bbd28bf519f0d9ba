// Exact rectangular linear sum assignment (LSAP) for Hopper (sm_90a).
//
// Replaces the JAX package's train/matcher.py::lsap_jax, the JAX train
// step's default matcher (lax loops on the chip, vmapped over the batch):
// Jonker-Volgenant successive shortest augmenting paths with dual
// potentials. For each target row i in turn (0..N-1), Dijkstra over the
// query columns from i (r = ((min_val + cost[i]) - u[i]) - v, a strict <
// update, the lowest column among equal minima), then the dual updates of
// u and v and the augmentation along pred from the free column reached.
// The plain version is ops/lsap.py::lsap_plain; the same f32 operations in
// the same order (no --use_fast_math, no reordered sums, no products to
// contract) give its assignments exactly.
//
// Bound. Bytes: the costs read once and the assignments written once, at
// the lifecycle's shape (7 outputs x B problems, Q = 900 queries, N =
// max_boxes = 100 targets, most of them padding at the matcher's BIG)
// 7 x 900 x 100 x 4 B: 2.5 MB, 0.75 us at 3.35 TB/s. The kernel is
// latency-bound: a problem is a chain of dependent steps, one per column
// scanned (~4600 for 5 valid targets of 100: every BIG row ties along the
// BIG rows before it), each a pass over one row plus a block-wide argmin.
// The problems of a launch run side by side, one block each.
//
// Design (one block of kThreads per problem; the costs read as the matcher
// writes them, [P, Q, N], with no transpose launch):
//   * staging, once: each thread owns target rows and reads their costs
//     with kStageBatch loads in flight (coalesced across the warp), checks
//     them finite and classifies each row. A row whose Q costs are bitwise
//     equal (every padded BIG row) is kept as one scalar; the others go to
//     shared memory transposed to [row][Q] (stride Q | 1, so the staging
//     writes are free of bank conflicts too), as many as the launch plan's
//     slots hold (ops/lsap.py::launch_plan). Rows beyond them that vary are
//     written to a [rows, Q] scratch in global memory and read from L2 at
//     each step;
//   * column state in registers: a thread owns the columns c = tid +
//     k * kThreads, k < CPT, with their v, shortest and scanned bit (columns
//     beyond Q count as scanned for good); a column's row, with that row's u
//     and where its costs live (ColInfo, one 16-byte load), pred (two
//     buffers, by row parity), col4row and the rows' constants sit in
//     shared memory. The update is branch-free: selects and a predicated
//     store of pred;
//   * one barrier a Dijkstra step: each warp takes its least (an order-
//     preserving key of the f32 value, -0 as +0), then its lowest column
//     among equals, with two __reduce_min_sync; one lane writes the pair to
//     the step parity's slot, the winning lane the value; after the
//     barrier every warp reduces the kWarps pairs itself and reads the
//     column's ColInfo, so every thread knows the next row or the sink;
//   * a row's phases: the dual updates run column-side (the owner of a
//     scanned column applies (u + min_val) - shortest to its row's u, which
//     lives with the column) with the reset of shortest, scanned and the
//     next row's pred buffer, then a barrier, then the augmentation on one
//     thread while the others start the next row.
// Costs must be finite. A problem with a cost that is not (found while
// staging) gets the assignment n -> n: the kernel cannot raise, and its
// loops then stay bounded.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 8192;         // ops/lsap.py::MAX_Q
constexpr int kSmemLimit = 232448;  // a block's shared memory on sm_90 (ops/lsap.py::SMEM_LIMIT)
constexpr int kSmemReserve = 1024;  // room for the static shared memory (ops/lsap.py::SMEM_RESERVE)
constexpr int kStageBatch = 32;     // loads in flight per thread while staging
constexpr unsigned kNone = 0xffffffffu;

// a column's row and what the steps read of it, in one 16-byte load
struct __align__(16) ColInfo {
  int row;     // the row assigned to the column, -1 while it is free
  int src;     // where the row's costs live: >= 0 a shared slot, -1 constant
               // (cval), <= -2 row -2 - src of the global scratch
  float u;     // the row's dual
  float cval;  // the row's cost where it is constant
};

// ops/lsap.py::launch_plan's layout: a ColInfo (16 B) and two pred buffers
// (2 x 2 B) a column, rowcval (4 B), col4row and rowvaries (2 B each) a row,
// then the row slots
__host__ __device__ size_t fixed_bytes(int N, int Q) {
  return ((size_t)20 * Q + (size_t)8 * N + 15) / 16 * 16;
}
__host__ __device__ int row_stride(int Q) { return Q | 1; }

// increasing with the f32 value; -0.0 and +0.0 get one key, as float < sees them
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f + 0.f);  // -0.0 + 0.0 = +0.0; nothing else moves
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

// read row n's costs at queries q0, q0 + dq, ... (kStageBatch loads in
// flight, none waiting on `ref`), note whether any differs from `ref`
// bitwise or is not finite, and copy them to dst[q] (a shared slot) when
// dst is given. gdst (a scratch row) gets them from the first that differs
// on, and `ref` before it: a constant row writes nothing there.
__device__ __forceinline__ void stage_row(const float* __restrict__ prob, int n, int N, int Q,
                                          int q0, int dq, float ref, float* dst, float* gdst,
                                          bool& varies, bool& bad) {
  const unsigned refb = __float_as_uint(ref);
  const size_t stride = (size_t)dq * N;
  const float* p = prob + (size_t)q0 * N + n;
  for (int q = q0; q < Q; q += kStageBatch * dq, p += kStageBatch * stride) {
    float x[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (q + u * dq < Q) x[u] = __ldg(p + u * stride);
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int qq = q + u * dq;
      if (qq < Q) {
        const bool differs = __float_as_uint(x[u]) != refb;
        bad |= !isfinite(x[u]);
        if (dst != nullptr) dst[qq] = x[u];
        if (gdst != nullptr && (varies || differs)) {
          if (!varies)
            for (int r = q0; r < qq; r += dq) gdst[r] = __uint_as_float(refb);
          gdst[qq] = x[u];
        }
        varies |= differs;
      }
    }
  }
}

// one block an SM is all a launch of a few dozen problems fills, and the
// bound lets ptxas keep every value in registers
template <int CPT>
__global__ void __launch_bounds__(kThreads, 1)
lsap_kernel(const float* __restrict__ cost, long long* __restrict__ out, float* scratch, int N,
            int Q, int slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  ColInfo* cinfo = reinterpret_cast<ColInfo*>(smem);
  short* pred = reinterpret_cast<short*>(cinfo + Q);  // two buffers, by row parity
  float* rowcval = reinterpret_cast<float*>(pred + 2 * Q);
  short* col4row = reinterpret_cast<short*>(rowcval + N);
  short* rowvaries = col4row + N;
  float* srow = reinterpret_cast<float*>(smem + fixed_bytes(N, Q));
  __shared__ uint2 s_cand[2][kWarps];  // each warp's (key, column), by step parity
  __shared__ float s_val[2][kWarps];   // and its value

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = row_stride(Q);
  const float* prob = cost + (size_t)blockIdx.x * Q * N;
  float* grows = scratch + (size_t)blockIdx.x * (N - slots) * Q;
  long long* assignment = out + (size_t)blockIdx.x * N;

  for (int c = tid; c < Q; c += kThreads) {
    cinfo[c] = ColInfo{-1, 0, 0.f, 0.f};
    pred[c] = 0;
  }
  for (int r = tid; r < N; r += kThreads) {
    col4row[r] = -1;
    rowvaries[r] = 0;
  }
  __syncthreads();

  // staging: a thread owns rows n0, n0 + kThreads, ... (at most 32); at N <=
  // kThreads, groups of N threads split each row's queries, so every load of
  // a warp reads consecutive addresses. A row below `slots` goes to its own
  // slot whatever it holds, one beyond to its scratch row once it varies.
  const int groups = N <= kThreads ? kThreads / N : 1;
  const int g = N <= kThreads ? tid / N : 0;
  const int n0 = N <= kThreads ? tid % N : tid;
  bool bad = false;
  unsigned seen = 0u;  // bit j: row n0 + j * kThreads varied in this thread's share
  if (g < groups) {
    for (int n = n0, j = 0; n < N; n += kThreads, ++j) {
      const float ref = __ldg(prob + n);
      bool varies = false;
      stage_row(prob, n, N, Q, g, groups, ref,
                n < slots ? srow + n * qp : nullptr,
                n < slots ? nullptr : grows + (size_t)(n - slots) * Q, varies, bad);
      if (varies) rowvaries[n] = 1;
      if (g == 0) rowcval[n] = ref;
      seen |= (varies ? 1u : 0u) << j;
    }
  }
  if (__syncthreads_or(bad)) {
    for (int r = tid; r < N; r += kThreads) assignment[r] = r;
    return;
  }
  // a scratch row that varies outside this thread's share: its share is ref
  if (g < groups) {
    for (int n = n0, j = 0; n < N; n += kThreads, ++j) {
      if (n < slots || !rowvaries[n] || ((seen >> j) & 1u)) continue;
      float* gdst = grows + (size_t)(n - slots) * Q;
      for (int q = g; q < Q; q += groups) gdst[q] = rowcval[n];
    }
  }
  __syncthreads();

  // columns beyond Q count as scanned for good: never least, never updated
  unsigned beyond = 0u;
#pragma unroll
  for (int k = 0; k < CPT; ++k) beyond |= (tid + k * kThreads >= Q ? 1u : 0u) << k;
  float v[CPT], shortest[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    v[k] = 0.f;
    shortest[k] = CUDART_INF_F;
  }
  unsigned scanned = beyond;  // bit k: column tid + k * kThreads

  for (int cur = 0; cur < N; ++cur) {
    short* pr = pred + (cur & 1) * Q;  // all cur (set by the last row's phase)
    // where row cur's costs live (ColInfo::src)
    const int cur_src = !rowvaries[cur] ? -1 : cur < slots ? cur : -2 - (cur - slots);
    const float cur_cval = rowcval[cur];
    // Dijkstra from row cur over the columns; u[cur] is still 0
    int i = cur, src = cur_src, sink = -1;
    float ui = 0.f, cval = cur_cval, min_val = 0.f;
    // every step scans a new column, and a free one is reached within N steps
    for (int step = 0; step < Q; ++step) {
      float x[CPT];
      if (src == -1) {
#pragma unroll
        for (int k = 0; k < CPT; ++k) x[k] = cval;
      } else if (src >= 0) {
        const float* row = srow + src * qp;
#pragma unroll
        for (int k = 0; k < CPT; ++k) x[k] = row[min(tid + k * kThreads, Q - 1)];
      } else {
        const float* row = grows + (size_t)(-2 - src) * Q;
#pragma unroll
        for (int k = 0; k < CPT; ++k) x[k] = row[min(tid + k * kThreads, Q - 1)];
      }
      // the columns' update, then this thread's first least of those not
      // scanned (scanned ones count as +inf, as in the plain version's
      // argmin): a tree over k, where columns rise and the lower wins ties
      float m[CPT];
      int mc[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {  // no branch: selects and a predicated store
        const bool live = !((scanned >> k) & 1u);
        const float r = ((min_val + x[k]) - ui) - v[k];
        const bool upd = live & (r < shortest[k]);
        shortest[k] = upd ? r : shortest[k];
        if (upd) pr[tid + k * kThreads] = (short)i;
        m[k] = live ? shortest[k] : CUDART_INF_F;
        mc[k] = tid + k * kThreads;
      }
#pragma unroll
      for (int s = 1; s < CPT; s <<= 1) {
#pragma unroll
        for (int k = 0; k + s < CPT; k += 2 * s) {
          if (m[k + s] < m[k]) {
            m[k] = m[k + s];
            mc[k] = mc[k + s];
          }
        }
      }
      const float best = m[0];
      const unsigned best_col = (unsigned)mc[0];
      const unsigned key = order_key(best);
      const unsigned wkey = __reduce_min_sync(0xffffffffu, key);
      const unsigned wcol = __reduce_min_sync(0xffffffffu, key == wkey ? best_col : kNone);
      const int par = step & 1;
      if (lane == 0) s_cand[par][warp] = make_uint2(wkey, wcol);
      if (best_col == wcol) s_val[par][warp] = best;
      __syncthreads();
      const uint2 cand = s_cand[par][lane & (kWarps - 1)];
      const unsigned bkey = __reduce_min_sync(0xffffffffu, cand.x);
      const unsigned j = __reduce_min_sync(0xffffffffu, cand.x == bkey ? cand.y : kNone);
      const ColInfo info = cinfo[j];
      min_val = s_val[par][(j % kThreads) / 32];
      if (j % kThreads == (unsigned)tid) scanned |= 1u << (j / kThreads);
      if (info.row < 0) {
        sink = (int)j;
        break;
      }
      i = info.row;
      src = info.src;
      ui = info.u;
      cval = info.cval;
    }
    // the dual updates (scipy's _lsap semantics), column-side: the row of a
    // scanned column takes (u + min_val) - shortest, v (v + shortest) -
    // min_val; then the reset for the next row, pred in its own buffer
    const unsigned done = scanned & ~beyond;
    short* next = pred + ((cur + 1) & 1) * Q;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = tid + k * kThreads;
      if ((done >> k) & 1u) {
        v[k] = (v[k] + shortest[k]) - min_val;
        if (cinfo[c].row >= 0) cinfo[c].u = (cinfo[c].u + min_val) - shortest[k];
      }
      shortest[k] = CUDART_INF_F;
      if (!((beyond >> k) & 1u)) next[c] = (short)(cur + 1);
    }
    scanned = beyond;
    __syncthreads();
    // the augmentation along pred from the sink (at most N + 1 columns), on
    // one thread while the others start the next row; a path row's info
    // moves with it from its old column
    if (tid == 0 && sink >= 0) {
      int j = sink;
      for (int k = 0; k <= N; ++k) {
        const int r = pr[j];
        const int prev = col4row[r];
        const ColInfo ci = r == cur ? ColInfo{cur, cur_src, 0.f + min_val, cur_cval} : cinfo[prev];
        col4row[r] = (short)j;
        cinfo[j] = ci;
        if (r == cur) break;
        j = prev;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < N; r += kThreads) assignment[r] = col4row[r];
}

template <int CPT>
int launch(const float* cost, long long* out, float* scratch, int P, int N, int Q, int slots,
           int smem, cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // the dynamic shared memory this instance may use so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsap_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  lsap_kernel<CPT><<<P, kThreads, smem, stream>>>(cost, out, scratch, N, Q, slots);
  return (int)cudaGetLastError();
}

}  // namespace

// cost [P, Q, N] f32, contiguous (the matcher's layout); out [P, N] int64:
// the query of each target. N <= Q <= kMaxQ. cols_per_thread, slots and
// smem_bytes are ops/lsap.py::launch_plan(Q, N)'s; scratch holds P x (N -
// slots) x Q floats when slots < N (null otherwise). Launches on `stream`;
// returns a cudaError_t code.
extern "C" int lsap_f32(const void* cost, void* out, void* scratch, int P, int N, int Q,
                        int cols_per_thread, int slots, int smem_bytes, void* stream) {
  if (P < 0 || N < 0 || N > Q || Q > kMaxQ) return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaSuccess;
  if (slots < 0 || slots > N || (size_t)cols_per_thread * kThreads < (size_t)Q ||
      smem_bytes > kSmemLimit - kSmemReserve ||
      (size_t)smem_bytes != fixed_bytes(N, Q) + (size_t)slots * 4 * row_stride(Q) ||
      (slots < N && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* c = (const float*)cost;
  long long* o = (long long*)out;
  float* s = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cols_per_thread) {
    case 1: return launch<1>(c, o, s, P, N, Q, slots, smem_bytes, st);
    case 2: return launch<2>(c, o, s, P, N, Q, slots, smem_bytes, st);
    case 4: return launch<4>(c, o, s, P, N, Q, slots, smem_bytes, st);
    case 8: return launch<8>(c, o, s, P, N, Q, slots, smem_bytes, st);
    case 16: return launch<16>(c, o, s, P, N, Q, slots, smem_bytes, st);
    case 32: return launch<32>(c, o, s, P, N, Q, slots, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
