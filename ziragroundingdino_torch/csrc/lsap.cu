// Exact rectangular linear sum assignment (LSAP) for Hopper (sm_90a).
//
// Replaces the JAX package's train/matcher.py::lsap_jax, the JAX train
// step's default matcher (lax loops on the chip, vmapped over the batch):
// Jonker-Volgenant successive shortest augmenting paths with dual
// potentials. For each target row i in turn, Dijkstra over the query
// columns from i (r = min_val + cost[i] - u[i] - v, a strict < update, the
// lowest column among equal minima), then the dual updates of u and v and
// the augmentation along pred from the free column reached. The plain
// version is ops/lsap.py::lsap_plain; the same f32 operations in the same
// order (no --use_fast_math, no reordered sums, no products to contract)
// give its assignments exactly.
//
// Bound. Bytes: the costs read once and the assignments written once, at
// the train step's shape (7 outputs x B problems, Q = 900 queries, N
// targets) 7 x 900 x N x 4 B + 7 x N x 8 B: 0.13 MB for N = 5, 2.5 us at
// 3.35 TB/s. The kernel is far from that: it is latency-bound. A problem is
// a chain of dependent steps (one per column scanned), and each step is a
// pass over the row plus a block-wide argmin with two barriers; the
// problems of a launch run side by side, one block each.
//
// Design:
//   * one block of kThreads per problem; the costs come transposed to
//     [P, N, Q], so a target's row is contiguous and a step reads it with
//     coalesced loads (from L2 after the first steps);
//   * the Q-long arrays (v, shortest, pred, row4col, scanned) and the N-long
//     ones (u, col4row) live in shared memory: 17 B a query and 8 B a
//     target, at most 204,800 B at Q = N = kMaxQ;
//   * a step: every thread updates its columns (c = tid, tid + kThreads,
//     ...) and keeps its first smallest; warp shuffles, then one warp over
//     the warps' candidates, pick the smallest value and, among equals, the
//     lowest column; one thread marks it scanned and either ends the path
//     or continues from its row;
//   * the dual updates run over all threads, the augmentation on one.
// Costs must be finite. A problem with a cost that is not (checked first)
// gets the assignment n -> n: the kernel cannot raise, and its loops then
// stay bounded.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 8192;  // ops/lsap.py::MAX_Q
constexpr int kMaxSmem = 17 * kMaxQ + 8 * kMaxQ;

size_t smem_bytes(int N, int Q) { return (size_t)17 * Q + (size_t)8 * N; }

// (val, idx) <- the smaller of the two; the lower index among equal values
__device__ __forceinline__ void take_min(float& val, int& idx, float other_val, int other_idx) {
  if (other_val < val || (other_val == val && other_idx < idx)) {
    val = other_val;
    idx = other_idx;
  }
}

__device__ __forceinline__ void warp_min(float& val, int& idx) {
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, val, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_min(val, idx, ov, oi);
  }
}

// one block an SM is all a launch of a few dozen problems fills; the bound
// lets ptxas keep every value in registers (at (kThreads) alone it kept a
// 4-byte spill)
__global__ void __launch_bounds__(kThreads, 1)
lsap_kernel(const float* __restrict__ cost_t, long long* __restrict__ out, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* shortest = v + Q;
  int* pred = reinterpret_cast<int*>(shortest + Q);
  int* row4col = pred + Q;
  float* u = reinterpret_cast<float*>(row4col + Q);
  int* col4row = reinterpret_cast<int*>(u + N);
  unsigned char* scanned = reinterpret_cast<unsigned char*>(col4row + N);
  __shared__ float red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int s_row, s_sink;
  __shared__ float s_min;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cost = cost_t + (size_t)blockIdx.x * N * Q;
  long long* assignment = out + (size_t)blockIdx.x * N;

  int bad = 0;
  for (size_t k = tid; k < (size_t)N * Q; k += kThreads) bad |= !isfinite(cost[k]);
  if (__syncthreads_or(bad)) {
    for (int r = tid; r < N; r += kThreads) assignment[r] = r;
    return;
  }
  for (int c = tid; c < Q; c += kThreads) {
    v[c] = 0.f;
    row4col[c] = -1;
  }
  for (int r = tid; r < N; r += kThreads) {
    u[r] = 0.f;
    col4row[r] = -1;
  }

  for (int cur = 0; cur < N; ++cur) {
    // Dijkstra from row cur over the columns
    for (int c = tid; c < Q; c += kThreads) {
      shortest[c] = CUDART_INF_F;
      pred[c] = cur;
      scanned[c] = 0;
    }
    if (tid == 0) {
      s_row = cur;
      s_sink = -1;
      s_min = 0.f;
    }
    __syncthreads();
    // every step scans a new column, and a free one is reached within N steps
    for (int step = 0; step < Q && s_sink < 0; ++step) {
      const int i = s_row;
      const float min_val = s_min;
      const float ui = u[i];
      const float* row = cost + (size_t)i * Q;
      float best = CUDART_INF_F;
      int best_col = Q;
      for (int c = tid; c < Q; c += kThreads) {
        if (scanned[c]) continue;
        float sc = shortest[c];
        const float r = min_val + row[c] - ui - v[c];
        if (r < sc) {
          sc = r;
          shortest[c] = r;
          pred[c] = i;
        }
        if (sc < best) {  // columns rise within a thread: the first of equals stays
          best = sc;
          best_col = c;
        }
      }
      warp_min(best, best_col);
      if (lane == 0) {
        red_val[warp] = best;
        red_idx[warp] = best_col;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < kWarps ? red_val[lane] : CUDART_INF_F;
        best_col = lane < kWarps ? red_idx[lane] : Q;
        warp_min(best, best_col);
        if (lane == 0) {
          const int j = best_col;
          s_min = best;
          scanned[j] = 1;
          if (row4col[j] < 0) {
            s_sink = j;
          } else {
            s_row = row4col[j];
          }
        }
      }
      __syncthreads();
    }
    const int sink = s_sink;
    const float min_val = s_min;
    // the dual updates (scipy's _lsap semantics)
    for (int r = tid; r < N; r += kThreads) {
      if (r == cur) {
        u[r] = u[r] + min_val;
      } else {
        const int c = col4row[r];
        if (c >= 0 && scanned[c]) u[r] = u[r] + min_val - shortest[c];
      }
    }
    for (int c = tid; c < Q; c += kThreads) {
      if (scanned[c]) v[c] = v[c] + shortest[c] - min_val;
    }
    __syncthreads();
    // the augmentation along pred from the sink (at most N + 1 columns)
    if (tid == 0 && sink >= 0) {
      int j = sink;
      for (int k = 0; k <= N; ++k) {
        const int i = pred[j];
        row4col[j] = i;
        const int prev = col4row[i];
        col4row[i] = j;
        if (i == cur) break;
        j = prev;
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < N; r += kThreads) assignment[r] = col4row[r];
}

}  // namespace

// cost_t [P, N, Q] f32 (the [P, Q, N] costs transposed), contiguous; out
// [P, N] int64: the query of each target. N <= Q <= kMaxQ. Launches on
// `stream`; returns a cudaError_t code.
extern "C" int lsap_f32(const void* cost_t, void* out, int P, int N, int Q, void* stream) {
  if (P < 0 || N < 0 || N > Q || Q > kMaxQ) return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaSuccess;
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  const size_t smem = smem_bytes(N, Q);
  if (smem > 48 * 1024 && smem_set < kMaxSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = kMaxSmem;
  }
  lsap_kernel<<<P, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cost_t, (long long*)out, N, Q);
  return (int)cudaGetLastError();
}
