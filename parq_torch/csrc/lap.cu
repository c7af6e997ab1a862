// Kernel M1: the matcher's linear assignment, batched, for Hopper (sm_90a).
//
// Replaces parq_tpu/ops/hungarian.py:solve_lap (:24), which is not a Pallas
// kernel but device code all the same: a Jonker-Volgenant shortest
// augmenting path search in lax.while_loops, vmapped over the (iteration,
// sample) pairs, so the JAX train step never waits on the host. Torch ops
// cannot express its data-dependent loops without a host sync per search
// step; this kernel runs them on the card.
//
//   col4row[p, r] = the column assigned to row r of problem p (the exact
//                   min-cost assignment of the first n_rows[p] rows of
//                   cost[p] (R, C), R <= C); -1 for rows at or past
//                   n_rows[p].
//
// The arithmetic is JAX's, step for step, in f32 with INF = 1e18:
//   r = ((min_val + cost[i, j]) - u[i]) - v[j], kept where the column is
//   unscanned and r < spc[j]; j = the first index of the least spc over the
//   unscanned columns; then the dual updates of hungarian.py:84-88 in that
//   order (u[cur] += min_val; u[r] += SR[r] && r != cur ? min_val -
//   spc[col4row[r]] : 0 over col4row from before the augmentation; v[j] -=
//   SC[j] ? min_val - spc[j] : 0) and the augmenting walk. There are no
//   products, so nothing contracts to an FMA, and the reduction breaks ties
//   by the lowest index: col4row equals JAX's bit for bit, ties included.
//
// What bounds it: latency, not bytes or operations. Each search step
// depends on the one before (one column scanned a step), so a problem is a
// chain of block-wide reductions; at the release shapes (64 problems of
// 100 x 256) a step reads one 1 KB cost row. Design: one CTA per problem,
// threads own columns (striding when C > blockDim); spc, path, SC, v and
// row4col live in shared memory over C, u, col4row and SR over R (about
// 5 KB at release shapes). Each step is one (value, index) min reduction:
// warp shuffles, then the warps' partials through shared memory; thread 0
// updates the step's scalars. n_rows[p] is read here, so the grid is always
// P and the host never reads a device value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInf = 1e18f;        // hungarian.py:21

__device__ __forceinline__ void take_min(float& val, int& idx, float ov,
                                         int oi) {
  if (ov < val || (ov == val && oi < idx)) {
    val = ov;
    idx = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
lap_kernel(const float* __restrict__ cost, const int* __restrict__ n_rows,
           int* __restrict__ out, int R, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* spc = reinterpret_cast<float*>(smem);          // (C,)
  float* v = spc + C;                                   // (C,)
  int* path = reinterpret_cast<int*>(v + C);            // (C,)
  int* row4col = path + C;                              // (C,)
  float* u = reinterpret_cast<float*>(row4col + C);     // (R,)
  int* col4row = reinterpret_cast<int*>(u + R);         // (R,)
  unsigned char* SC = reinterpret_cast<unsigned char*>(col4row + R);  // (C,)
  unsigned char* SR = SC + C;                           // (R,)

  __shared__ float red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int s_i, s_sink;
  __shared__ float s_min;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* cp = cost + static_cast<size_t>(p) * R * C;
  const int n = min(max(n_rows[p], 0), R);

  for (int j = tid; j < C; j += kThreads) {
    v[j] = 0.0f;
    row4col[j] = -1;
  }
  for (int r = tid; r < R; r += kThreads) {
    u[r] = 0.0f;
    col4row[r] = -1;
  }

  for (int cur = 0; cur < n; ++cur) {
    for (int j = tid; j < C; j += kThreads) {
      spc[j] = kInf;
      path[j] = -1;
      SC[j] = 0;
    }
    for (int r = tid; r < R; r += kThreads) SR[r] = 0;
    if (tid == 0) {
      s_i = cur;
      s_min = 0.0f;
      s_sink = -1;
    }
    __syncthreads();

    // the shortest augmenting path from row `cur` (hungarian.py:57-70)
    while (true) {
      const int i = s_i;
      const float min_val = s_min;
      if (tid == 0) SR[i] = 1;
      const float* row = cp + static_cast<size_t>(i) * C;
      const float ui = u[i];
      float best = __int_as_float(0x7f800000);   // +inf: above every value
      int bidx = C;
      for (int j = tid; j < C; j += kThreads) {
        float val = kInf;
        if (!SC[j]) {
          float r = min_val + row[j];
          r = r - ui;
          r = r - v[j];
          if (r < spc[j]) {
            spc[j] = r;
            path[j] = i;
          }
          val = spc[j];
        }
        if (val < best) {   // j rises: the first index wins a tie
          best = val;
          bidx = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_min(best, bidx, __shfl_down_sync(0xffffffffu, best, off),
                 __shfl_down_sync(0xffffffffu, bidx, off));
      if (lane == 0) {
        red_val[warp] = best;
        red_idx[warp] = bidx;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < kWarps ? red_val[lane] : __int_as_float(0x7f800000);
        bidx = lane < kWarps ? red_idx[lane] : C;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          take_min(best, bidx, __shfl_down_sync(0xffffffffu, best, off),
                   __shfl_down_sync(0xffffffffu, bidx, off));
        if (lane == 0) {
          s_min = best;
          SC[bidx] = 1;
          if (row4col[bidx] < 0) {
            s_sink = bidx;
          } else {
            s_i = row4col[bidx];
          }
        }
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }

    // dual updates (hungarian.py:84-88), col4row from before the augment
    const float min_val = s_min;
    for (int r = tid; r < R; r += kThreads) {
      float x = u[r];
      if (r == cur) x = x + min_val;
      const bool other = SR[r] && r != cur;
      const int c = min(max(col4row[r], 0), C - 1);
      x = x + (other ? min_val - spc[c] : 0.0f);
      u[r] = x;
    }
    for (int j = tid; j < C; j += kThreads)
      v[j] = v[j] - (SC[j] ? min_val - spc[j] : 0.0f);
    __syncthreads();

    // augment along the alternating path (hungarian.py:90-105)
    if (tid == 0) {
      int j = s_sink;
      while (true) {
        const int i = path[j];
        row4col[j] = i;
        const int nxt = col4row[i];
        col4row[i] = j;
        j = nxt;
        if (i == cur) break;
      }
    }
    __syncthreads();
  }

  int* op = out + static_cast<size_t>(p) * R;
  for (int r = tid; r < R; r += kThreads) op[r] = col4row[r];
}

// the dynamic shared memory of one CTA (kernels/lap.py:smem_bytes)
int smem_bytes(int R, int C) { return C * (4 * 4 + 1) + R * (4 * 2 + 1); }

}  // namespace

// cost (P, R, C) f32 contiguous, n_rows (P,) int32, out (P, R) int32, all on
// the device. Returns a cudaError_t (0 on success).
extern "C" int parq_lap_solve(const void* cost, const void* n_rows, void* out,
                              int P, int R, int C, void* stream) {
  if (R > C || R < 1 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const int smem = smem_bytes(R, C);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  lap_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_rows),
      static_cast<int*>(out), R, C);
  return static_cast<int>(cudaGetLastError());
}
