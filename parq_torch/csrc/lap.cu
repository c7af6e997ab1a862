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
//   columns (a scanned one counts as INF); then the dual updates of
//   hungarian.py:84-88 in that order (u[cur] += min_val; u[r] += min_val -
//   spc[col4row[r]] for the other rows the search visited, over col4row
//   from before the augmentation; v[j] -= min_val - spc[j] for the scanned
//   columns) and the augmenting walk. There are no products, so nothing
//   contracts to an FMA, and the minimum breaks ties by the lowest index:
//   col4row equals JAX's bit for bit, ties included.
//
// What bounds it: latency, not bytes or operations. Each search step
// depends on the one before (one column scanned a step), so a problem is a
// chain of reductions over its columns, and a step's cost is the length of
// its dependent chain: a cost row read from L2/HBM at an index the step
// before chose, a block barrier, a broadcast through shared memory each
// add one. The design keeps every one of them off the chain.
//
// Design: one warp a problem, no block barrier in the search.
//   - The problem's first n_rows[p] cost rows are copied into shared memory
//     by cp.async.bulk in chunks of rows, each completing on its own
//     mbarrier; the first chunk is issued before n_rows[p] is read, the rest
//     before the bookkeeping is initialised, and search `cur` waits only
//     for the chunk that holds row `cur` (a search reads rows <= cur). Rows
//     past the shared-memory budget, or all rows when a row is not a
//     multiple of 16 bytes, are read from global memory in the same kernel.
//   - Lane l owns columns l + 32k. Its spc, v, path and scanned bits live
//     in registers for C <= 1024 (in shared memory past that); the slots
//     past C count as scanned from the start, so no step tests j < C. A
//     step is straight-line code: every slot's value, then a lane-local
//     tree and a warp reduction (__reduce_min_sync) on an order-preserving
//     key of value + 0 (-0 and +0 are one value, as the float compare has
//     it), then the same on the indices holding that key: every lane has
//     the winner (least value, then least index), nothing is broadcast.
//   - row4col, col4row and u live in shared memory, ordered by __syncwarp.
//     The rows a search visited other than `cur` are those its steps
//     reached through row4col, and a scanned column's spc is its step's
//     minimum: lane t % 32 keeps step t's (row, minimum) in registers
//     (shared memory past 32 steps), so the dual update of u is one
//     read-modify-write a lane, no per-row flag and no search over rows.
//   - The augmenting walk reads path[j] from its owner by a shuffle; lane 0
//     writes row4col and col4row.
// n_rows[p] is read here, so the grid is always P and the host never reads
// a device value. Its times beside the first design's: PERF.md §6.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kInf = 1e18f;        // hungarian.py:21
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChunks = 32;        // mbarriers of the staged rows
constexpr int kHead = kMaxChunks * 8; // their bytes, before the rows
constexpr int kRegCols = 32;          // columns a lane keeps in registers
constexpr int kPad = kRegCols * 32 * 4;  // after the rows: see scan_row

// unsigned order of the key = float order of the value; -0 maps as +0
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t b = __float_as_uint(__fadd_rn(f, 0.0f));
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// A lane's columns lane + 32k, k < kCols, in registers (kCols > 0; every
// index below is a compile-time constant once the loops unroll), or in
// shared memory indexed by column (kCols == 0). Slots at or past C are
// "fake": they start every search scanned and take part in nothing.
template <int kCols>
struct Columns {
  float spc_[kCols], v_[kCols];
  int path_[kCols];
  uint32_t sc_ = 0, fake_ = 0;
  __device__ Columns(unsigned char*, int C, int lane) {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (lane + 32 * k >= C) fake_ |= 1u << k;
  }
  __device__ int slots() const { return kCols; }
  __device__ float& spc(int k) { return spc_[k]; }
  __device__ float& v(int k) { return v_[k]; }
  __device__ int& path(int k) { return path_[k]; }
  __device__ bool scanned(int k) const { return (sc_ >> k) & 1u; }
  __device__ bool real(int k) const { return !((fake_ >> k) & 1u); }
  __device__ void scan(int k) { sc_ |= 1u << k; }
  __device__ void unscan_all() { sc_ = fake_; }
  __device__ int path_of_slot(int slot) const {
    int r = -1;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (k == slot) r = path_[k];
    return r;
  }
};

template <>
struct Columns<0> {
  float* spc_;
  float* v_;
  int* path_;
  unsigned char* sc_;
  int lane_, slots_, C_;
  // `base`: 13 bytes a column over the columns rounded up to 32
  __device__ Columns(unsigned char* base, int C, int lane)
      : lane_(lane), slots_((C + 31) >> 5), C_(C) {
    const int cp = slots_ * 32;
    spc_ = reinterpret_cast<float*>(base);
    v_ = spc_ + cp;
    path_ = reinterpret_cast<int*>(v_ + cp);
    sc_ = reinterpret_cast<unsigned char*>(path_ + cp);
  }
  __device__ int slots() const { return slots_; }
  __device__ float& spc(int k) { return spc_[k * 32 + lane_]; }
  __device__ float& v(int k) { return v_[k * 32 + lane_]; }
  __device__ int& path(int k) { return path_[k * 32 + lane_]; }
  __device__ bool scanned(int k) const { return sc_[k * 32 + lane_]; }
  __device__ bool real(int k) const { return k * 32 + lane_ < C_; }
  __device__ void scan(int k) { sc_[k * 32 + lane_] = 1; }
  __device__ void unscan_all() {
    for (int k = 0; k < slots_; ++k) sc_[k * 32 + lane_] = !real(k);
  }
  __device__ int path_of_slot(int slot) const {
    return path_[slot * 32 + lane_];
  }
};

// One search step's scan of row i (hungarian.py:57-66): spc and path of the
// unscanned columns lowered where ((min_val + row[j]) - ui) - v[j] is
// below spc[j]; returns (the least key over the columns, a scanned one
// counting as INF, and the least index holding it). `row` points at the
// lane's column 0 (row + lane). A staged row is read as it is: the fake
// slots read past it, into the next row or the pad after the rows. A row in
// global memory (`global`) is read at min(32k, last), last = C - 1 - lane.
template <int kCols>
__device__ __forceinline__ void scan_row(Columns<kCols>& cols,
                                         const float* row, bool global,
                                         int last, int i, float min_val,
                                         float ui, int lane, uint32_t& kmin,
                                         int& jmin) {
  if constexpr (kCols > 0) {
    float x[kCols];
    uint32_t key[kCols], m[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      x[k] = row[global ? min(32 * k, last) : 32 * k];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      float r = min_val + x[k];
      r = r - ui;
      r = r - cols.v(k);
      const bool sc = cols.scanned(k);
      const bool lower = !sc && r < cols.spc(k);
      cols.spc(k) = lower ? r : cols.spc(k);
      cols.path(k) = lower ? i : cols.path(k);
      key[k] = order_key(sc ? kInf : cols.spc(k));
      m[k] = key[k];
    }
#pragma unroll
    for (int w = 1; w < kCols; w *= 2)
#pragma unroll
      for (int k = 0; k + w < kCols; k += 2 * w) m[k] = min(m[k], m[k + w]);
    kmin = __reduce_min_sync(kFull, m[0]);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      m[k] = key[k] == kmin ? static_cast<uint32_t>(lane + 32 * k)
                            : 0xffffffffu;
#pragma unroll
    for (int w = 1; w < kCols; w *= 2)
#pragma unroll
      for (int k = 0; k + w < kCols; k += 2 * w) m[k] = min(m[k], m[k + w]);
    jmin = static_cast<int>(__reduce_min_sync(kFull, m[0]));
  } else {
    uint32_t best = 0xffffffffu;
    int bidx = 0x7fffffff;
    for (int k = 0; k < cols.slots(); ++k) {
      const float xk = row[global ? min(32 * k, last) : 32 * k];
      float val = kInf;
      if (!cols.scanned(k)) {
        float r = min_val + xk;
        r = r - ui;
        r = r - cols.v(k);
        if (r < cols.spc(k)) {
          cols.spc(k) = r;
          cols.path(k) = i;
        }
        val = cols.spc(k);
      }
      const uint32_t key = order_key(val);
      if (key < best) {   // k rises: the first index wins a tie
        best = key;
        bidx = lane + 32 * k;
      }
    }
    kmin = __reduce_min_sync(kFull, best);
    jmin = static_cast<int>(__reduce_min_sync(
        kFull, best == kmin ? static_cast<uint32_t>(bidx) : 0xffffffffu));
  }
}

// cap: rows a problem may stage; rpc: rows a chunk (cap <= rpc * kMaxChunks)
template <int kCols>
__global__ void __launch_bounds__(32)
lap_kernel(const float* __restrict__ cost, const int* __restrict__ n_rows,
           int* __restrict__ out, int R, int C, int cap, int rpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* rows = reinterpret_cast<float*>(smem + kHead);        // (cap, C)
  int* row4col = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(rows + static_cast<size_t>(cap) * C)
      + kPad);                                                  // (C,)
  int* col4row = row4col + C;                                   // (R,)
  float* u = reinterpret_cast<float*>(col4row + R);             // (R,)
  int* rec_rows = reinterpret_cast<int*>(u + R);                // (C,)
  float* rec_mins = reinterpret_cast<float*>(rec_rows + C);     // (C,)
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const float* cp = cost + static_cast<size_t>(p) * R * C;

  // the first chunk of rows, before n_rows[p] is known
  const int first = min(rpc, cap);
  if (lane == 0 && first > 0) {
    hopper::mbar_init(&bars[0], 1);
    hopper::mbar_init_fence();
    hopper::mbar_arrive_expect_tx(&bars[0], first * C * 4);
    hopper::bulk_load(rows, cp, first * C * 4, &bars[0]);
  }
  const int n = min(max(n_rows[p], 0), R);
  const int staged = min(n, cap);
  if (lane == 0) {
    const int chunks = (staged + rpc - 1) / rpc;
    for (int c = 1; c < chunks; ++c) hopper::mbar_init(&bars[c], 1);
    hopper::mbar_init_fence();
    for (int c = 1; c < chunks; ++c) {
      const int r0 = c * rpc;
      const uint32_t bytes = min(rpc, staged - r0) * C * 4;
      hopper::mbar_arrive_expect_tx(&bars[c], bytes);
      hopper::bulk_load(rows + static_cast<size_t>(r0) * C,
                        cp + static_cast<size_t>(r0) * C, bytes, &bars[c]);
    }
  }

  Columns<kCols> cols(reinterpret_cast<unsigned char*>(rec_mins + C), C,
                      lane);
#pragma unroll
  for (int k = 0; k < cols.slots(); ++k) cols.v(k) = 0.0f;
  for (int j = lane; j < C; j += 32) row4col[j] = -1;
  for (int r = lane; r < R; r += 32) {
    u[r] = 0.0f;
    col4row[r] = -1;
  }
  __syncwarp();

  int chunk = 0;   // the next chunk to wait for, at row chunk * rpc
  for (int cur = 0; cur < n; ++cur) {
    if (cur < staged && cur == chunk * rpc) hopper::mbar_wait(&bars[chunk++], 0);
#pragma unroll
    for (int k = 0; k < cols.slots(); ++k) {
      cols.spc(k) = kInf;
      cols.path(k) = -1;
    }
    cols.unscan_all();

    // the shortest augmenting path from row `cur` (hungarian.py:57-70)
    int i = cur;
    float min_val = 0.0f;
    int sink, steps = 0;
    int rec_row = -1;        // step lane + 32t's row (-1: none, the sink)
    float rec_min = 0.0f;    // and its minimum, the spc of its column
    while (true) {
      const float ui = u[i];
      uint32_t kmin;
      int j;
      if (i < staged)
        scan_row(cols, rows + static_cast<size_t>(i) * C + lane, false, 0,
                 i, min_val, ui, lane, kmin, j);
      else
        scan_row(cols, cp + static_cast<size_t>(i) * C + lane, true,
                 C - 1 - lane, i, min_val, ui, lane, kmin, j);
      min_val = key_value(kmin);
      if ((j & 31) == lane) cols.scan(j >> 5);
      const int next = row4col[j];
      if (lane == (steps & 31)) {
        rec_row = next;
        rec_min = min_val;
      }
      if ((steps & 31) == 31) {   // a round of 32 records to shared memory
        rec_rows[steps - 31 + lane] = rec_row;
        rec_mins[steps - 31 + lane] = rec_min;
      }
      ++steps;
      if (next < 0) {
        sink = j;
        break;
      }
      i = next;
    }

    // dual updates (hungarian.py:84-88), col4row from before the augment
    __syncwarp();
#pragma unroll
    for (int k = 0; k < cols.slots(); ++k)
      if (cols.scanned(k) && cols.real(k))
        cols.v(k) = cols.v(k) - (min_val - cols.spc(k));
    const int flushed = steps & ~31;
    for (int t = lane; t < flushed; t += 32) {
      const int r = rec_rows[t];
      if (r >= 0) u[r] = u[r] + (min_val - rec_mins[t]);
    }
    if (flushed + lane < steps && rec_row >= 0)
      u[rec_row] = u[rec_row] + (min_val - rec_min);
    if (lane == 0) u[cur] = (u[cur] + min_val) + 0.0f;
    __syncwarp();

    // augment along the alternating path (hungarian.py:90-105)
    int j = sink;
    while (true) {
      const int r = __shfl_sync(kFull, cols.path_of_slot(j >> 5), j & 31);
      const int nxt = col4row[r];
      __syncwarp();
      if (lane == 0) {
        row4col[j] = r;
        col4row[r] = j;
      }
      if (r == cur) break;
      j = nxt;
    }
    __syncwarp();
  }
  if (first > 0 && staged == 0) hopper::mbar_wait(&bars[0], 0);

  int* op = out + static_cast<size_t>(p) * R;
  for (int r = lane; r < R; r += 32) op[r] = col4row[r];
}

int column_slots(int C) { return (C + 31) / 32; }

// shared memory besides the staged rows (kernels/lap.py:smem_plan)
int fixed_bytes(int R, int C) {
  const int slots = column_slots(C);
  return kHead + kPad + C * 4 + R * 8 + C * 8
         + (slots > kRegCols ? slots * 32 * 13 : 0);
}

template <int kCols>
cudaError_t launch(const float* cost, const int* n_rows, int* out, int P,
                   int R, int C, int cap, int rpc, int smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  lap_kernel<kCols><<<P, 32, smem, stream>>>(cost, n_rows, out, R, C, cap,
                                            rpc);
  return cudaGetLastError();
}

}  // namespace

// cost (P, R, C) f32 contiguous, n_rows (P,) int32, out (P, R) int32, all on
// the device. Returns a cudaError_t (0 on success).
extern "C" int parq_lap_solve(const void* cost, const void* n_rows, void* out,
                              int P, int R, int C, void* stream) {
  if (R > C || R < 1 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  int dev = 0, budget = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fixed = fixed_bytes(R, C);
  if (fixed > budget) return static_cast<int>(cudaErrorInvalidValue);
  // cp.async.bulk moves multiples of 16 bytes between 16-byte addresses
  const bool whole = C % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0;
  const int cap = whole ? min(R, (budget - fixed) / (C * 4)) : 0;
  const int rpc = cap > 0 ? (cap + kMaxChunks - 1) / kMaxChunks : 1;
  const int smem = fixed + cap * C * 4;
  const auto* c = static_cast<const float*>(cost);
  const auto* nr = static_cast<const int*>(n_rows);
  auto* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = column_slots(C);
  if (slots <= 1) err = launch<1>(c, nr, o, P, R, C, cap, rpc, smem, s);
  else if (slots <= 2) err = launch<2>(c, nr, o, P, R, C, cap, rpc, smem, s);
  else if (slots <= 4) err = launch<4>(c, nr, o, P, R, C, cap, rpc, smem, s);
  else if (slots <= 8) err = launch<8>(c, nr, o, P, R, C, cap, rpc, smem, s);
  else if (slots <= 16) err = launch<16>(c, nr, o, P, R, C, cap, rpc, smem, s);
  else if (slots <= kRegCols)
    err = launch<kRegCols>(c, nr, o, P, R, C, cap, rpc, smem, s);
  else err = launch<0>(c, nr, o, P, R, C, cap, rpc, smem, s);
  return static_cast<int>(err);
}
