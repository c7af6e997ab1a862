// What the flash cross-attention translation units share: the dropout draw
// (the JAX package's v1 and v2 counter hashes, bit for bit), the strided
// view of K and V (and of dK and dV) every kernel reads and writes, the
// softmax constants, and the host entry points of the Hopper (wgmma + TMA)
// kernels, which cross_attention.cu dispatches to for bf16 at D = 256.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace parq {

constexpr float kMaskValue = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// One of K, V, dK and dV: element (b, h, n, d) of head h of sample b lies
// at ptr + b * batch + h * head + n * row + d (strides in elements). The
// fused (B, N, H*2D) buffer is K at ptr = kv, V at ptr = kv + D, both with
// row 2HD, head 2D, batch N*2HD; the natural (B, N, H*D) layout has row HD,
// head D; the legacy (B, H, N, D) layout row D, head N*D, batch H*N*D. N
// may be less than the rows the buffer holds (n_valid): rows past it are
// never read or written.
struct KV {
  void* ptr;
  long long row, batch, head;
};

template <typename T>
__host__ __device__ __forceinline__ T* kv_at(const KV& t, int b, int h) {
  return static_cast<T*>(t.ptr) + b * t.batch + h * t.head;
}

// Dropout of the train form. `thresh` == 0 means no dropout.
struct Dropout {
  const int* seeds;   // (G,) device seeds, one per group of `group_rows`
  int group_rows;     // Q / G
  uint32_t thresh;    // min(floor(rate * 2^32), 2^32 - 1)
  float keep_scale;   // 1 / (1 - rate)
  int b_offset;       // the global batch index of this call's sample 0
  int v2;             // 1: the v2 hash (PARQ_DROPOUT_HASH=v2), 0: v1
};

// the (b*H + h) term of the hash, with b the GLOBAL batch index
__device__ __forceinline__ int drop_bh(const Dropout& d, int b, int H,
                                       int h) {
  return (d.b_offset + b) * H + h;
}

// h0 of a global q row: seed of its group ^ the (b*H + h) term
__device__ __forceinline__ uint32_t row_h0(const Dropout& d, int bh,
                                           int row) {
  const uint32_t seed = static_cast<uint32_t>(d.seeds[row / d.group_rows]);
  return seed * 2654435761u ^ static_cast<uint32_t>(bh) * 2246822519u;
}

// The keep bit of (h0, group-local row, global col).
//   v1: murmur3 fmix32 of h0 + row * 3266489917 + col * 668265263;
//   v2: a row term and a column term, each mixed once, added, and one
//       xorshift-multiply-xorshift round (cross_attention_pallas.py:87-106).
template <bool kV2>
__device__ __forceinline__ bool keep_bit(uint32_t h0, uint32_t row,
                                         uint32_t col, uint32_t thresh) {
  uint32_t h;
  if (kV2) {
    uint32_t rv = (h0 + row) * 3266489917u;
    rv ^= rv >> 15;
    rv *= 0x85EBCA6Bu;
    uint32_t cv = col * 668265263u;
    cv ^= cv >> 13;
    cv *= 0xC2B2AE35u;
    h = rv + cv;
    h ^= h >> 16;
    h *= 0x7FEB352Du;
    h ^= h >> 15;
  } else {
    h = h0 + row * 3266489917u + col * 668265263u;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
  }
  return h >= thresh;
}

// the hash the call asks for (a uniform branch)
__device__ __forceinline__ bool keep_bit(const Dropout& d, uint32_t h0,
                                         uint32_t row, uint32_t col) {
  return d.v2 ? keep_bit<true>(h0, row, col, d.thresh)
              : keep_bit<false>(h0, row, col, d.thresh);
}

// The Hopper kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu): bf16, D = 256.
namespace sm90 {

constexpr int kD = 256;       // head dim the kernels are written for
constexpr int kMaxSplits = 16;  // most KV splits B2 and B3's dq pass take
constexpr int kBoxes = kD / 64;  // TMA boxes (64 bf16 columns) per tile row
constexpr int kConsumers = 2;    // consumer warpgroups of a CTA
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's

// Where head h of sample b of a KV view starts in the 3-D tensor map
// (cols, rows, z) the Hopper kernels load it through: column h * hc, z
// index b * zb + h * zh.
struct TmaCoord {
  int hc, zb, zh;
};

// The 3-D view a tensor map takes of `t` (N rows of D columns per head):
// heads side by side in a row (fused and natural layouts: cols spans every
// head's columns, z is the sample), or heads in planes of their own (the
// legacy layout: cols = D, z = b * H + h, the samples' planes back to back).
// Returns false for a view that is neither.
struct KVMap {
  uint64_t cols, rows, z, row_stride, z_stride;
  TmaCoord at;
};

inline bool kv_map(const KV& t, int B, int H, int N, int D, KVMap* m) {
  m->rows = N;
  m->row_stride = t.row;
  if (H == 1 || t.head < t.row) {
    m->cols = (uint64_t)(H - 1) * (H == 1 ? 0 : t.head) + D;
    if ((long long)m->cols > t.row && N > 1) return false;
    m->z = B;
    m->z_stride = t.batch;
    m->at = TmaCoord{H == 1 ? 0 : (int)t.head, 1, 0};
    return true;
  }
  if (B > 1 && t.batch != H * t.head) return false;
  m->cols = D;
  m->z = (uint64_t)B * H;
  m->z_stride = t.head;
  m->at = TmaCoord{0, H, 1};
  return true;
}

// The tensor map (a CUtensorMap) of a KV view for boxes of box_rows x 64,
// and where each head starts in it (flash_fwd_sm90.cu).
cudaError_t make_kv_map(void* map, TmaCoord* at, const KV& t, int B, int H,
                        int N, uint32_t box_rows);

// B2, both forms (lse == nullptr: eval). With splits > 1 each q tile's KV
// range is cut into `splits` runs of whole 64-token blocks, each CTA writes
// a normalised f32 partial into part_o (splits, B, H, Q, D) and its
// base-2 logsumexp into part_lse (splits, B, H, Q), and a combine kernel
// merges them into o (and lse). Every split must own at least one block.
cudaError_t flash_fwd(const void* q, const KV& k, const KV& v, void* o,
                      float* lse, float* part_o, float* part_lse, int splits,
                      Dropout drop, int B, int H, int Q, int N,
                      cudaStream_t stream);

// B3: the dkv pass, then the dq pass. dK and dV are written through their
// own views (for the fused layout both point into one dKV buffer). With
// dq_splits > 1 the dq pass cuts each q tile's KV range into that many runs
// of whole 64-token blocks, as the forward does, each CTA writing an f32
// partial into dq_part (dq_splits, B, H, Q, D), and a combine kernel adds
// them in split order into dq. Every split must own at least one block.
cudaError_t flash_bwd(const void* q, const KV& k, const KV& v,
                      const void* dout, const float* lse, const float* delta,
                      Dropout drop, void* dq, const KV& dk, const KV& dv,
                      float* dq_part, int dq_splits, int B, int H, int Q,
                      int N, cudaStream_t stream);

// The building blocks on one tile: c1 (64, 64) f32 = a (64, 64) bf16 times
// b (64, 64) bf16 transposed (both K-major, from shared memory), and c2
// (64, 256) f32 = bf16(c1) (from registers) times v (64, 256) bf16 read
// MN-major.
cudaError_t wgmma_selftest(const void* a, const void* b, const void* v,
                           float* c1, float* c2, cudaStream_t stream);

}  // namespace sm90
}  // namespace parq
