// What the flash cross-attention translation units share: the dropout draw
// (the JAX package's v1 counter hash, bit for bit), the softmax constants,
// and the host entry points of the Hopper (wgmma + TMA) kernels, which
// cross_attention.cu dispatches to for bf16 at D = 256.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace parq {

constexpr float kMaskValue = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// Dropout of the train form. `thresh` == 0 means no dropout.
struct Dropout {
  const int* seeds;   // (G,) device seeds, one per group of `group_rows`
  int group_rows;     // Q / G
  uint32_t thresh;    // min(floor(rate * 2^32), 2^32 - 1)
  float keep_scale;   // 1 / (1 - rate)
};

// h0 of a global q row: seed of its group ^ the (b*H + h) term
__device__ __forceinline__ uint32_t row_h0(const Dropout& d, int bh,
                                           int row) {
  const uint32_t seed = static_cast<uint32_t>(d.seeds[row / d.group_rows]);
  return seed * 2654435761u ^ static_cast<uint32_t>(bh) * 2246822519u;
}

// murmur3 fmix32 of (h0, group-local row, global col): the v1 hash
__device__ __forceinline__ bool keep_bit(uint32_t h0, uint32_t row,
                                         uint32_t col, uint32_t thresh) {
  uint32_t h = h0 + row * 3266489917u + col * 668265263u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= thresh;
}

// The Hopper kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu): bf16, D = 256.
namespace sm90 {

constexpr int kD = 256;       // head dim the kernels are written for
constexpr int kMaxSplits = 4; // most KV splits the forward takes
constexpr int kBoxes = kD / 64;  // TMA boxes (64 bf16 columns) per tile row
constexpr int kConsumers = 2;    // consumer warpgroups of a CTA
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's

// B2, both forms (lse == nullptr: eval). With splits > 1 each q tile's KV
// range is cut into `splits` runs of whole 64-token blocks, each CTA writes
// a normalised f32 partial into part_o (splits, B, H, Q, D) and its
// base-2 logsumexp into part_lse (splits, B, H, Q), and a combine kernel
// merges them into o (and lse). Every split must own at least one block.
cudaError_t flash_fwd(const void* q, const void* kv, void* o, float* lse,
                      float* part_o, float* part_lse, int splits,
                      Dropout drop, int B, int H, int Q, int N,
                      cudaStream_t stream);

// B3: the dkv pass, then the dq pass.
cudaError_t flash_bwd(const void* q, const void* kv, const void* dout,
                      const float* lse, const float* delta, Dropout drop,
                      void* dq, void* dkv, int B, int H, int Q, int N,
                      cudaStream_t stream);

// The building blocks on one tile: c1 (64, 64) f32 = a (64, 64) bf16 times
// b (64, 64) bf16 transposed (both K-major, from shared memory), and c2
// (64, 256) f32 = bf16(c1) (from registers) times v (64, 256) bf16 read
// MN-major.
cudaError_t wgmma_selftest(const void* a, const void* b, const void* v,
                           float* c1, float* c2, cudaStream_t stream);

}  // namespace sm90
}  // namespace parq
