// The decoder's dropout keep masks, drawn on the card from device seeds.
//
// Not a TPU kernel: the counterpart of the JAX package's `_grouped_keep`
// (parq_tpu/models/decoder.py:76-87), which draws one bernoulli mask per
// iteration group from keys split and folded on the device (:707-709). The
// port draws each (iteration, salt) mask with the flash kernels' own v1
// counter hash (flash_common.cuh: keep_bit, the JAX package's `_keep_mask`,
// cross_attention_pallas.py:58), keyed by the (iteration, salt) seed, the
// GLOBAL batch row and the column:
//
//   out[b, g, j] = fmix32(seed_g * 2654435761 + (row0 + b) * 3266489917
//                         + j * 668265263) >= thresh
//
// with seed_g the low 32 bits of group g's int64 seed, read from device
// memory. So a mask depends only on (iteration, salt, shape): the fold's two
// phases, the sequential path and a recompute under REMAT draw the same
// bits, and a data-parallel rank (row0 = its first global row) draws those
// rows of the one-process mask. Its plain version is
// kernels/dropout.py:draw_keep_plain (kernels/cross_attention.py:keep_mask).
//
// What bounds it: bytes. One byte written an element and nothing read but
// G seeds: 160 M elements a release step (B=8, L=8, Q=256, dim 1024, FFN
// 768, both phases of the fold) are 160 MB, ~0.05 ms at 3.35 TB/s; the
// ~12 integer operations an element are far below the card's rate. The
// design follows: each thread hashes 16 consecutive columns of one
// (b, g) row and writes them with one 16-byte store (a row of M % 16 != 0
// takes one column a thread), in a grid-stride loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int kVec>
__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(const long long* __restrict__ seeds, long long seed_stride,
                 int G, long long M, int row0, uint32_t thresh,
                 long long chunks, uint8_t* __restrict__ out) {
  const long long per_row = M / kVec;          // chunks of one (b, g) row
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * kThreads) {
    const long long bg = i / per_row;
    const int g = static_cast<int>(bg % G);
    const uint32_t b = static_cast<uint32_t>(bg / G);
    const uint32_t seed = static_cast<uint32_t>(seeds[g * seed_stride]);
    const uint32_t h0 = seed * 2654435761u;    // the (b*H + h) term is 0
    const uint32_t row = static_cast<uint32_t>(row0) + b;
    const uint32_t col0 = static_cast<uint32_t>((i - bg * per_row) * kVec);
    uint8_t bits[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      bits[k] = parq::keep_bit<false>(h0, row, col0 + k, thresh);
    uint8_t* dst = out + bg * M + col0;
    if (kVec == 16) {
      uint4 v;
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = bits[4 * k] | bits[4 * k + 1] << 8 | bits[4 * k + 2] << 16 |
               static_cast<uint32_t>(bits[4 * k + 3]) << 24;
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) dst[k] = bits[k];
    }
  }
}

}  // namespace

// seeds: G int64 seeds at a stride of seed_stride elements (a column of the
// decoder's (L, 6) seed table), on the card; out: (B, G, M) bytes (0/1,
// torch.bool), contiguous. rows are row0 .. row0 + B - 1 of the global
// batch. A 16-byte aligned out with M % 16 == 0 takes the vector path.
// Returns the launch's cudaError_t.
extern "C" int parq_keep_mask(const void* seeds, long long seed_stride,
                              int B, int G, long long M, int row0,
                              unsigned thresh, void* out, int sms,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = M % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long chunks = (long long)B * G * (vec ? M / 16 : M);
  if (chunks <= 0) return cudaSuccess;
  long long blocks = (chunks + kThreads - 1) / kThreads;
  const long long most = 8LL * (sms > 0 ? sms : 132);  // then grid-stride
  if (blocks > most) blocks = most;
  const long long* sd = static_cast<const long long*>(seeds);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (vec)
    keep_mask_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(
        sd, seed_stride, G, M, row0, thresh, chunks, o);
  else
    keep_mask_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        sd, seed_stride, G, M, row0, thresh, chunks, o);
  return static_cast<int>(cudaGetLastError());
}
