// Kernel B4: d(memory) of the pixel-aligned bilinear sampler, for Hopper
// (sm_90a).
//
// Replaces parq_tpu/kernels/pixel_align_pallas.py:_pallas_sample_bwd_mem
// (:280), body _sample_bwd_mem_kernel (:216): the transpose of the sampler
// (kernel B1, pixel_align.cu),
//
//   dmem[b, t, y, x, :] += scale[b,t,q] * w_tap * g[b, q, :]
//
// over the <= 4 in-bounds bilinear taps of every (b, t, q). The bounds test
// is B1's, in float: a point behind the camera projects far off the image,
// and converting such a coordinate to int first would overflow.
//
// The TPU kernel builds a dense (pixels x Q) weight tile in VMEM and runs
// W^T @ g on the MXU, accumulating the q tiles of one output block in VMEM
// in grid order. On the card the transpose of a gather is a scatter: many
// (q, t) pairs hit the same pixel (neighbouring queries share taps, and on
// the training path all 8 folded iterations scatter into one map), so the
// sums go through f32 atomics into a zeroed f32 scratch of the memory's
// shape, which the caller casts once to the memory dtype. The JAX kernel
// accumulates its q tiles in the memory dtype; f32 accumulation is more
// precise, and the order of the atomic adds changes from run to run, so
// two runs may differ in the last f32 bit.
//
// What bounds it: bytes. The work is 4 taps x C multiply-adds per (b, t, q);
// the bytes are one write of dmem (236 MB in bf16 at the release shape,
// B=8, T=3, 60x80, C=1024) plus g and the (u, v, scale) rows, ~0.08 ms at
// 3.35 TB/s. The atomics land in L2 (f32 scratch: 472 MB; it does not fit
// in the 50 MB L2, so each touched line goes to memory at least once more).
//
// Design: B1's thread layout. Threads run along C, each owning 16 bytes of
// g (8 bf16 or 4 f32 channels), read once; a CTA holds 256 / (C / V)
// queries of one batch element. For each view and tap a thread issues its
// channels' atomic adds (fire-and-forget RED.ADD.F32 at consecutive
// addresses across the warp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
sample_bwd_mem_kernel(const float4* __restrict__ uvs, const T* __restrict__ g,
                      float* __restrict__ dmem, int n_views, int H, int W,
                      int C, int Q) {
  constexpr int V = 16 / sizeof(T);  // channels per 16-byte load of g
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.y + threadIdx.y;
  if (q >= Q) return;
  const long long map_elems = (long long)H * W * C;

  for (int c0 = threadIdx.x * V; c0 < C; c0 += blockDim.x * V) {
    float gv[V];
    load16(g + ((long long)b * Q + q) * C + c0, gv);
    for (int t = 0; t < n_views; ++t) {
      const float4 p = uvs[((long long)b * n_views + t) * Q + q];
      const float x0 = floorf(p.x), y0 = floorf(p.y);
      const float wx1 = p.x - x0, wy1 = p.y - y0;
      const float wx[2] = {1.f - wx1, wx1};
      const float wy[2] = {1.f - wy1, wy1};
      float* map = dmem + ((long long)b * n_views + t) * map_elems + c0;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float yf = y0 + dy;
        if (!(yf >= 0.f && yf <= (float)(H - 1))) continue;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float xf = x0 + dx;
          if (!(xf >= 0.f && xf <= (float)(W - 1))) continue;
          const float w = wx[dx] * wy[dy] * p.z;
          float* dst = map + ((long long)yf * W + (long long)xf) * C;
#pragma unroll
          for (int i = 0; i < V; ++i) atomicAdd(dst + i, w * gv[i]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* uvs, const void* g, void* dmem, int B,
                   int n_views, int H, int W, int C, int Q,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  int tx = C / V;
  if (tx > 256) tx = 256;
  const int ty = 256 / tx;
  const dim3 block(tx, ty);
  const dim3 grid((Q + ty - 1) / ty, B);
  sample_bwd_mem_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const float4*>(uvs), static_cast<const T*>(g),
      static_cast<float*>(dmem), n_views, H, W, C, Q);
  return cudaGetLastError();
}

}  // namespace

// uvs (B, T, Q, 4) f32 rows [u, v, scale, unused]; g (B, Q, C) contiguous,
// bf16 (is_bf16=1) or f32; dmem (B, T, H, W, C) f32, zeroed by the caller:
// the kernel adds into it. C must be a multiple of 8 and every pointer
// 16-byte aligned (the Python wrapper checks both). Returns the launch's
// cudaError_t.
extern "C" int parq_sample_views_bwd_mem(const void* uvs, const void* g,
                                         void* dmem, int B, int n_views,
                                         int H, int W, int C, int Q,
                                         int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(uvs, g, dmem, B, n_views, H, W, C, Q, s)
              : launch<float>(uvs, g, dmem, B, n_views, H, W, C, Q, s);
  return static_cast<int>(err);
}
