// Kernel B1: pixel-aligned bilinear sampler, forward, for Hopper (sm_90a).
//
// Replaces parq_tpu/kernels/pixel_align_pallas.py:_pallas_sample (:168),
// body _sample_kernel (:136) with _build_w_tile_t / _build_w_tile. The TPU
// kernel phrases the sampler as a sparse-weight matrix product (a (Q, H*W)
// weight tile built in VMEM times the (H*W, C) map on the MXU), because the
// TPU has no fast gather. On the card the sampler is what it computes: a
// gather of at most 4 taps per (query, view).
//
//   out[b, q, :] = sum_t scale[b,t,q] * sum_{taps} w_tap * mem[b, t, y, x, :]
//
// with align_corners=True pixel coordinates (u, v), bilinear weights, and
// zero padding: a tap outside [0, W-1] x [0, H-1] contributes nothing. The
// sum runs over every view; `scale` (1 / valid-view count, computed outside
// the kernel as _project_uvs does in JAX) is the only place validity enters.
//
// What bounds it: bytes. Each (b, q) reads at most T*4 rows of C channels
// (C*2 bytes in bf16) and writes C floats; there are ~2 FLOP per byte read,
// far below the card's ~295 FLOP/byte ridge. At the release shape
// (B=8, T=3, Q=256, C=1024, bf16) that is at most ~50 MB gathered plus 8 MB
// written, ~17 us at 3.35 TB/s; neighbouring queries share taps, which L2
// serves.
//
// Design for that bound: threads run along C, each loading 16 bytes
// (8 bf16 or 4 f32) of a channels-last row, so a warp reads 512 contiguous
// bytes per tap; a CTA holds (256 / threads-per-row) queries of one batch
// element, so there are enough CTAs (B*Q/2 at release) to keep many loads in
// flight on all 132 SMs. Sums are f32 in registers, written once as f32.

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
sample_views_kernel(const T* __restrict__ mem, const float4* __restrict__ uvs,
                    float* __restrict__ out, int n_views, int H, int W, int C,
                    int Q) {
  constexpr int V = 16 / sizeof(T);  // channels per 16-byte load
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.y + threadIdx.y;
  if (q >= Q) return;
  const long long map_elems = (long long)H * W * C;

  for (int c0 = threadIdx.x * V; c0 < C; c0 += blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;

    for (int t = 0; t < n_views; ++t) {
      const float4 p = uvs[((long long)b * n_views + t) * Q + q];
      const float x0 = floorf(p.x), y0 = floorf(p.y);
      const float wx1 = p.x - x0, wy1 = p.y - y0;
      const float wx[2] = {1.f - wx1, wx1};
      const float wy[2] = {1.f - wy1, wy1};
      const T* map = mem + ((long long)b * n_views + t) * map_elems + c0;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float yf = y0 + dy;
        // compare in float: a point behind the camera projects far off the
        // image, and converting such a coordinate to int first would overflow
        if (!(yf >= 0.f && yf <= (float)(H - 1))) continue;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float xf = x0 + dx;
          if (!(xf >= 0.f && xf <= (float)(W - 1))) continue;
          const float w = wx[dx] * wy[dy] * p.z;
          float v[V];
          load16(map + ((long long)yf * W + (long long)xf) * C, v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(w, v[i], acc[i]);
        }
      }
    }
    float* o = out + ((long long)b * Q + q) * C + c0;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(o + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
}

template <typename T>
cudaError_t launch(const void* mem, const void* uvs, void* out, int B,
                   int n_views, int H, int W, int C, int Q,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  int tx = C / V;
  if (tx > 256) tx = 256;
  const int ty = 256 / tx;
  const dim3 block(tx, ty);
  const dim3 grid((Q + ty - 1) / ty, B);
  sample_views_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(mem), static_cast<const float4*>(uvs),
      static_cast<float*>(out), n_views, H, W, C, Q);
  return cudaGetLastError();
}

}  // namespace

// memory (B, T, H, W, C) contiguous, bf16 (is_bf16=1) or f32; uvs
// (B, T, Q, 4) f32 rows [u, v, scale, unused]; out (B, Q, C) f32.
// C must be a multiple of 8 and every pointer 16-byte aligned (the Python
// wrapper checks both). Returns the launch's cudaError_t.
extern "C" int parq_sample_views(const void* mem, const void* uvs, void* out,
                                 int B, int n_views, int H, int W, int C,
                                 int Q, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(mem, uvs, out, B, n_views, H, W, C, Q, s)
              : launch<float>(mem, uvs, out, B, n_views, H, W, C, Q, s);
  return static_cast<int>(err);
}
