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
// The sums are f32; the output is written once in the memory's dtype (bf16
// rounded to nearest even, the same bits as the f32 sums cast by torch), or
// as the f32 sums themselves when the caller asks (`out_f32`).
//
// What bounds it: bytes. Each (b, q) reads at most T*4 rows of C channels
// and writes C values; ~2 FLOP per byte read, far below the card's ~295
// FLOP/byte ridge. At the release shape (B=8, T=3, Q=256, C=1024, bf16)
// that is at most ~50 MB gathered plus 4 MB written; neighbouring queries
// share taps, which L2 serves.
//
// Why the loads come first: a thread that walked the views in a chain (a
// view's (u, v) row, then its taps, then the next view) would wait T x (one
// uvs latency + one tap latency). At B=8 the grid's thousands of CTAs hide
// that; at B=1 (the eval twin, the scaled config) a few hundred cannot.
//
// Design:
//   - the CTA stages the T (u, v, scale) rows of its queries in shared
//     memory with one coalesced load, then a thread computes every tap's
//     address and issues the loads of a whole stage of views (3 views, or
//     6 when T > 3: 12 or 24 loads of 16 bytes a thread) before its first
//     FMA: one tap latency a stage instead of two a view;
//   - an out-of-image tap is a predicate on its load and its FMA, never a
//     weight of 0, so a non-finite value in the map cannot reach the sum;
//   - the FMAs keep one fixed order (view, dy, dx; one fmaf a tap into f32
//     registers, the weight (wx * wy) * scale), whatever the load order, so
//     the f32 sums do not depend on the stage size;
//   - threads run along C, 16 bytes each (a warp reads 512 contiguous bytes
//     a tap); a CTA is 128 threads (256 for f32 at C = 1024), one query at
//     C = 1024 in bf16: 256 CTAs at B=1, 2,048 at B=8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUvsBytes = 48 * 1024;   // the staged (u, v, scale) rows

// 16 bytes of a channels-last row where `pred` holds, zeros elsewhere; an
// address is formed only for a tap inside the image
__device__ __forceinline__ uint4 load16_if(const void* p, bool pred) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %4, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%5];\n\t}"
      : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w)
      : "r"(static_cast<int>(pred)), "l"(p));
  return r;
}

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int V = 8;   // channels per 16 bytes
  __device__ static void unpack(const uint4& a, float (&v)[V]) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is exact: the high half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Elem<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& a, float (&v)[V]) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
};

template <int V>
__device__ __forceinline__ void store(float* o, const float (&acc)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(o + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* o,
                                      const float (&acc)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // round to nearest even, once
    const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The tap's bounds test, in float: a point behind the camera projects far
// off the image, and converting such a coordinate to int would overflow.
__device__ __forceinline__ bool inside(float f, float hi) {
  return f >= 0.f && f <= hi;
}

template <typename Tin, typename Tout, int kStage>
__global__ void __launch_bounds__(kMaxThreads)
sample_views_kernel(const Tin* __restrict__ mem,
                    const float4* __restrict__ uvs, Tout* __restrict__ out,
                    int n_views, int H, int W, int C, int Q) {
  constexpr int V = Elem<Tin>::V;
  extern __shared__ float4 s_uvs[];   // (n_views, blockDim.y)
  const int ty = blockDim.y;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * ty;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < n_views * ty; k += blockDim.x * ty) {
    const int t = k / ty, qq = k - t * ty;
    if (q0 + qq < Q)
      s_uvs[k] = uvs[(static_cast<long long>(b) * n_views + t) * Q + q0 + qq];
  }
  __syncthreads();
  const int q = q0 + threadIdx.y;
  if (q >= Q) return;
  const long long map_elems = static_cast<long long>(H) * W * C;
  const Tin* mem_b = mem + static_cast<long long>(b) * n_views * map_elems;
  const float hmax = static_cast<float>(H - 1);
  const float wmax = static_cast<float>(W - 1);

  for (int c0 = threadIdx.x * V; c0 < C; c0 += blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;

    for (int t0 = 0; t0 < n_views; t0 += kStage) {
      // every tap load of the stage's views, before any FMA
      uint4 raw[kStage][4];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int t = t0 + s;
        float4 p = make_float4(-2.f, -2.f, 0.f, 0.f);   // off every map
        if (t < n_views) p = s_uvs[t * ty + threadIdx.y];
        const float x0 = floorf(p.x), y0 = floorf(p.y);
        const Tin* map = mem_b + t * map_elems + c0;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float yf = y0 + dy, xf = x0 + dx;
            const bool in = inside(yf, hmax) && inside(xf, wmax);
            const long long off =
                in ? (static_cast<long long>(yf) * W
                      + static_cast<long long>(xf)) * C
                   : 0;
            raw[s][2 * dy + dx] = load16_if(map + off, in);
          }
        }
      }
      // then the sums, in order: view, dy, dx
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int t = t0 + s;
        if (t >= n_views) break;
        const float4 p = s_uvs[t * ty + threadIdx.y];
        const float x0 = floorf(p.x), y0 = floorf(p.y);
        const float wx1 = p.x - x0, wy1 = p.y - y0;
        const float wx[2] = {1.f - wx1, wx1};
        const float wy[2] = {1.f - wy1, wy1};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const float yf = y0 + dy;
          if (!inside(yf, hmax)) continue;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float xf = x0 + dx;
            if (!inside(xf, wmax)) continue;
            const float w = wx[dx] * wy[dy] * p.z;
            float v[V];
            Elem<Tin>::unpack(raw[s][2 * dy + dx], v);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(w, v[i], acc[i]);
          }
        }
      }
    }
    store(out + (static_cast<long long>(b) * Q + q) * C + c0, acc);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* mem, const void* uvs, void* out, int B,
                   int n_views, int H, int W, int C, int Q,
                   cudaStream_t stream) {
  constexpr int V = Elem<Tin>::V;
  const int tx = C / V < kMaxThreads ? C / V : kMaxThreads;
  int ty = tx >= 128 ? 1 : 128 / tx;
  while (ty > 1 && n_views * ty * 16 > kUvsBytes) ty /= 2;
  if (n_views * ty * 16 > kUvsBytes) return cudaErrorInvalidValue;
  const dim3 block(tx, ty);
  const dim3 grid((Q + ty - 1) / ty, B);
  const size_t smem = static_cast<size_t>(n_views) * ty * 16;
  const auto* m = static_cast<const Tin*>(mem);
  const auto* u = static_cast<const float4*>(uvs);
  auto* o = static_cast<Tout*>(out);
  if (n_views <= 3)
    sample_views_kernel<Tin, Tout, 3><<<grid, block, smem, stream>>>(
        m, u, o, n_views, H, W, C, Q);
  else
    sample_views_kernel<Tin, Tout, 6><<<grid, block, smem, stream>>>(
        m, u, o, n_views, H, W, C, Q);
  return cudaGetLastError();
}

}  // namespace

// memory (B, T, H, W, C) contiguous, bf16 (is_bf16=1) or f32; uvs
// (B, T, Q, 4) f32 rows [u, v, scale, unused]; out (B, Q, C) in the
// memory's dtype, or f32 (the sums before rounding) with out_f32=1.
// C must be a multiple of 8 and every pointer 16-byte aligned (the Python
// wrapper checks both). Returns the launch's cudaError_t.
extern "C" int parq_sample_views(const void* mem, const void* uvs, void* out,
                                 int B, int n_views, int H, int W, int C,
                                 int Q, int is_bf16, int out_f32,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch<float, float>(mem, uvs, out, B, n_views, H, W, C, Q, s);
  else if (out_f32)
    err = launch<__nv_bfloat16, float>(mem, uvs, out, B, n_views, H, W, C,
                                       Q, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(mem, uvs, out, B, n_views, H,
                                               W, C, Q, s);
  return static_cast<int>(err);
}
