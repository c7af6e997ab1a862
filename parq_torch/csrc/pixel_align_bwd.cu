// Kernel B4: d(memory) of the pixel-aligned bilinear sampler, for Hopper
// (sm_90a).
//
// Replaces parq_tpu/kernels/pixel_align_pallas.py:_pallas_sample_bwd_mem
// (:280), body _sample_bwd_mem_kernel (:216): the transpose of the sampler
// (kernel B1, pixel_align.cu),
//
//   dmem[b, t, y, x, :] = sum over (q, tap) landing on (y, x) of
//                         scale[b,t,q] * w_tap * g[b, q, :]
//
// over the <= 4 in-bounds bilinear taps of every (b, t, q). The bounds test
// is B1's, in float: a point behind the camera projects far off the image,
// and converting such a coordinate to int first would overflow; a NaN
// coordinate fails every test and adds nothing.
//
// The TPU kernel is output-stationary: a grid step owns a block of output
// pixels, builds a dense (pixels x Q) weight tile in VMEM and runs W^T @ g
// on the MXU, because the TPU has no fast gather. The card has one, and the
// work is sparse (at the release fold 1.7 taps per pixel, each a 2 KB row
// of g, and all of g fits in L2). So this kernel is output-stationary too,
// but as a per-pixel gather: every output pixel belongs to exactly one
// CTA, which sums its taps in f32 registers and writes the pixel once, in
// the memory's dtype, zeros included. No scratch, no memset, no cast pass,
// no atomics; and because a pixel's taps are added in q order, two
// launches on the same inputs are equal bit for bit.
//
// What bounds it: bytes. The work is 4 taps x C multiply-adds per (b, t, q);
// the bytes are one write of dmem (236 MB in bf16 at the release shape,
// B=8, T=3, 60x80, C=1024, Q=2048) plus g and the (u, v, scale) rows, ~0.08
// ms at 3.35 TB/s. The rows of g that the taps re-read (12 taps per row)
// and every CTA's scan of its map's (u, v, scale) rows come from L2.
//
// Design. A CTA of 8 warps owns an 8x8 tile of pixels of one (b, t) map.
//  1. Scan: the CTA reads the map's Q rows of (u, v, scale), 256 at a time,
//     and keeps those whose 2x2 footprint touches the tile, by warp ballot
//     and prefix count, as a compact hit list in shared memory in q order.
//     A footprint that straddles two tiles is kept by both; each takes only
//     the taps on its own pixels.
//  2. Gather: for each of the tile's 8 rows, warp w owns pixel (row, w).
//     Its lanes test 32 hits at a time against the pixel (x0 + dx == x and
//     y0 + dy == y, in float: the pixel is inside the image, so this is the
//     bounds test and the membership test in one), each computing its own
//     hit's weight; a ballot gives the taps on the pixel, in q order. For
//     each, the lanes run along C with 16-byte loads of g's row and add
//     w * g in f32. Then the pixel is stored once with 16-byte streaming
//     stores (the result is not read again here; g should stay in L2).
// The hit list holds 2048 rows, the release fold's Q. A longer Q is
// scanned in chunks of 2048 with the accumulators kept in registers across
// the chunks of one pixel, so no hit is dropped and nothing is summed in
// the memory's dtype; the scan is then repeated for each tile row and
// slab. More than 1024 channels are taken in slabs of 1024 (32 f32
// accumulators a lane).
//
// Measured and not kept (NVIDIA H100 80GB HBM3, 700 W, release fold, bf16):
// the kernel is built for 2 CTAs an SM (115-118 registers, no spills);
// capped at 80 or 64 registers for 3 or 4 CTAs it spills and is slower, and
// slabs of 512 or 256 channels (fewer registers, the hit list walked once
// per slab) are slower still. Two taps' loads in flight per warp gain
// nothing at the release fold. g comes in the memory's dtype: rounding an
// f32 g to bf16 as it is loaded (32 bytes a lane in two loads) is slower
// than the caller's cast pass over g plus this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                    // the CTA's tile: 8 x 8 pixels
constexpr int kWarps = kTile;               // one warp per pixel of a row
constexpr int kThreads = 32 * kWarps;
constexpr int kRounds = 8;                  // scan rounds per chunk
constexpr int kChunk = kRounds * kThreads;  // rows per chunk = list capacity
constexpr int kAcc = 32;                    // f32 accumulators per lane
constexpr int kSlab = 32 * kAcc;            // channels per pass of a warp
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void store16(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), a);
}

// Is the tap coordinate `f` (x0 or x0 + 1, as a float) inside [lo, hi]?
__device__ __forceinline__ bool inside(float f, float lo, float hi) {
  return f >= lo && f <= hi;
}

// Step 1. Rows [q0, q1) of `uv` whose footprint touches the tile
// [x_lo, x_hi] x [y_lo, y_hi] (pixel coordinates, clipped to the image), in
// q order, into `hits` with the row's index in .w. Returns their count.
// Called by all threads of the CTA; q1 - q0 <= kChunk.
__device__ __forceinline__ int scan_rows(const float4* __restrict__ uv,
                                         int q0, int q1, float x_lo,
                                         float x_hi, float y_lo, float y_hi,
                                         float4* hits,
                                         int (*warp_hits)[kWarps]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4 p[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {      // every load in flight at once
    const int q = q0 + r * kThreads + tid;
    if (q < q1) p[r] = uv[q];
  }
  int n = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (q0 + r * kThreads >= q1) break;    // uniform over the CTA
    const int q = q0 + r * kThreads + tid;
    bool hit = false;
    if (q < q1) {
      const float x0 = floorf(p[r].x), y0 = floorf(p[r].y);
      hit = (inside(x0, x_lo, x_hi) || inside(x0 + 1.f, x_lo, x_hi)) &&
            (inside(y0, y_lo, y_hi) || inside(y0 + 1.f, y_lo, y_hi));
    }
    const unsigned m = __ballot_sync(kFull, hit);
    // two count arrays in turn: a warp may write round r + 1's counts
    // while another still reads round r's; one barrier a round is enough
    if (lane == 0) warp_hits[r & 1][warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_hits[r & 1][w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (hit) {
      float4 h = p[r];
      h.w = __int_as_float(q);
      hits[n + before + __popc(m & ((1u << lane) - 1u))] = h;
    }
    n += total;
  }
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
sample_bwd_mem_kernel(const float4* __restrict__ uvs, const T* __restrict__ g,
                      T* __restrict__ dmem, int n_views, int H, int W, int C,
                      int Q, int tiles_x, int tiles) {
  constexpr int V = 16 / sizeof(T);  // channels per 16-byte load of g
  constexpr int K = kAcc / V;        // 16-byte vectors per lane and slab
  __shared__ float4 hits[kChunk];
  __shared__ int warp_hits[2][kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bt = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int tx0 = (tile % tiles_x) * kTile, ty0 = (tile / tiles_x) * kTile;
  const float x_lo = (float)tx0, x_hi = (float)(min(tx0 + kTile, W) - 1);
  const float y_lo = (float)ty0, y_hi = (float)(min(ty0 + kTile, H) - 1);
  const float4* uv = uvs + (long long)bt * Q;
  const T* gb = g + (long long)(bt / n_views) * Q * C;
  T* map = dmem + (long long)bt * H * W * C;
  const bool one_chunk = Q <= kChunk;

  int n = 0;
  for (int row = 0; row < kTile; ++row) {
    const int py = ty0 + row, px = tx0 + warp;
    const bool live = py < H && px < W;   // ragged tiles at the image's edge
    const float pxf = (float)px, pyf = (float)py;
    for (int c0 = 0; c0 < C; c0 += kSlab) {
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

      for (int q0 = 0; q0 < Q; q0 += kChunk) {
        if (!one_chunk || (row == 0 && c0 == 0)) {
          __syncthreads();                 // the old list's readers are done
          n = scan_rows(uv, q0, min(q0 + kChunk, Q), x_lo, x_hi, y_lo, y_hi,
                        hits, warp_hits);
          __syncthreads();
        }
        if (!live) continue;
        // Step 2: the taps on this warp's pixel, 32 hits at a time.
        for (int i0 = 0; i0 < n; i0 += 32) {
          float w = 0.f;
          int q = 0;
          bool on = false;
          if (i0 + lane < n) {
            const float4 h = hits[i0 + lane];
            const float x0 = floorf(h.x), y0 = floorf(h.y);
            const float wx1 = h.x - x0, wy1 = h.y - y0;
            const bool xa = x0 == pxf, xb = x0 + 1.f == pxf;
            const bool ya = y0 == pyf, yb = y0 + 1.f == pyf;
            on = (xa || xb) && (ya || yb);
            w = (xb ? wx1 : 1.f - wx1) * (yb ? wy1 : 1.f - wy1) * h.z;
            q = __float_as_int(h.w);
          }
          unsigned m = __ballot_sync(kFull, on);
          while (m) {                      // in q order
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float wt = __shfl_sync(kFull, w, src);
            const int qt = __shfl_sync(kFull, q, src);
            const T* grow = gb + (long long)qt * C + c0;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int c = (k * 32 + lane) * V;
              if (c0 + c < C) {
                float gv[V];
                load16(grow + c, gv);
#pragma unroll
                for (int i = 0; i < V; ++i) acc[k * V + i] += wt * gv[i];
              }
            }
          }
        }
      }

      if (live) {
        T* dst = map + ((long long)py * W + px) * C + c0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = (k * 32 + lane) * V;
          if (c0 + c < C) store16(dst + c, acc + k * V);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* uvs, const void* g, void* dmem, int B,
                   int n_views, int H, int W, int C, int Q,
                   cudaStream_t stream) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles = tiles_x * ((H + kTile - 1) / kTile);
  const long long ctas = (long long)B * n_views * tiles;
  if (ctas <= 0) return cudaSuccess;       // an empty result
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sample_bwd_mem_kernel<T><<<(unsigned)ctas, kThreads, 0, stream>>>(
      static_cast<const float4*>(uvs), static_cast<const T*>(g),
      static_cast<T*>(dmem), n_views, H, W, C, Q, tiles_x, tiles);
  return cudaGetLastError();
}

}  // namespace

// uvs (B, T, Q, 4) f32 rows [u, v, scale, unused]; g (B, Q, C) and dmem
// (B, T, H, W, C) contiguous, both bf16 (is_bf16=1) or both f32. Every
// element of dmem is written, so the caller need not zero it. C must be a
// multiple of 8 and every pointer 16-byte aligned (the Python wrapper
// checks both). Returns the launch's cudaError_t.
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
