// Modulated deformable convolution (DCNv2), its sampling half, for Hopper
// (sm_90a): the bilinear im2col with the modulation mask applied.
//
// Replaces no Pallas kernel: the JAX package has no deformable convolution.
// PETR's ResNet-50 (mmdet's ResNet with dcn=DCNv2, stage_with_dcn = (F, F,
// T, T)) makes the 3x3 conv2 of every block of stages 3 and 4 a DCNv2 with
// one deform group, stride 1, padding 1 and dilation 1 (caffe style puts a
// block's stride on its 1x1 conv1). What one output pixel p and kernel
// point k = 3i + j sample, as mmcv's modulated_deform_im2col_gpu_kernel and
// dmcn_im2col_bilinear do:
//
//   (y, x) = (p_y - 1 + i + dy_k, p_x - 1 + j + dx_k)
//   col[p, k, c] = sigmoid(m_k) * bilinear(x_in[:, :, c], y, x)
//
// with dy_k = om[p, 2k], dx_k = om[p, 2k + 1] and the mask logit m_k =
// om[p, 18 + k] (mmcv's layout: the offset conv's 27 outputs are 9 (dy, dx)
// pairs, row-major over the kernel, then the 9 mask logits). A point with y
// or x outside (-1, H) or (-1, W) samples 0; inside, each of its four
// corner taps that falls off the map counts 0. The bilinear sum is taken in
// f32 in grid_sample's tap order (y0x0, y0x1, y1x0, y1x1), multiplied by the
// mask, and written once in the map's dtype (bf16 rounded to nearest even).
// The product with the weights, out[p, o] = sum_{k, c} col[p, k, c] *
// W[o, c, k], is a plain GEMM that the wrapper hands to torch.matmul.
//
// What bounds it: bytes. A (p, k) reads four rows of C channels (mostly
// from L2: neighbouring pixels share taps) and writes one; at PETR's
// stage 3 (6 cameras of 88 x 32, C = 256, bf16) one launch reads a 8.7 MB
// map and 0.9 MB of offsets and writes 78 MB of columns: 26 us at
// 3.35 TB/s. What the design does about it:
//   - one warp a (pixel, kernel point): every lane computes the point's
//     coordinates and corner weights (a few FLOPs, no shared memory, no
//     sync), then the lanes run along C, 16 bytes each, so a warp reads
//     512 contiguous bytes a tap and writes 512 bytes a column row;
//   - a corner off the map is a predicate on its load, never a weight of 0,
//     so a non-finite value in the map cannot reach the sum, and the
//     address of a tap off the map is never formed;
//   - the columns are laid out (pixel, k, c) so the GEMM reads them as a
//     row-major (pixels, 9C) matrix and its output is the NHWC map that the
//     channels-last backbone continues with.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps: 8 (pixel, point) pairs a CTA
constexpr int kPoints = 9;          // 3 x 3
constexpr int kOffsetCh = 27;       // 9 (dy, dx) pairs, then 9 mask logits

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int V = 8;       // channels per 16 bytes
  __device__ static float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static void unpack(const uint4& a, float (&v)[V]) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is exact: the high half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&v)[V]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // round to nearest even, once
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Elem<float> {
  static constexpr int V = 4;
  __device__ static float f32(float v) { return v; }
  __device__ static void unpack(const uint4& a, float (&v)[V]) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
  __device__ static uint4 pack(const float (&v)[V]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// x (N, H, W, C), om (N, H, W, 27) and col (N, H, W, 9, C), all in T and
// contiguous; C a multiple of 16 bytes' worth of T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_im2col_kernel(const T* __restrict__ x, const T* __restrict__ om,
                          T* __restrict__ col, int N, int H, int W, int C) {
  using E = Elem<T>;
  constexpr int V = E::V;
  const long long item =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long pixels = static_cast<long long>(N) * H * W;
  if (item >= pixels * kPoints) return;
  const int k = static_cast<int>(item % kPoints);
  const long long pix = item / kPoints;
  const int px = static_cast<int>(pix % W);
  const int py = static_cast<int>((pix / W) % H);
  const long long n = pix / (static_cast<long long>(W) * H);

  const T* o = om + pix * kOffsetCh;
  const float dy = E::f32(o[2 * k]);
  const float dx = E::f32(o[2 * k + 1]);
  const float mask = 1.f / (1.f + expf(-E::f32(o[2 * kPoints + k])));
  const float y = static_cast<float>(py - 1 + k / 3) + dy;
  const float xf = static_cast<float>(px - 1 + k % 3) + dx;

  // the four taps: weights and predicates; a point outside (-1, H) x
  // (-1, W) (or not finite) takes none
  bool take[4] = {false, false, false, false};
  float wt[4] = {0.f, 0.f, 0.f, 0.f};
  long long row[4] = {0, 0, 0, 0};
  if (y > -1.f && xf > -1.f && y < static_cast<float>(H) &&
      xf < static_cast<float>(W)) {
    const float y0f = floorf(y), x0f = floorf(xf);
    const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
    const float ly = y - y0f, lx = xf - x0f;
    const float hy = 1.f - ly, hx = 1.f - lx;
    const long long base = n * H * W;
    take[0] = y0 >= 0 && x0 >= 0;
    take[1] = y0 >= 0 && x0 + 1 <= W - 1;
    take[2] = y0 + 1 <= H - 1 && x0 >= 0;
    take[3] = y0 + 1 <= H - 1 && x0 + 1 <= W - 1;
    wt[0] = hy * hx;
    wt[1] = hy * lx;
    wt[2] = ly * hx;
    wt[3] = ly * lx;
    row[0] = base + static_cast<long long>(y0) * W + x0;
    row[1] = row[0] + 1;
    row[2] = row[0] + W;
    row[3] = row[2] + 1;
  }

  T* out = col + (pix * kPoints + k) * C;
  for (int c = lane * V; c < C; c += 32 * V) {
    uint4 raw[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)     // every load before the first FMA
      raw[t] = take[t] ? load16(x + row[t] * C + c) : make_uint4(0, 0, 0, 0);
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!take[t]) continue;
      float v[V];
      E::unpack(raw[t], v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(wt[t], v[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] *= mask;
    *reinterpret_cast<uint4*>(out + c) = E::pack(acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* om, void* col, int N, int H,
                   int W, int C, cudaStream_t s) {
  const long long warps = static_cast<long long>(N) * H * W * kPoints;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  deform_conv_im2col_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(static_cast<const T*>(x),
                                      static_cast<const T*>(om),
                                      static_cast<T*>(col), N, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W, C), om (N, H, W, 27) in, col (N, H, W, 9, C) out, all in bf16
// (is_bf16) or f32, contiguous and 16-byte aligned, C a multiple of 8 (bf16)
// or 4 (f32): the wrapper checks. Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int parq_deform_conv_im2col(const void* x, const void* om,
                                       void* col, int N, int H, int W, int C,
                                       int is_bf16, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C % (is_bf16 ? 8 : 4) ||
      static_cast<long long>(N) * H * W * kPoints * 32 / kThreads >=
          (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, om, col, N, H, W, C, s)
              : launch<float>(x, om, col, N, H, W, C, s);
  return static_cast<int>(err);
}
