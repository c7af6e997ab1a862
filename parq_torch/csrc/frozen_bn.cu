// FrozenBatchNorm2d, optionally a residual add, then ReLU, in one pass over a
// channels-last bf16 map, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's ResNet body
// (parq_tpu/models/resnet_fpn.py) leaves its frozen affine, ReLU and
// residual adds to XLA, which fuses them into the convolutions' epilogues.
// In the port every BN site of the body (models/resnet_fpn.py: ResNetBody's
// stem, Bottleneck, BasicBlock) was a FrozenBatchNorm2d (five launches to
// rebuild its parameters, two casts, then a multiply and an add that
// PyTorch does not vectorise over a channels-last map), then a ReLU pass
// and, at a block's end, an add pass, each reading and writing the whole
// map. One launch a site now does it all, for every camera or view at once.
//
// What one element of channel c computes, at the module's own rounding
// points (f32 arithmetic, each step rounded once; no FMA contraction):
//
//   inv = w[c] * rsqrt(var[c] + eps)       s = bf16(inv)
//   shift = bias[c] - mean[c] * inv        t = bf16(shift)
//   y = bf16(bf16(x * s) + t)
//   kRes == 1: y = bf16(y + r)                         (the identity)
//   kRes == 2: y = bf16(y + bf16(bf16(r * s') + t'))   (the downsample
//              conv's raw output through its own frozen affine s', t')
//   then ReLU: y = isnan(y) ? y : max(y, 0)            (F.relu's NaN rule)
//
// Each f32 result is rounded to bf16 to nearest even (cvt.rn), as PyTorch's
// bf16 kernels round their f32 opmath results, so the output equals the
// module path's bit for bit. The parameters are derived in every thread's
// prologue from the four f32 buffers, with no branch on their values.
//
// What bounds it: bytes. A site reads the map (and the residual) once and
// writes once: PETR's stem map (6 cameras x 64 x 256 x 704, bf16) is 138 MB
// each way, 83 us at 3.35 TB/s. What the design does about it:
//   - one thread owns one 16-byte vector of 8 channels and walks over
//     pixels with a stride that is a multiple of C / 8, so its channels,
//     and their 8 (or 16) scales and shifts, stay fixed in registers;
//   - kUnroll vectors (and their residuals) are loaded before the first is
//     computed, and the grid holds as many blocks as the SMs keep resident;
//   - loads and stores are streaming (ld.global.cs / st.global.cs): every
//     byte is touched once here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;             // bf16 channels in 16 bytes
constexpr int kUnroll = 4;          // vectors in flight per thread

struct Buffers {                    // one FrozenBatchNorm2d's f32 buffers
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// s and t of the 8 channels from c0 on, as the module computes inv and
// shift in f32 and casts them to bf16
__device__ __forceinline__ void affine_params(const Buffers& p, int c0,
                                              float (&s)[kVec],
                                              float (&t)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = c0 + i;
    const float inv =
        __fmul_rn(__ldg(p.weight + c), rsqrtf(__fadd_rn(__ldg(p.var + c),
                                                        p.eps)));
    s[i] = round_bf16(inv);
    t[i] = round_bf16(__fsub_rn(__ldg(p.bias + c),
                                __fmul_rn(__ldg(p.mean + c), inv)));
  }
}

__device__ __forceinline__ void unpack(const uint4& a, float (&v)[kVec]) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // bf16 -> f32 is exact: the high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // the values are bf16 already: exact
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float affine(float x, float s, float t) {
  return round_bf16(__fadd_rn(round_bf16(__fmul_rn(x, s)), t));
}

// x, r and y (pixels, C) in bf16 as 16-byte vectors, C = 8 * cv; `stride`
// (vectors) a multiple of cv, so thread `tid` always sees channel group
// tid % cv.
template <int kRes>
__global__ void __launch_bounds__(kThreads)
frozen_bn_kernel(const uint4* __restrict__ x, const uint4* __restrict__ r,
                 uint4* __restrict__ y, Buffers bn, Buffers rbn,
                 long long total, int cv, long long stride) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= stride) return;
  const int c0 = static_cast<int>(tid % cv) * kVec;
  float s[kVec], t[kVec], rs[kVec], rt[kVec];
  affine_params(bn, c0, s, t);
  if (kRes == 2) affine_params(rbn, c0, rs, rt);

  for (long long i = tid; i < total; i += kUnroll * stride) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // every load before any math
      const long long j = i + u * stride;
      if (j < total) {
        xv[u] = __ldcs(x + j);
        if (kRes) rv[u] = __ldcs(r + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j >= total) break;
      float v[kVec], res[kVec];
      unpack(xv[u], v);
      if (kRes) unpack(rv[u], res);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        float o = affine(v[k], s[k], t[k]);
        if (kRes == 1) o = round_bf16(__fadd_rn(o, res[k]));
        if (kRes == 2)
          o = round_bf16(__fadd_rn(o, affine(res[k], rs[k], rt[k])));
        o = isnan(o) ? o : fmaxf(o, 0.f);
        v[k] = o;
      }
      __stcs(y + j, pack(v));
    }
  }
}

template <int kRes>
cudaError_t launch(const void* x, const void* r, void* y, const Buffers& bn,
                   const Buffers& rbn, long long pixels, int C,
                   cudaStream_t stream) {
  static int resident = 0;          // blocks a grid keeps on the card
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, frozen_bn_kernel<kRes>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const int cv = C / kVec;
  const long long total = pixels * cv;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  const long long min_blocks = (cv + kThreads - 1) / kThreads;
  if (blocks < min_blocks) blocks = min_blocks;
  const long long threads = blocks * kThreads;
  const long long stride = threads - threads % cv;
  frozen_bn_kernel<kRes><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(r),
      static_cast<uint4*>(y), bn, rbn, total, cv, stride);
  return cudaGetLastError();
}

}  // namespace

// x, r and y (pixels, C) bf16, channels innermost (a channels-last map),
// 16-byte aligned, C a multiple of 8: the wrapper checks. The buffers are
// f32 (C,). res: 0 no residual, 1 add r, 2 add r through the second set of
// buffers (rw, rb, rm, rv, reps). Launches on `stream`; returns the
// launch's cudaError_t.
extern "C" int parq_frozen_bn(const void* x, const void* r, void* y,
                              const float* w, const float* b, const float* m,
                              const float* v, float eps, const float* rw,
                              const float* rb, const float* rm,
                              const float* rv, float reps, long long pixels,
                              int C, int res, void* stream) {
  if (pixels < 1 || C < kVec || C % kVec || res < 0 || res > 2 ||
      (res && r == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Buffers bn{w, b, m, v, eps};
  const Buffers rbn{rw, rb, rm, rv, reps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (res) {
    case 0: err = launch<0>(x, r, y, bn, rbn, pixels, C, s); break;
    case 1: err = launch<1>(x, r, y, bn, rbn, pixels, C, s); break;
    default: err = launch<2>(x, r, y, bn, rbn, pixels, C, s);
  }
  return static_cast<int>(err);
}
