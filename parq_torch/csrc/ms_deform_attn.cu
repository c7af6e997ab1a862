// Multi-scale deformable attention (MSDA), its forward, for Hopper (sm_90a):
// mmcv's ms_deformable_im2col with the softmax of the attention logits, the
// sampling locations and the combination of several value frames folded in.
//
// Replaces no Pallas kernel: the JAX package has no deformable attention
// (B1, csrc/pixel_align.cu, which takes one tap a view, is the port's
// nearest gather). BEVFormer calls it at three sites a layer: the spatial
// cross-attention (6 camera frames of 4 FPN levels, 8 points a level at 4
// height anchors, a query's cameras named by its hit row), the temporal
// self-attention (2 BEV frames of one level, 4 points, offsets and logits
// per frame) and the decoder's cross-attention over the BEV. For frame f,
// query q, head h, level l and point p (g = f where offsets come in F
// groups, else 0):
//
//   loc   = ref[b, f or 0, q, p % A] + off[b, q, h, g, l, p] / (w_l, h_l)
//   (x, y) = loc * (w_l, h_l) - 0.5
//   a     = softmax over (l, p) of logit[b, q, h, g]
//   o_f   = sum_{l, p} a * bilinear(value[b, f, level l, :, h, :], x, y)
//
// A point outside (-1, h_l) x (-1, w_l) samples 0; inside, each corner tap
// off the map counts 0 (mmcv's ms_deform_attn_im2col_bilinear). With a hit
// mask the output is the sum of o_f over the frames the query hits, over
// max(count, 1) (BEVFormer's slots / count); without one, the mean over the
// frames. Sums are f32 over the value's bf16 (or f32) rows, offsets and
// logits; the output row is written once in the value's dtype.
//
// What bounds it: memory, in the gather. Each sample reads four rows of
// the head's 32 channels (64 bytes in bf16) at data-dependent places; at
// BEVFormer-base's spatial cross-attention a layer gathers some 50,000
// (camera, query) hits x 8 heads x 32 samples x 4 taps x 64 B = 3.3 GB
// while the value maps themselves are 94.7 MB (6 cameras x 30,825 rows x
// 256 channels), more than the 50 MB L2. What the design does about it:
//   - one warp a (query, head); 4 lanes (bf16; 8 for f32) cover a tap's 32
//     channels with 16-byte loads, so 8 samples run at once and every tap
//     is one 64-byte segment; all four taps are loaded before the first
//     FMA;
//   - a query's cameras are walked in order from its column of the hit
//     mask, summed in registers: no rebatched buffer, no capacity to size,
//     no scatter and no atomics, and the same bits from run to run;
//   - warps run in query order (the BEV row by row), so the warps resident
//     at once cover a few BEV rows, which project into a narrow band of
//     each camera's levels: the band, not the 94.7 MB, is what must stay in
//     L2, and the next rows' bands overlap it;
//   - the offsets, logits and reference points are read once per warp
//     (the four lanes of a sample read the same address), the softmax is
//     two warp reductions over the group's logits;
//   - a corner off the map is a predicate on its load, never a weight of 0,
//     so a non-finite value in the map cannot reach the sum, and a point
//     with non-finite coordinates (a camera the anchor is behind) samples
//     nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps: 8 (query, head) pairs a CTA
constexpr int kHeadDim = 32;
constexpr int kMaxLevels = 4;
constexpr int kMaxFrames = 8;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// value (B, F, Nv, H, 32), off (B, Q, H, G, L, P, 2), logit (B, Q, H, G,
// L*P) and out (B, Q, H * 32) in T; ref (B, Fr, Q, A, 2) f32; hit (B, F, Q)
// uint8 or null. All contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_kernel(const T* __restrict__ value,
                      const float* __restrict__ ref,
                      const T* __restrict__ off, const T* __restrict__ logit,
                      const uint8_t* __restrict__ hit, T* __restrict__ out,
                      int B, int F, int Nv, int H, int Fr, int Q, int A,
                      int G, int L, int P, Levels lv) {
  using E = Elem<T>;
  constexpr int V = E::V;
  constexpr int kRowLanes = kHeadDim / V;   // lanes a tap row takes
  constexpr int kSlots = 32 / kRowLanes;    // samples at once
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(B) * Q * H) return;
  const int h = static_cast<int>(warp % H);
  const int q = static_cast<int>((warp / H) % Q);
  const int b = static_cast<int>(warp / (static_cast<long long>(H) * Q));
  const int slot = lane / kRowLanes;
  const int cl = lane % kRowLanes;
  const int LP = L * P;

  // the frames this query takes
  unsigned frames = 0;
  int count = 0;
  for (int f = 0; f < F; ++f) {
    if (hit == nullptr ||
        hit[(static_cast<long long>(b) * F + f) * Q + q]) {
      frames |= 1u << f;
      ++count;
    }
  }
  // the softmax's max and 1 / sum, per offset group (at most 2)
  const long long head = (static_cast<long long>(b) * Q + q) * H + h;
  float mx[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f};
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    if (g >= G) break;
    const T* lg = logit + (head * G + g) * LP;
    float m = -INFINITY;
    for (int j = lane; j < LP; j += 32) m = fmaxf(m, E::f32(lg[j]));
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < LP; j += 32) s += expf(E::f32(lg[j]) - m);
    s = warp_sum(s);
    mx[g] = m;
    inv[g] = 1.f / s;
  }

  const long long row = static_cast<long long>(H) * kHeadDim;  // a value row
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const int total = count * LP;
  for (int t = slot; t < total; t += kSlots) {
    const int fi = t / LP;
    const int lp = t - fi * LP;
    unsigned rest = frames;
    for (int k = 0; k < fi; ++k) rest &= rest - 1;   // drop fi lowest frames
    const int f = __ffs(rest) - 1;
    const int g = G > 1 ? f : 0;
    const int l = lp / P;
    const int p = lp - l * P;
    const long long at = (head * G + g) * LP + lp;
    const float a = expf(E::f32(logit[at]) - (g ? mx[1] : mx[0])) *
                    (g ? inv[1] : inv[0]);
    const float ox = E::f32(off[2 * at]), oy = E::f32(off[2 * at + 1]);
    const float* r =
        ref + ((static_cast<long long>(b) * Fr + (Fr > 1 ? f : 0)) * Q + q) *
                  A * 2 + (p % A) * 2;
    const int hl = lv.h[l], wl = lv.w[l];
    const float fw = static_cast<float>(wl), fh = static_cast<float>(hl);
    const float x = (r[0] + ox / fw) * fw - 0.5f;
    const float y = (r[1] + oy / fh) * fh - 0.5f;
    if (!(y > -1.f && x > -1.f && y < fh && x < fw)) continue;
    const float y0f = floorf(y), x0f = floorf(x);
    const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
    const float ly = y - y0f, lx = x - x0f;
    const float hy = 1.f - ly, hx = 1.f - lx;
    const bool take[4] = {y0 >= 0 && x0 >= 0, y0 >= 0 && x0 + 1 <= wl - 1,
                          y0 + 1 <= hl - 1 && x0 >= 0,
                          y0 + 1 <= hl - 1 && x0 + 1 <= wl - 1};
    const float wt[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
    const T* base = value +
                    ((static_cast<long long>(b) * F + f) * Nv + lv.start[l]) *
                        row +
                    h * kHeadDim + cl * V;
    const long long r0 = static_cast<long long>(y0) * wl + x0;
    const long long rows[4] = {r0, r0 + 1, r0 + wl, r0 + wl + 1};
    uint4 raw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)     // every load before the first FMA
      raw[k] = take[k] ? load16(base + rows[k] * row) : make_uint4(0, 0, 0, 0);
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!take[k]) continue;
      float v[V];
      E::unpack(raw[k], v);
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = fmaf(wt[k], v[i], s[i]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(a, s[i], acc[i]);
  }
  // the slots' partial sums: lanes of one channel chunk are kRowLanes apart
#pragma unroll
  for (int o = kRowLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += __shfl_xor_sync(~0u, acc[i], o);
  }
  if (slot == 0) {
    const float denom = hit ? static_cast<float>(count > 1 ? count : 1)
                            : static_cast<float>(F);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] /= denom;
    *reinterpret_cast<uint4*>(out + head * kHeadDim + cl * V) = E::pack(acc);
  }
}

template <typename T>
cudaError_t launch(const void* value, const float* ref, const void* off,
                   const void* logit, const uint8_t* hit, void* out, int B,
                   int F, int Nv, int H, int Fr, int Q, int A, int G, int L,
                   int P, const Levels& lv, cudaStream_t s) {
  const long long warps = static_cast<long long>(B) * Q * H;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  ms_deform_attn_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(value), ref, static_cast<const T*>(off),
      static_cast<const T*>(logit), hit, static_cast<T*>(out), B, F, Nv, H,
      Fr, Q, A, G, L, P, lv);
  return cudaGetLastError();
}

}  // namespace

// value (B, F, Nv, H, 32), ref (B, Fr, Q, A, 2) f32, off (B, Q, H, G, L, P,
// 2), logit (B, Q, H, G, L*P), hit (B, F, Q) uint8 or null, out (B, Q,
// H * 32); value, off, logit and out in bf16 (is_bf16) or f32, contiguous,
// value and out 16-byte aligned. levels: h[4], w[4], start[4] (rows into a
// frame's Nv). Launches on `stream`; returns the launch's cudaError_t.
extern "C" int parq_ms_deform_attn(const void* value, const void* ref,
                                   const void* off, const void* logit,
                                   const void* hit, void* out, int B, int F,
                                   int Nv, int H, int Fr, int Q, int A, int G,
                                   int L, int P, const int* levels,
                                   int is_bf16, void* stream) {
  if (B < 1 || F < 1 || F > kMaxFrames || Nv < 1 || H < 1 || Q < 1 ||
      A < 1 || P < 1 || P % A || L < 1 || L > kMaxLevels ||
      (G != 1 && G != F) || G > 2 || (Fr != 1 && Fr != F) ||
      static_cast<long long>(B) * Q * H * 32 / kThreads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  long long rows = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.h[i] = i < L ? levels[i] : 0;
    lv.w[i] = i < L ? levels[kMaxLevels + i] : 0;
    lv.start[i] = i < L ? levels[2 * kMaxLevels + i] : 0;
    if (i < L) {
      if (lv.h[i] < 1 || lv.w[i] < 1 || lv.start[i] != rows)
        return static_cast<int>(cudaErrorInvalidValue);
      rows += static_cast<long long>(lv.h[i]) * lv.w[i];
    }
  }
  if (rows != Nv) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(ref);
  const uint8_t* m = static_cast<const uint8_t*>(hit);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(value, r, off, logit, m, out, B, F, Nv,
                                      H, Fr, Q, A, G, L, P, lv, s)
              : launch<float>(value, r, off, logit, m, out, B, F, Nv, H, Fr,
                              Q, A, G, L, P, lv, s);
  return static_cast<int>(err);
}
