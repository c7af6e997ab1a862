// The decoder's four detection heads and the box decode that reads them, in
// three kernels (sm_90a): the eval forward's detection tail of one decoder
// iteration, under bf16 autocast.
//
// Replaces no Pallas kernel: the JAX package fuses these heads with XLA
// (parq_tpu/models/mlp.py: fused_detection_heads, the "batched" layer-2
// form). Before this file the port ran each HeadMLP on its own: at the
// release shape (B=1, Q=256, D=1024) some 90 launches an iteration, each on
// 256 x 1024 values or fewer, so latency and not bytes set their time.
//
// What it computes, with the rounding points of the per-head path kept
// (kernels/heads.py: detection_heads_plain is its plain version):
//   K1  h1 = bf16(bf16(x) @ [W_c1 | W_r1]^T)          (M x 2D, M = B*Q)
//       and each 64 x 64 tile's (mean, M2) of the rounded values
//   K2  per head k: a = relu(bf16(GN1_k(h1_k))), the GroupNorm1 statistics
//       of (sample, head) combined from K1's tiles in a fixed order (Chan),
//       h2_k = bf16(a @ W_k2^T), and its tiles' (mean, M2)
//   K3  per query row: y_k = relu(bf16(GN2_k(h2_k))); center (3) and
//       rotation (6) as f32 products over y, sem_cls (S+1) and size (3) as
//       f32 products over the f32 x, each plus its bias; then the decode:
//       center_norm = sigmoid(offset + inverse_sigmoid(ref)), the
//       denormalised center, the next reference points, softmax, argmax,
//       exp(size) * mean_size[argmax].
// Only the order of the sums differs from the per-head path; the decode's
// elementwise steps are PyTorch's own (explicitly unfused multiply and add,
// a division by a scale-box edge taken as a product with its f32
// reciprocal, softmax reduced by the same xor butterfly), so given equal
// logits it writes the same bits.
//
// What bounds it on this card: bytes. At the release shape the work is
// 2.2 GFLOP (2.2 us of tensor-core time) against one read of the heads'
// f32 parameters (16.8 MB) and of x (1 MB): 5.3 us at 3.35 TB/s. What the
// design does about it:
//   - The f32 parameters are read as they live, every call (no packed copy
//     that a load_state_dict could leave stale), and rounded to bf16 on the
//     way into shared memory: the same bits as autocast's cast.
//   - K1/K2: one warpgroup a 64 x 64 output tile (at B=1, 128 CTAs for 132
//     SMs); the f32 (or bf16) A and B blocks of 64 columns stream in with
//     cp.async through a ring of kStages, each thread converting (and, in
//     K2, normalising) the very chunks it copied into a 128-byte-swizzled
//     bf16 tile, double-buffered, that wgmma (m64n64k16, both operands in
//     shared memory) reads while the next block is converted.
//     K2 stages its head's GroupNorm scale and bias in shared memory once.
//   - The GroupNorm statistics never make a pass of their own: each tile's
//     epilogue writes its (mean, M2) and the next kernel combines them.
//   - K3: one warp a query row; the output widths (3 + 6 + S+1 + 3) are
//     too small for a tensor-core tile (and must stay f32), so each is a
//     warp-wide f32 dot product of the row's normalised activations, held
//     in registers, with weights the CTA staged once in shared memory for
//     its eight rows.
// Loader shipped: cp.async (16-byte chunks) with per-thread conversion.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace parq {

// The call's tensors and sizes (kernels/heads.py: _HeadsArgs, field for
// field), passed to each kernel by value.
struct HeadsArgs {
  const float* x;          // (M, D) f32: the decoder layer's output
  const float* ref;        // (B, Q, 3) f32, batch stride ref_bstride
  const float* w1[2];      // (D, D) f32 layer-1 weights: center, rotation
  const float* g1[2];      // (D) GroupNorm1 scale and bias after layer 1
  const float* b1[2];
  const float* w2[2];      // (D, D) layer-2 weights
  const float* g2[2];
  const float* b2[2];
  const float* w3[2];      // (3, D), (6, D) output projections
  const float* b3[2];
  const float* ws;         // (NC, D), (NC): sem_cls
  const float* bs;
  const float* wz;         // (3, D), (3): size
  const float* bz;
  const float* mean_size;  // (NC, 3)
  __nv_bfloat16* h1;       // (M, 2D) scratch
  __nv_bfloat16* h2;
  float2* part1;           // (B, 2, P) tile (mean, M2), P = Q/64 * D/64
  float2* part2;
  float* new_ref;          // (M, 3)
  float* logits;           // (M, NC)
  float* center;           // (M, 3)
  float* size;             // (M, 3)
  float* ortho;            // (M, 6)
  float* prob;             // (M, NC)
  long long ref_bstride;
  float eps1[2], eps2[2];  // GroupNorm eps after layers 1 and 2, per head
  float smul[3];           // the scale box: metric = p * smul + sadd,
  float sadd[3];           //   p = (metric - sadd) * sinv
  float sinv[3];
  int B, Q, D, NC;
};

}  // namespace parq

namespace {

using parq::HeadsArgs;
using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // output rows, output columns, k a block
constexpr int kThreads = 128;   // K1/K2: one warpgroup
constexpr int kStages = 4;      // K1/K2: cp.async ring depth (k blocks)
constexpr int kOutWarps = 8;    // K3: one query row a warp
constexpr int kMaxQuads = 8;    // K3: D <= 32 lanes * 8 * 4 = 1024
constexpr int kMaxDim = 32 * kMaxQuads * 4;
constexpr int kMaxClasses = 32; // K3: one softmax in one warp
constexpr int kMaxOut = 3 + 6 + kMaxClasses + 3;
constexpr float kTileCount = 64.f * 64.f;  // values a tile's statistics hold

// ------------------------------------------------------------ helpers --
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of this thread made visible to the async proxy
// (wgmma reads its operands through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the 16-byte chunk `c` of row `r` of a 64-column bf16 tile written in the
// TMA's 128-byte swizzle (hopper.cuh), which desc_k describes
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// Chan's combination of (n, mean, M2) with (nb, mb, m2b)
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                     float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

// GroupNorm1's mean and 1/sqrt(var + eps) of one (sample, head) from its P
// tiles' (mean, M2), combined by one whole warp in a fixed order: every
// caller gets the same bits.
__device__ __forceinline__ float2 group_stats(const float2* part, int P,
                                              float eps) {
  const int lane = threadIdx.x & 31;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int i = lane; i < P; i += 32) {
    const float2 t = part[i];
    chan(n, mean, m2, kTileCount, t.x, t.y);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
    chan(n, mean, m2, nb, mb, m2b);
  }
  n = __shfl_sync(0xffffffffu, n, 0);
  mean = __shfl_sync(0xffffffffu, mean, 0);
  m2 = __shfl_sync(0xffffffffu, m2, 0);
  return make_float2(mean, rsqrtf(__fadd_rn(__fdiv_rn(m2, n), eps)));
}

// GroupNorm1's affine output rounded to bf16, then ReLU: the per-head
// path's ((x - mean) * rstd) * gamma + beta in f32, each step rounded
__device__ __forceinline__ float norm_relu(float v, float mean, float rstd,
                                           float g, float b) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), g),
                            b);
  return fmaxf(round_bf16(y), 0.f);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return pack_bf16x2(lo, hi);
}

// eight consecutive f32 of a staged row as bf16
__device__ __forceinline__ uint4 octet_bf16(const uint8_t* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 16);
  return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                    pack2(hi.z, hi.w));
}

// --------------------------------------------------------------- K1/K2 --
// One 64 x 64 tile of h1 (kL2 false) or h2 (kL2 true). blockIdx.x: the
// tile's 64 columns of the (M, 2D) output (head k = n0 / D); blockIdx.y:
// its 64 rows (within one sample: Q % 64 == 0).
template <bool kL2>
struct GemmSmem {
  static constexpr int kOp = kTile * kRowBytes;             // a bf16 tile
  static constexpr int kStageA = kTile * kTile * (kL2 ? 2 : 4);
  static constexpr int kStageB = kTile * kTile * 4;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kNorm = kL2 ? 2 * kMaxDim * 4 : 0;  // scale, bias
  static constexpr int kBytes = 4 * kOp + kStages * kStage + kNorm + 64 +
                                1024;
};

template <bool kL2>
__global__ void __launch_bounds__(kThreads, 1)
heads_gemm_kernel(const HeadsArgs p) {
  typedef GemmSmem<kL2> S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* op_a = smem;                   // 2 bf16 tiles (double buffer)
  uint8_t* op_b = smem + 2 * S::kOp;
  uint8_t* stage = smem + 4 * S::kOp;
  float* norm = reinterpret_cast<float*>(stage + kStages * S::kStage);
  float* red = norm + S::kNorm / 4;

  const int D = p.D, Q = p.Q, two_d = 2 * D;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int head = n0 / D, nl = n0 - head * D;
  const int b = m0 / Q;
  const int P = (Q / kTile) * (D / kTile);
  const int tile = ((m0 - b * Q) / kTile) * (D / kTile) + nl / kTile;
  const float* w = (kL2 ? p.w2[head] : p.w1[head]) + (size_t)nl * D;
  const int nk = D / kTile;

  // this thread's chunks: octet c (8 columns) of rows r0 + 16 i, of A and
  // of B, each copied (cp.async) and later converted by the same thread
  const int c = t & 7, r0 = t >> 3;
  auto issue = [&](int kb) {
    uint8_t* sa = stage + (kb % kStages) * S::kStage;
    uint8_t* sb = sa + S::kStageA;
    const int k0 = kb * kTile + 8 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      if constexpr (kL2) {
        cp_async16(sa + r * 128 + c * 16,
                   p.h1 + (size_t)(m0 + r) * two_d + head * D + k0);
      } else {
        const float* src = p.x + (size_t)(m0 + r) * D + k0;
        cp_async16(sa + r * 256 + c * 32, src);
        cp_async16(sa + r * 256 + c * 32 + 16, src + 4);
      }
      const float* srcb = w + (size_t)r * D + k0;
      cp_async16(sb + r * 256 + c * 32, srcb);
      cp_async16(sb + r * 256 + c * 32 + 16, srcb + 4);
    }
  };
  if constexpr (kL2) {  // GroupNorm1's scale and bias of this head
    for (int i = t; i < D / 4; i += kThreads) {
      cp_async16(norm + 4 * i, p.g1[head] + 4 * i);
      cp_async16(norm + kMaxDim + 4 * i, p.b1[head] + 4 * i);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }

  float mean = 0.f, rstd = 0.f;
  if constexpr (kL2) {  // GroupNorm1 of (b, head) from K1's tiles
    cp_async_wait<kStages - 1>();  // this thread's scale and bias landed
    if (warp == 0) {
      const float2 st = group_stats(p.part1 + (size_t)(b * 2 + head) * P, P,
                                    p.eps1[head]);
      if (lane == 0) {
        red[0] = st.x;
        red[1] = st.y;
      }
    }
    __syncthreads();
    mean = red[0];
    rstd = red[1];
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(acc);

  for (int kb = 0; kb < nk; ++kb) {
    if (kb + kStages - 1 < nk) issue(kb + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // block kb's chunks of this thread landed
    const uint8_t* sa = stage + (kb % kStages) * S::kStage;
    const uint8_t* sb = sa + S::kStageA;
    uint8_t* oa = op_a + (kb & 1) * S::kOp;
    uint8_t* ob = op_b + (kb & 1) * S::kOp;
    float g[8], be[8];
    if constexpr (kL2) {
      const float4* gp =
          reinterpret_cast<const float4*>(norm + kb * kTile + 8 * c);
      const float4* bp = gp + kMaxDim / 4;
      const float4 g0 = gp[0], g1 = gp[1];
      const float4 b0 = bp[0], b1 = bp[1];
      g[0] = g0.x; g[1] = g0.y; g[2] = g0.z; g[3] = g0.w;
      g[4] = g1.x; g[5] = g1.y; g[6] = g1.z; g[7] = g1.w;
      be[0] = b0.x; be[1] = b0.y; be[2] = b0.z; be[3] = b0.w;
      be[4] = b1.x; be[5] = b1.y; be[6] = b1.z; be[7] = b1.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      uint4 va;
      if constexpr (kL2) {
        const uint4 raw = *reinterpret_cast<const uint4*>(sa + r * 128 +
                                                          c * 16);
        const bf16* h = reinterpret_cast<const bf16*>(&raw);
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = norm_relu(__bfloat162float(h[e]), mean, rstd, g[e], be[e]);
        va = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                        pack2(y[4], y[5]), pack2(y[6], y[7]));
      } else {
        va = octet_bf16(sa + r * 256 + c * 32);
      }
      *reinterpret_cast<uint4*>(oa + swizzled(r, c)) = va;
      *reinterpret_cast<uint4*>(ob + swizzled(r, c)) =
          octet_bf16(sb + r * 256 + c * 32);
    }
    fence_proxy_async();
    __syncthreads();  // both tiles of block kb are whole
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_ss_n64(acc, desc_k(smem_u32(oa) + kk * 32),
                   desc_k(smem_u32(ob) + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();  // block kb - 1's products are done ...
    __syncthreads();  // ... in every warp: its tiles may be overwritten
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: round to bf16 (the autocast GEMM's output), store, and the
  // tile's (mean, M2) of the rounded values
  bf16* out = kL2 ? p.h2 : p.h1;
  const int g = lane >> 2, tig = lane & 3;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = round_bf16(acc[i]);
    s += acc[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 16 * warp + g + 8 * half;
      const int col = n0 + 8 * j + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * two_d + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
    }
  }
  s = warp_sum(s);
  if (lane == 0) red[2 + warp] = s;
  __syncthreads();
  const float tmean = (red[2] + red[3] + red[4] + red[5]) * (1.f / kTileCount);
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float d = acc[i] - tmean;
    m2 += d * d;
  }
  m2 = warp_sum(m2);
  if (lane == 0) red[6 + warp] = m2;
  __syncthreads();
  if (t == 0) {
    float2* part = kL2 ? p.part2 : p.part1;
    part[(size_t)(b * 2 + head) * P + tile] =
        make_float2(tmean, red[6] + red[7] + red[8] + red[9]);
  }
}

// ------------------------------------------------------------------ K3 --
// One warp a query row, kOutWarps rows a CTA: GroupNorm 2 and ReLU on h2,
// the four output projections in f32, and the decode. The CTA stages the
// projections' f32 weights (and GroupNorm 2's scale and bias) in shared
// memory once for its rows; each lane holds its row's values at columns
// 4q .. 4q + 3, q = lane + 32 i.
__device__ __forceinline__ float lo_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void quad(const uint2& v, float (&f)[4]) {
  f[0] = lo_bf16(v.x);
  f[1] = hi_bf16(v.x);
  f[2] = lo_bf16(v.y);
  f[3] = hi_bf16(v.y);
}

__device__ __forceinline__ void quad(const float4& v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// out[n] = the row's values . weight row n (rows D apart from `w`), for N
// rows at once: N independent FMA chains and warp sums
template <int N, typename V>
__device__ __forceinline__ void row_dots(const V (&v)[kMaxQuads],
                                         const float* w, int D, int lane,
                                         float (&out)[N]) {
  float acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = lane + 32 * i;
    if (q < D / 4) {
      float f[4];
      quad(v[i], f);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float4 wv = *reinterpret_cast<const float4*>(w + n * D + 4 * q);
        acc[n] = fmaf(f[0], wv.x, acc[n]);
        acc[n] = fmaf(f[1], wv.y, acc[n]);
        acc[n] = fmaf(f[2], wv.z, acc[n]);
        acc[n] = fmaf(f[3], wv.w, acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) out[n] = warp_sum(acc[n]);
}

// `rows` rows of D f32 from `src` into shared memory at `dst`, by cp.async
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int D) {
  for (int c = threadIdx.x; c < rows * D / 4; c += blockDim.x)
    cp_async16(dst + 4 * c, src + 4 * c);
}

__global__ void __launch_bounds__(kOutWarps * 32)
heads_out_kernel(const HeadsArgs p) {
  extern __shared__ float4 wsm4[];  // (9 + NC + 3 + 4) x D f32
  __shared__ float stats[4];
  __shared__ float res[kOutWarps][kMaxOut];
  float* wsm = reinterpret_cast<float*>(wsm4);
  const int D = p.D, Q = p.Q, NC = p.NC, quads = D / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kOutWarps + warp;
  const int b = (blockIdx.x * kOutWarps) / Q;   // Q % kOutWarps == 0
  const int P = (Q / kTile) * (D / kTile);
  // weight rows: center 0..2, rotation 3..8, classes 9.., size last
  stage_rows(wsm, p.w3[0], 3, D);
  stage_rows(wsm + 3 * D, p.w3[1], 6, D);
  stage_rows(wsm + 9 * D, p.ws, NC, D);
  stage_rows(wsm + (9 + NC) * D, p.wz, 3, D);
  float* norm = wsm + (12 + NC) * D;   // GroupNorm 2: scale, bias per head
  for (int k = 0; k < 2; ++k) {
    stage_rows(norm + 2 * k * D, p.g2[k], 1, D);
    stage_rows(norm + (2 * k + 1) * D, p.b2[k], 1, D);
  }
  cp_async_commit();

  // the row's h2 and x, loaded while the statistics are combined
  uint2 raw[2][kMaxQuads];
  float4 x[kMaxQuads];
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = lane + 32 * i;
    if (q < quads) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
        raw[k][i] = *reinterpret_cast<const uint2*>(
            p.h2 + (size_t)row * 2 * D + k * D + 4 * q);
      x[i] = *reinterpret_cast<const float4*>(p.x + (size_t)row * D + 4 * q);
    }
  }
  if (warp < 2) {
    const float2 st = group_stats(p.part2 + (size_t)(b * 2 + warp) * P, P,
                                  p.eps2[warp]);
    if (lane == 0) {
      stats[2 * warp] = st.x;
      stats[2 * warp + 1] = st.y;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  uint2 y[2][kMaxQuads];
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = lane + 32 * i;
    if (q < quads) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 g = reinterpret_cast<const float4*>(norm + 2 * k * D)[q];
        const float4 be =
            reinterpret_cast<const float4*>(norm + (2 * k + 1) * D)[q];
        const float mean = stats[2 * k], rstd = stats[2 * k + 1];
        const uint2 u = raw[k][i];
        y[k][i] = make_uint2(
            pack2(norm_relu(lo_bf16(u.x), mean, rstd, g.x, be.x),
                  norm_relu(hi_bf16(u.x), mean, rstd, g.y, be.y)),
            pack2(norm_relu(lo_bf16(u.y), mean, rstd, g.z, be.z),
                  norm_relu(hi_bf16(u.y), mean, rstd, g.w, be.w)));
      }
    }
  }

  // center 0..2, rotation 3..8, then the NC + 3 products over x in threes
  // (the last three rows taken again where NC + 3 is no multiple of 3)
  float* r = res[warp];
  float v[3];
  row_dots(y[0], wsm, D, lane, v);
  if (lane == 0)
    for (int n = 0; n < 3; ++n) r[n] = v[n] + p.b3[0][n];
  for (int o = 0; o < 6; o += 3) {
    row_dots(y[1], wsm + (3 + o) * D, D, lane, v);
    if (lane == 0)
      for (int n = 0; n < 3; ++n) r[3 + o + n] = v[n] + p.b3[1][o + n];
  }
  const int nx = NC + 3;
#pragma unroll 1
  for (int o0 = 0; o0 < nx; o0 += 3) {
    const int o = min(o0, nx - 3);
    row_dots(x, wsm + (9 + o) * D, D, lane, v);
    if (lane == 0)
      for (int n = 0; n < 3; ++n)
        r[9 + o + n] = v[n] + (o + n < NC ? p.bs[o + n] : p.bz[o + n - NC]);
  }
  __syncwarp();

  // softmax over the NC logits, one a lane, reduced by the xor butterfly of
  // PyTorch's warp softmax (lanes past NC add exact zeros)
  const float logit = lane < NC ? r[9 + lane] : -INFINITY;
  float mx = logit;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float e = lane < NC ? expf(__fsub_rn(logit, mx)) : 0.f;
  float sum = e;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  const float prob = __fdiv_rn(e, sum);
  if (lane < NC) {
    p.logits[(size_t)row * NC + lane] = logit;
    p.prob[(size_t)row * NC + lane] = prob;
  }
  // argmax of the probabilities: the first index of the largest
  float best = lane < NC ? prob : -INFINITY;
  int arg = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }

  if (lane < 3) {
    const int q = row - b * Q;
    float rf = p.ref[b * p.ref_bstride + q * 3 + lane];
    rf = fminf(fmaxf(rf, 0.f), 1.f);
    // inverse_sigmoid's eps (geometry/rays.py) is 1e-3
    const float inv = logf(__fdiv_rn(fmaxf(rf, 1e-3f),
                                     fmaxf(__fsub_rn(1.f, rf), 1e-3f)));
    const float z = __fadd_rn(r[lane], inv);
    const float cn = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
    const float cu = __fadd_rn(__fmul_rn(cn, p.smul[lane]), p.sadd[lane]);
    p.center[(size_t)row * 3 + lane] = cu;
    p.new_ref[(size_t)row * 3 + lane] =
        __fmul_rn(__fsub_rn(cu, p.sadd[lane]), p.sinv[lane]);
    p.size[(size_t)row * 3 + lane] =
        __fmul_rn(expf(r[9 + NC + lane]), p.mean_size[arg * 3 + lane]);
  }
  if (lane < 6) p.ortho[(size_t)row * 6 + lane] = r[3 + lane];
}

}  // namespace

// All tensors on the card, contiguous, 16-byte aligned (the wrapper checks);
// Q and D multiples of 64, D <= 1024, NC <= 32. Launches K1, K2, K3 on
// `stream` and returns the first cudaError_t.
extern "C" int parq_detection_heads(const parq::HeadsArgs* args, void* stream) {
  const HeadsArgs& p = *args;
  if (p.Q % kTile || p.D % kTile || p.D > kMaxDim || p.NC < 1 ||
      p.NC > kMaxClasses || p.B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      heads_gemm_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GemmSmem<false>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(heads_gemm_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GemmSmem<true>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = p.B * p.Q;
  const dim3 grid(2 * p.D / kTile, M / kTile);
  heads_gemm_kernel<false><<<grid, kThreads, GemmSmem<false>::kBytes, s>>>(p);
  heads_gemm_kernel<true><<<grid, kThreads, GemmSmem<true>::kBytes, s>>>(p);
  err = cudaFuncSetAttribute(heads_out_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (kMaxOut + 4) * kMaxDim * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  heads_out_kernel<<<M / kOutWarps, kOutWarps * 32,
                     (9 + p.NC + 3 + 4) * p.D * 4, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
