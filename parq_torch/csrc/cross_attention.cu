// Kernels B2 and B3: flash cross-attention over the fused K/V buffer,
// forward and backward, for Hopper (sm_90a).
//
// B2 replaces parq_tpu/kernels/cross_attention_pallas.py:_fwd_call (:457),
// body _fwd_kernel (:120), in two forms:
//   - eval (flash_cross_attention_kv_fused, :736): no dropout, no LSE;
//   - train (the _fwd_lse / _train entries, :882-911): it also writes the
//     rowwise logsumexp and applies weight dropout in the kernel.
// B3 (the backward, _bwd_call :547, body _bwd_kernel :252) is at the end of
// this file. All take the head-interleaved (B, N, H*2D) layout where lanes
// [h*2D, h*2D+D) hold K_h and [h*2D+D, (h+1)*2D) hold V_h. The buffer is
// read in place at offset h*2D; it is never sliced in memory.
//
//   o[b,h,q,:] = softmax_n(q[b,h,q,:] . K_h[b,n,:] / sqrt(D)) @ V_h[b,:,:]
//
// Train form. lse[b,h,q] = log sum_n exp(s) in natural-log units: the
// kernels run in base 2 (s is scaled by sm_scale * log2 e), so
// lse = m2 * ln 2 + ln(max(l, 1e-37)). Dropout multiplies p by
// keep / (1 - rate) AFTER l has summed the undropped p (the weights are
// dropped after normalisation, as flax and torch do). keep is the JAX
// package's v1 counter hash (_keep_mask, :107-117), bit for bit:
//   h0 = seed * 2654435761 ^ (b*H + h) * 2246822519
//   h  = fmix32(h0 + row * 3266489917 + col * 668265263)
//   keep = h >= min(floor(rate * 2^32), 2^32 - 1)
// with `row` local to the row's seed group (row mod Q/G), the seed taken
// from the group (row div Q/G), and `col` the GLOBAL kv index. Each
// fragment element derives its own row and seed from its global q row, so
// the CTA's 64- or 32-row tile need not match the seed groups, and a
// folded call of G groups draws exactly what G separate calls draw.
//
// Softmax, in both kernels below: the online-max form in f32 with exp2
// (sm_scale * log2(e) scales the f32 scores). The ragged last KV block is
// masked with a large negative number (not -inf, so exp2 stays NaN-free),
// its K/V rows are staged as zeros, and the final 1/l is guarded. The TPU's
// static-shift softmax (no running max, cross_attention_pallas.py:181-211)
// is a TPU lever and is not ported.
//
// What bounds it: at the release shape (B=8, H=4, Q=256, N=14400, D=256)
// 4*B*H*Q*N*D = 121 GFLOP per call against one 472 MB read of the bf16
// K/V: 0.12 ms of bf16 tensor-core time vs 0.14 ms of memory time, so
// bytes, by a little.
//
// bf16 (the serving path) — flash_fwd_bf16_kernel: both products on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). One CTA of
// 4 warps per (b, h, 64-query tile); each warp owns 16 query rows. KV
// blocks of 64 tokens are double-buffered in shared memory with cp.async,
// so the next block's loads overlap this block's products. Scores stay in
// registers: the S accumulator fragment of QK^T is, after the softmax and
// a round to bf16, exactly the A fragment of PV (the FlashAttention-2
// register reuse), so P never touches shared memory. V's B fragments come
// through ldmatrix.trans. Rows are padded by 16 bytes in shared memory so
// the fragment loads of a warp hit 32 distinct banks. O (16 x D per warp)
// stays in registers for the whole KV loop and is written once.
//
// f32 (the parity path) — flash_fwd_f32_kernel: SIMT f32 FMA, exact f32
// products. One CTA of 8 warps per (b, h, 32-query tile); lane j of a warp
// owns KV token j of a 32-token block and scores the warp's 4 rows, so row
// max and row sum are warp shuffles; P goes through warp-private shared
// rows; each lane accumulates D/32 output columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

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

// ------------------------------------------------------------ bf16 path --
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = kWarps * 16;  // query rows per CTA
constexpr int kBK = 64;           // KV tokens per block

template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 8;  // bf16 elements: each row padded by 16 bytes
}

template <int D>
constexpr int smem_bytes() {
  return (kQT + 4 * kBK) * row_stride<D>() * 2;  // Q + 2 x (K, V)
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

template <int D, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kv,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      Dropout drop, int H, int Q, int N, float qscale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int S = row_stride<D>();
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ float4 smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kQT * S;       // [2][kBK][S]
  __nv_bfloat16* sV = sK + 2 * kBK * S;   // [2][kBK][S]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row / column pair
  const int q0 = tile * kQT;
  const __nv_bfloat16* qbh = q + ((long long)b * H + h) * Q * D;
  const long long kv_row = (long long)H * 2 * D;
  const __nv_bfloat16* kvb = kv + (long long)b * N * kv_row
                           + (long long)h * 2 * D;

  for (int c = tid; c < kQT * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = q0 + r < Q;
    cp_async16(sQ + r * S + col, qbh + (ok ? (long long)(q0 + r) * D : 0)
               + col, ok);
  }
  auto load_kv = [&](int blk, int buf) {
    const int n0 = blk * kBK;
    __nv_bfloat16* dk = sK + buf * kBK * S;
    __nv_bfloat16* dv = sV + buf * kBK * S;
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool ok = n0 + r < N;
      const __nv_bfloat16* row = kvb + (ok ? (long long)(n0 + r) * kv_row : 0);
      cp_async16(dk + r * S + col, row + col, ok);
      cp_async16(dv + r * S + col, row + D + col, ok);
    }
  };
  const int nblocks = (N + kBK - 1) / kBK;
  load_kv(0, 0);
  cp_async_commit();  // group 0: the q tile and KV block 0

  float acc[D / 8][4];  // O: 16 rows x D per warp, as D/8 mma C tiles
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;                // this thread's partial row sums
  const __nv_bfloat16* sQw = sQ + warp * 16 * S;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  uint32_t h00 = 0, h01 = 0, lr0 = 0, lr1 = 0;  // dropout: h0, local rows
  if (kTrain && drop.thresh) {
    const int bh = b * H + h;
    const int r0 = min(row0, Q - 1), r1 = min(row1, Q - 1);
    h00 = row_h0(drop, bh, r0);
    h01 = row_h0(drop, bh, r1);
    lr0 = r0 % drop.group_rows;
    lr1 = r1 % drop.group_rows;
  }

  for (int blk = 0; blk < nblocks; ++blk) {
    if (blk + 1 < nblocks) {
      load_kv(blk + 1, (blk + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the block just issued
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + (blk & 1) * kBK * S;
    const __nv_bfloat16* cV = sV + (blk & 1) * kBK * S;

    // S = Q K^T for this warp's 16 rows x 64 tokens (8 C tiles of 16x8)
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      a[0] = ld32(sQw + g * S + k0 + tig * 2);
      a[1] = ld32(sQw + (g + 8) * S + k0 + tig * 2);
      a[2] = ld32(sQw + g * S + k0 + 8 + tig * 2);
      a[3] = ld32(sQw + (g + 8) * S + k0 + 8 + tig * 2);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t bk[2];
        bk[0] = ld32(cK + (j * 8 + g) * S + k0 + tig * 2);
        bk[1] = ld32(cK + (j * 8 + g) * S + k0 + 8 + tig * 2);
        mma_bf16(s[j], a, bk);
      }
    }

    // online softmax in base 2; a quad (same g) shares each row
    const int n0 = blk * kBK;
    float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + tig * 2 + (e & 1);
        s[j][e] = col < N ? s[j][e] * qscale : kMaskValue;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t p[kBK / 16][4];  // P as the A fragments of PV
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
      float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      if (kTrain && drop.thresh) {  // after l: l sums the undropped p
        const uint32_t c = n0 + j * 8 + tig * 2;
        const float ks = drop.keep_scale;
        p0 = keep_bit(h00, lr0, c, drop.thresh) ? p0 * ks : 0.f;
        p1 = keep_bit(h00, lr0, c + 1, drop.thresh) ? p1 * ks : 0.f;
        p2 = keep_bit(h01, lr1, c, drop.thresh) ? p2 * ks : 0.f;
        p3 = keep_bit(h01, lr1, c + 1, drop.thresh) ? p3 * ks : 0.f;
      }
      p[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);      // a0 / a2
      p[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);  // a1 / a3
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: ldmatrix.trans gives the B fragments of two 8-column tiles
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, cV + (kk * 16 + (mi & 1) * 8 + mr) * S + n * 8 + (mi >> 1) * 8);
        mma_bf16(acc[n], p[kk], bv);
        mma_bf16(acc[n + 1], p[kk], bv + 2);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // guarded final 1/l
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (kTrain && tig == 0) {  // natural-log units: m2 ln 2 + ln l
    float* lbh = lse + ((long long)b * H + h) * Q;
    if (row0 < Q) lbh[row0] = m0 * kLn2 + logf(fmaxf(l0, 1e-37f));
    if (row1 < Q) lbh[row1] = m1 * kLn2 + logf(fmaxf(l1, 1e-37f));
  }
  __nv_bfloat16* obh = o + ((long long)b * H + h) * Q * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row0 < Q)
      *reinterpret_cast<uint32_t*>(obh + (long long)row0 * D + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < Q)
      *reinterpret_cast<uint32_t*>(obh + (long long)row1 * D + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D, bool kTrain>
cudaError_t launch(const void* q, const void* kv, void* o, float* lse,
                   Dropout drop, int B, int H, int Q, int N, float qscale,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, kTrain>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kQT - 1) / kQT, H, B);
  flash_fwd_bf16_kernel<D, kTrain><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv), static_cast<__nv_bfloat16*>(o),
      lse, drop, H, Q, N, qscale);
  return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------------------- f32 path --
namespace simt {

constexpr int kQT = 32;              // query rows per CTA
constexpr int kBK = 32;              // KV tokens per block (one per lane)
constexpr int kWarps = 8;
constexpr int kRows = kQT / kWarps;  // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kKPad = 4;             // K row padding (floats): 8 lanes' 16-
                                     // byte loads hit distinct banks

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr int smem_bytes() {
  return (kQT * D + kBK * (D + kKPad) + kBK * D + kQT * kBK) * 4;
}

template <int D, bool kTrain>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                     float* __restrict__ o, float* __restrict__ lse,
                     Dropout drop, int H, int Q, int N, float qscale) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int KS = D + kKPad;
  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // kQT x D
  float* sK = sQ + kQT * D;                        // kBK x KS
  float* sV = sK + kBK * KS;                       // kBK x D
  float* sP = sV + kBK * D;                        // kQT x kBK

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = tile * kQT;

  // stage the q tile, pre-scaled by sm_scale*log2(e) in f32; pad rows = 0
  const float* qbh = q + ((long long)b * H + h) * Q * D;
  for (int e = tid * 4; e < kQT * D; e += kThreads * 4) {
    const int r = e / D, c = e % D;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Q)
      v = *reinterpret_cast<const float4*>(qbh + (long long)(q0 + r) * D + c);
    *reinterpret_cast<float4*>(sQ + r * D + c) =
        make_float4(v.x * qscale, v.y * qscale, v.z * qscale, v.w * qscale);
  }

  float m[kRows], l[kRows], acc[kRows][D / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 32; ++k) acc[r][k] = 0.f;
  }

  const long long kv_row = (long long)H * 2 * D;
  const float* kvb = kv + (long long)b * N * kv_row + (long long)h * 2 * D;
  const float* sQw = sQ + warp * kRows * D;
  float* sPw = sP + warp * kRows * kBK;
  uint32_t h0[kRows], lrow[kRows];  // dropout: per-row h0 and local row
  if (kTrain && drop.thresh) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = min(q0 + warp * kRows + r, Q - 1);
      h0[r] = row_h0(drop, b * H + h, row);
      lrow[r] = row % drop.group_rows;
    }
  }

  for (int n0 = 0; n0 < N; n0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V block
    for (int e = tid * 4; e < kBK * D; e += kThreads * 4) {
      const int r = e / D, c = e % D;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (n0 + r < N) {
        const float* row = kvb + (long long)(n0 + r) * kv_row;
        kk = *reinterpret_cast<const float4*>(row + c);
        vv = *reinterpret_cast<const float4*>(row + D + c);
      }
      *reinterpret_cast<float4*>(sK + r * KS + c) = kk;
      *reinterpret_cast<float4*>(sV + r * D + c) = vv;
    }
    __syncthreads();

    // scores of this warp's rows against KV token n0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = sK + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(sQw + r * D + d);
        s[r] = fmaf(q4.x, k4.x, s[r]);
        s[r] = fmaf(q4.y, k4.y, s[r]);
        s[r] = fmaf(q4.z, k4.z, s[r]);
        s[r] = fmaf(q4.w, k4.w, s[r]);
      }
    }

    // online softmax (base 2), running stats per row in registers
    const bool valid = n0 + lane < N;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sr = valid ? s[r] : kMaskValue;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = exp2f(m[r] - m_new);
      float p = exp2f(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      if (kTrain && drop.thresh)  // after l: l sums the undropped p
        p = keep_bit(h0[r], lrow[r], n0 + lane, drop.thresh)
                ? p * drop.keep_scale : 0.f;
      sPw[r * kBK + lane] = p;
#pragma unroll
      for (int k = 0; k < D / 32; ++k) acc[r][k] *= alpha;
    }
    __syncwarp();

    // o += p @ v over this block; lane owns columns lane + 32k
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float v[D / 32];
#pragma unroll
      for (int k = 0; k < D / 32; ++k) v[k] = sV[j * D + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = sPw[r * kBK + j];
#pragma unroll
        for (int k = 0; k < D / 32; ++k) acc[r][k] = fmaf(p, v[k], acc[r][k]);
      }
    }
    __syncwarp();  // sPw is rewritten by the next block
  }

  float* obh = o + ((long long)b * H + h) * Q * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= Q) continue;
    if (kTrain && lane == 0)  // natural-log units: m2 ln 2 + ln l
      lse[((long long)b * H + h) * Q + row] =
          m[r] * kLn2 + logf(fmaxf(l[r], 1e-37f));
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // guarded final 1/l
#pragma unroll
    for (int k = 0; k < D / 32; ++k)
      obh[(long long)row * D + lane + 32 * k] = acc[r][k] * inv;
  }
}

template <int D, bool kTrain>
cudaError_t launch(const void* q, const void* kv, void* o, float* lse,
                   Dropout drop, int B, int H, int Q, int N, float qscale,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, kTrain>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kQT - 1) / kQT, H, B);
  flash_fwd_f32_kernel<D, kTrain><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kv),
      static_cast<float*>(o), lse, drop, H, Q, N, qscale);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------------------- B3: backward --
//
// Replaces cross_attention_pallas.py:_bwd_call (:547), body _bwd_kernel
// (:252), in its fused-KV form (kv_fused=True), as the VJP of the _train
// and _precomputed entries (:814-852). For each (b, h), from q, kv, do,
// the forward's lse and delta = rowsum(do * o) (computed outside, f32):
//   p  = exp(s - lse),  s = q . k / sqrt(D)    (recomputed, never stored)
//   w  = p * keep / (1 - rate)                 (the forward's weights)
//   dw = do . v
//   ds = w * dw - p * delta
//   dq = sm_scale * ds @ k,  dk = sm_scale * ds^T @ q,  dv = w^T @ do
// In bf16, ds and w are rounded to bf16 before the last three products,
// as the JAX kernel does (:341-342). dK|dV are written into the fused
// (B, N, H*2D) layout, summed over ALL q rows: at the release fold that is
// 2048 rows in 8 seed groups, so the cotangents of all 8 iterations
// accumulate inside the kernel.
//
// What bounds it: operations. 10*B*H*Q*N*D = 2.42 TFLOP at the release fold
// (B=8, H=4, Q=2048, N=14400, D=256) against ~1 GB of bytes.
//
// Design. The TPU kernel accumulates dK/dV across q tiles in VMEM and dq
// across kv blocks in scratch, on one core in grid order. Here that becomes
// two kernels, so that no accumulator is shared between CTAs and nothing
// needs atomics. f32 (the parity path) runs the SIMT kernels of `bwd`
// below, exact f32 FMA; bf16 (the training path) runs the tensor-core
// kernels of `tcb`, which follow the same split. The SIMT passes:
//   - dkv pass: one CTA of 8 warps per (b, h, 32-token KV block); lane j
//     owns token j. dK and dV for the block (32 x D each, 64 KB f32 at
//     D=256: too large for one thread's registers) are split over the 8
//     warps by column: each thread keeps D/8 columns of dK and of dV of its
//     token in registers (64 floats at D=256). The CTA walks all Q rows in
//     steps of 8 (one row per warp), stages q, do, ds and w in shared
//     memory, and never writes a partial sum out.
//   - dq pass: one CTA of 8 warps per (b, h, 32-row q tile), walking all
//     KV blocks as the forward does; each lane keeps D/32 columns of dq for
//     the warp's 4 rows. It recomputes s and dw (3 of the 5 products again).
// K and V rows are padded by 4 floats in shared memory so that 8 lanes'
// 16-byte loads of 8 different rows hit distinct banks.
namespace bwd {

constexpr int kBK = 32;      // KV tokens per block (one per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQS = kWarps;  // dkv pass: q rows per step (one per warp)
constexpr int kQT = 32;      // dq pass: q rows per CTA
constexpr int kRows = kQT / kWarps;
constexpr int kPad = 4;

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// stage `rows` rows of a (.., D) tensor with row stride `ld_src` (rows at
// or past `valid` as zeros) into f32 shared rows of stride `ld_dst`
template <int D>
__device__ __forceinline__ void stage(float* dst, int ld_dst, const float* src,
                                      long long ld_src, int rows, int valid,
                                      int tid) {
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * ld_dst + c] = r < valid ? src[r * ld_src + c] : 0.f;
  }
}

// p, w and ds of one (row, col) pair; zero for a row or col out of range
__device__ __forceinline__ void grads_of_pair(
    float s, float dw, float lse, float delta, bool valid, bool keep,
    float keep_scale, float* w_out, float* ds_out) {
  const float p = valid ? expf(s - lse) : 0.f;
  const float w = keep ? p * keep_scale : 0.f;
  *w_out = w;
  *ds_out = w * dw - p * delta;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBK * (D + kPad) + 2 * kQS * D + 2 * kQS * kBK + 2 * kQS) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, Dropout drop,
                     float* __restrict__ dkv, int H, int Q, int N,
                     float sm_scale) {
  constexpr int KS = D + kPad;
  constexpr int DC = D / kWarps;  // dK/dV columns per thread
  extern __shared__ float4 smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // kBK x KS
  float* sV = sK + kBK * KS;                       // kBK x KS
  float* sQ = sV + kBK * KS;                       // kQS x D
  float* sDO = sQ + kQS * D;                       // kQS x D
  float* sW = sDO + kQS * D;                       // kQS x kBK
  float* sDS = sW + kQS * kBK;                     // kQS x kBK
  float* sL = sDS + kQS * kBK;                     // kQS lse
  float* sD = sL + kQS;                            // kQS delta

  const int n0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = b * H + h;
  const long long kv_row = (long long)H * 2 * D;
  const float* kvb = kv + ((long long)b * N + n0) * kv_row + (long long)h * 2 * D;
  stage<D>(sK, KS, kvb, kv_row, kBK, N - n0, tid);
  stage<D>(sV, KS, kvb + D, kv_row, kBK, N - n0, tid);

  float dk[DC], dv[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) dk[i] = dv[i] = 0.f;
  const int c0 = warp * DC;
  const bool col_ok = n0 + lane < N;
  const float* qbh = q + (long long)bh * Q * D;
  const float* dobh = dout + (long long)bh * Q * D;

  for (int r0 = 0; r0 < Q; r0 += kQS) {
    __syncthreads();  // the previous step is done with sQ, sDO, sW, sDS
    stage<D>(sQ, D, qbh + (long long)r0 * D, D, kQS, Q - r0, tid);
    stage<D>(sDO, D, dobh + (long long)r0 * D, D, kQS, Q - r0, tid);
    if (tid < kQS) {
      const bool ok = r0 + tid < Q;
      sL[tid] = ok ? lse[(long long)bh * Q + r0 + tid] : 0.f;
      sD[tid] = ok ? delta[(long long)bh * Q + r0 + tid] : 0.f;
    }
    __syncthreads();

    // one (row, token) pair per thread: row r0 + warp, token n0 + lane
    {
      const int row = r0 + warp;
      const float s = dot<D>(sQ + warp * D, sK + lane * KS) * sm_scale;
      const float dw = dot<D>(sDO + warp * D, sV + lane * KS);
      bool keep = true;
      if (drop.thresh && row < Q)
        keep = keep_bit(row_h0(drop, bh, row), row % drop.group_rows,
                        n0 + lane, drop.thresh);
      float w, ds;
      grads_of_pair(s, dw, sL[warp], sD[warp], row < Q && col_ok, keep,
                       drop.thresh ? drop.keep_scale : 1.f, &w, &ds);
      sW[warp * kBK + lane] = w;
      sDS[warp * kBK + lane] = ds;
    }
    __syncthreads();

    // dK[token, c0:c0+DC] += ds^T q ; dV[token, ...] += w^T do
#pragma unroll
    for (int r = 0; r < kQS; ++r) {
      const float dsv = sDS[r * kBK + lane], wv = sW[r * kBK + lane];
#pragma unroll
      for (int i = 0; i < DC; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + r * D + c0 + i);
        const float4 ov = *reinterpret_cast<const float4*>(sDO + r * D + c0 + i);
        dk[i] = fmaf(dsv, qv.x, dk[i]);
        dk[i + 1] = fmaf(dsv, qv.y, dk[i + 1]);
        dk[i + 2] = fmaf(dsv, qv.z, dk[i + 2]);
        dk[i + 3] = fmaf(dsv, qv.w, dk[i + 3]);
        dv[i] = fmaf(wv, ov.x, dv[i]);
        dv[i + 1] = fmaf(wv, ov.y, dv[i + 1]);
        dv[i + 2] = fmaf(wv, ov.z, dv[i + 2]);
        dv[i + 3] = fmaf(wv, ov.w, dv[i + 3]);
      }
    }
  }

  if (!col_ok) return;
  float* out =
      dkv + ((long long)b * N + n0 + lane) * kv_row + (long long)h * 2 * D;
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    out[c0 + i] = dk[i] * sm_scale;
    out[D + c0 + i] = dv[i];
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kQT * D + 2 * kBK * (D + kPad) + kQT * kBK) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Dropout drop,
                    float* __restrict__ dq, int H, int Q, int N,
                    float sm_scale) {
  constexpr int KS = D + kPad;
  extern __shared__ float4 smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // kQT x D
  float* sDO = sQ + kQT * D;                       // kQT x D
  float* sK = sDO + kQT * D;                       // kBK x KS
  float* sV = sK + kBK * KS;                       // kBK x KS
  float* sDS = sV + kBK * KS;                      // kQT x kBK

  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = b * H + h;
  stage<D>(sQ, D, q + ((long long)bh * Q + q0) * D, D, kQT, Q - q0, tid);
  stage<D>(sDO, D, dout + ((long long)bh * Q + q0) * D, D, kQT, Q - q0,
              tid);

  float rl[kRows], rd[kRows], acc[kRows][D / 32];
  uint32_t h0[kRows], lrow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    const bool ok = row < Q;
    rl[r] = ok ? lse[(long long)bh * Q + row] : 0.f;
    rd[r] = ok ? delta[(long long)bh * Q + row] : 0.f;
    if (drop.thresh) {
      const int rr = min(row, Q - 1);
      h0[r] = row_h0(drop, bh, rr);
      lrow[r] = rr % drop.group_rows;
    }
#pragma unroll
    for (int k = 0; k < D / 32; ++k) acc[r][k] = 0.f;
  }

  const long long kv_row = (long long)H * 2 * D;
  const float* kvb = kv + (long long)b * N * kv_row + (long long)h * 2 * D;
  float* sDSw = sDS + warp * kRows * kBK;
  for (int n0 = 0; n0 < N; n0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V block
    stage<D>(sK, KS, kvb + (long long)n0 * kv_row, kv_row, kBK, N - n0,
                tid);
    stage<D>(sV, KS, kvb + (long long)n0 * kv_row + D, kv_row, kBK,
                N - n0, tid);
    __syncthreads();
    const bool col_ok = n0 + lane < N;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int lr = warp * kRows + r;
      const float s = dot<D>(sQ + lr * D, sK + lane * KS) * sm_scale;
      const float dw = dot<D>(sDO + lr * D, sV + lane * KS);
      const bool keep = drop.thresh
          ? keep_bit(h0[r], lrow[r], n0 + lane, drop.thresh) : true;
      float w, ds;
      grads_of_pair(s, dw, rl[r], rd[r], q0 + lr < Q && col_ok, keep,
                       drop.thresh ? drop.keep_scale : 1.f, &w, &ds);
      sDSw[r * kBK + lane] = ds;
    }
    __syncwarp();
    // dq[row, lane + 32k] += sum_j ds[row, j] * k[j, lane + 32k]
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kk[D / 32];
#pragma unroll
      for (int k = 0; k < D / 32; ++k) kk[k] = sK[j * KS + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsv = sDSw[r * kBK + j];
#pragma unroll
        for (int k = 0; k < D / 32; ++k) acc[r][k] = fmaf(dsv, kk[k], acc[r][k]);
      }
    }
    __syncwarp();  // sDSw is rewritten by the next block
  }

  float* dqbh = dq + (long long)bh * Q * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= Q) continue;
#pragma unroll
    for (int k = 0; k < D / 32; ++k)
      dqbh[(long long)row * D + lane + 32 * k] = acc[r][k] * sm_scale;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* kv, const void* dout,
                   const float* lse, const float* delta, Dropout drop,
                   void* dq, void* dkv, int B, int H, int Q, int N,
                   cudaStream_t stream) {
  const float sm_scale = 1.f / sqrtf(static_cast<float>(D));
  constexpr int smem_kv = dkv_smem_bytes<D>();
  constexpr int smem_q = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const float* tq = static_cast<const float*>(q);
  const float* tkv = static_cast<const float*>(kv);
  const float* tdo = static_cast<const float*>(dout);
  flash_bwd_dkv_kernel<D>
      <<<dim3((N + kBK - 1) / kBK, H, B), kThreads, smem_kv, stream>>>(
          tq, tkv, tdo, lse, delta, drop, static_cast<float*>(dkv), H, Q, N,
          sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D>
      <<<dim3((Q + kQT - 1) / kQT, H, B), kThreads, smem_q, stream>>>(
          tq, tkv, tdo, lse, delta, drop, static_cast<float*>(dq), H, Q, N,
          sm_scale);
  return cudaGetLastError();
}

}  // namespace bwd

// bf16 B3 on the tensor cores: the same two passes as `bwd`, every product
// an mma.sync m16n8k16 (bf16 in, f32 accumulate), the FlashAttention-2
// backward's register reuse:
//   - dkv pass: one CTA of 8 warps per (b, h, 64-token KV block). Warp w
//     owns tokens 16*(w%4) .. +15 and columns (w/4)*D/2 .. +D/2 of dK and
//     dV (64 + 64 f32 registers at D=256). K and V of the block stay in
//     shared memory; q and do come in 32-row steps, double-buffered with
//     cp.async. Each warp computes S^T = K Q^T and dW^T = V dO^T for its
//     16 tokens, so the C fragments of P^T and dS^T are, rounded to bf16,
//     the A fragments of dV += W^T dO and dK += dS^T Q (B operands through
//     ldmatrix.trans). The two warps of a token group both compute its
//     S^T and dW^T: 6 products' worth of work for 4, bought to keep the
//     accumulators in registers.
//   - dq pass: one CTA of 4 warps per (b, h, 64-row q tile) walking
//     32-token KV blocks (double-buffered), as the forward does: S = Q K^T
//     and dW = dO V^T, dS in registers, dQ += dS K.
// p = exp2(s * sm_scale * log2 e - lse * log2 e); masked rows and tokens
// get p = 0 (rows past Q have lse = 1e30 and delta = 0).
namespace tcb {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ld32;
using tc::ldmatrix_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::row_stride;
typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKVT = 64;  // dkv pass: tokens per CTA (4 groups of 16)
constexpr int kQS = 32;   // dkv pass: q rows per step
constexpr int kQT = 64;   // dq pass: q rows per CTA (4 warps of 16)
constexpr int kBK = 32;   // dq pass: tokens per KV block

template <int D>
constexpr int smem_bytes() {  // both passes: 256 rows of D bf16 + stats
  return (2 * kKVT + 4 * kQS) * row_stride<D>() * 2 + 4 * kQS * 4;
}

// the A fragments (k = the n-tiles' columns) of a C-fragment tile, in bf16
template <int NT>
__device__ __forceinline__ void pack_a(const float (*c)[4], uint32_t (*a)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(c[j][0], c[j][1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, Dropout drop,
                        bf16* __restrict__ dkv, int H, int Q, int N,
                        float sm_scale) {
  constexpr int S = row_stride<D>();
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int DH = D / 2;   // dK/dV columns per warp
  constexpr int NT = kQS / 8; // n-tiles of S^T (q rows)
  extern __shared__ float4 smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kKVT * S;
  bf16* sQ = sV + kKVT * S;        // [2][kQS][S]
  bf16* sDO = sQ + 2 * kQS * S;    // [2][kQS][S]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kQS * S);  // [2][kQS]
  float* sDl = sL + 2 * kQS;                                // [2][kQS]

  const int n0 = blockIdx.x * kKVT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int c0 = (warp >> 2) * DH;
  const int bh = b * H + h;
  const long long kv_row = (long long)H * 2 * D;
  const bf16* kvb = kv + (long long)b * N * kv_row + (long long)h * 2 * D;
  const bf16* qbh = q + (long long)bh * Q * D;
  const bf16* dobh = dout + (long long)bh * Q * D;

  for (int c = tid; c < kKVT * CH; c += 256) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = n0 + r < N;
    const bf16* row = kvb + (ok ? (long long)(n0 + r) * kv_row : 0);
    cp_async16(sK + r * S + col, row + col, ok);
    cp_async16(sV + r * S + col, row + D + col, ok);
  }
  auto load_q = [&](int r0, int buf) {
    bf16* tq = sQ + buf * kQS * S;
    bf16* tdo = sDO + buf * kQS * S;
    for (int c = tid; c < kQS * CH; c += 256) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool ok = r0 + r < Q;
      const long long off = (ok ? (long long)(r0 + r) * D : 0) + col;
      cp_async16(tq + r * S + col, qbh + off, ok);
      cp_async16(tdo + r * S + col, dobh + off, ok);
    }
    if (tid < kQS) {
      const bool ok = r0 + tid < Q;
      sL[buf * kQS + tid] =
          ok ? lse[(long long)bh * Q + r0 + tid] * kLog2e : 1e30f;
      sDl[buf * kQS + tid] = ok ? delta[(long long)bh * Q + r0 + tid] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();  // group 0: the K/V block and q step 0

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const bf16* sKw = sK + (warp & 3) * 16 * S;
  const bf16* sVw = sV + (warp & 3) * 16 * S;
  const uint32_t tok0 = n0 + (warp & 3) * 16 + g;  // fragment rows g, g + 8
  const float qk = sm_scale * kLog2e;
  const float ks = drop.thresh ? drop.keep_scale : 1.f;
  const int mi = lane >> 3, mr = lane & 7;
  const int nsteps = (Q + kQS - 1) / kQS;

  for (int it = 0; it < nsteps; ++it) {
    const int r0 = it * kQS;
    if (it + 1 < nsteps) {
      load_q(r0 + kQS, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + (it & 1) * kQS * S;
    const bf16* cDO = sDO + (it & 1) * kQS * S;
    const float* cL = sL + (it & 1) * kQS;
    const float* cD = sDl + (it & 1) * kQS;

    // S^T = K Q^T, dW^T = V dO^T: 16 tokens x kQS q rows
    float st[NT][4], dwt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dwt[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t ak[4], av[4];
      ak[0] = ld32(sKw + g * S + k0 + tig * 2);
      ak[1] = ld32(sKw + (g + 8) * S + k0 + tig * 2);
      ak[2] = ld32(sKw + g * S + k0 + 8 + tig * 2);
      ak[3] = ld32(sKw + (g + 8) * S + k0 + 8 + tig * 2);
      av[0] = ld32(sVw + g * S + k0 + tig * 2);
      av[1] = ld32(sVw + (g + 8) * S + k0 + tig * 2);
      av[2] = ld32(sVw + g * S + k0 + 8 + tig * 2);
      av[3] = ld32(sVw + (g + 8) * S + k0 + 8 + tig * 2);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bq[2], bo[2];
        bq[0] = ld32(cQ + (j * 8 + g) * S + k0 + tig * 2);
        bq[1] = ld32(cQ + (j * 8 + g) * S + k0 + 8 + tig * 2);
        bo[0] = ld32(cDO + (j * 8 + g) * S + k0 + tig * 2);
        bo[1] = ld32(cDO + (j * 8 + g) * S + k0 + 8 + tig * 2);
        mma_bf16(st[j], ak, bq);
        mma_bf16(dwt[j], av, bo);
      }
    }

    // W^T and dS^T in place of S^T and dW^T (row = q col, col = token row)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ql = j * 8 + tig * 2 + c, row = r0 + ql;
        uint32_t h0 = 0, lrow = 0;
        if (drop.thresh && row < Q) {
          h0 = row_h0(drop, bh, row);
          lrow = row % drop.group_rows;
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int e = hi * 2 + c;
          const float p = exp2f(st[j][e] * qk - cL[ql]);
          const bool keep = !drop.thresh || (row < Q &&
              keep_bit(h0, lrow, tok0 + hi * 8, drop.thresh));
          const float w = keep ? p * ks : 0.f;
          dwt[j][e] = w * dwt[j][e] - p * cD[ql];
          st[j][e] = w;
        }
      }
    }
    uint32_t aw[NT / 2][4], ads[NT / 2][4];
    pack_a<NT>(st, aw);
    pack_a<NT>(dwt, ads);

    // dV += W^T dO, dK += dS^T Q over this warp's D/2 columns
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int n = 0; n < DH / 8; n += 2) {
        const int off = (kk * 16 + (mi & 1) * 8 + mr) * S + c0 + n * 8 +
                        (mi >> 1) * 8;
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, cDO + off);
        mma_bf16(dv[n], aw[kk], bo);
        mma_bf16(dv[n + 1], aw[kk], bo + 2);
        ldmatrix_x4_trans(bq, cQ + off);
        mma_bf16(dk[n], ads[kk], bq);
        mma_bf16(dk[n + 1], ads[kk], bq + 2);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  bf16* out = dkv + (long long)b * N * kv_row + (long long)h * 2 * D;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = c0 + n * 8 + tig * 2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const uint32_t tok = tok0 + hi * 8;
      if (tok >= (uint32_t)N) continue;
      bf16* row = out + (long long)tok * kv_row;
      *reinterpret_cast<uint32_t*>(row + col) =
          pack_bf16(dk[n][hi * 2] * sm_scale, dk[n][hi * 2 + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(row + D + col) =
          pack_bf16(dv[n][hi * 2], dv[n][hi * 2 + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, Dropout drop,
                       bf16* __restrict__ dq, int H, int Q, int N,
                       float sm_scale) {
  constexpr int S = row_stride<D>();
  constexpr int CH = D / 8;
  constexpr int NT = kBK / 8;
  extern __shared__ float4 smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kQT x S
  bf16* sDO = sQ + kQT * S;                       // kQT x S
  bf16* sK = sDO + kQT * S;                       // [2][kBK][S]
  bf16* sV = sK + 2 * kBK * S;                    // [2][kBK][S]

  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = b * H + h;
  const bf16* qbh = q + (long long)bh * Q * D;
  const bf16* dobh = dout + (long long)bh * Q * D;
  const long long kv_row = (long long)H * 2 * D;
  const bf16* kvb = kv + (long long)b * N * kv_row + (long long)h * 2 * D;

  for (int c = tid; c < kQT * CH; c += 128) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = q0 + r < Q;
    const long long off = (ok ? (long long)(q0 + r) * D : 0) + col;
    cp_async16(sQ + r * S + col, qbh + off, ok);
    cp_async16(sDO + r * S + col, dobh + off, ok);
  }
  auto load_kv = [&](int blk, int buf) {
    const int m0 = blk * kBK;
    bf16* dk_ = sK + buf * kBK * S;
    bf16* dv_ = sV + buf * kBK * S;
    for (int c = tid; c < kBK * CH; c += 128) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool ok = m0 + r < N;
      const bf16* row = kvb + (ok ? (long long)(m0 + r) * kv_row : 0);
      cp_async16(dk_ + r * S + col, row + col, ok);
      cp_async16(dv_ + r * S + col, row + D + col, ok);
    }
  };
  const int nblocks = (N + kBK - 1) / kBK;
  load_kv(0, 0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float rl[2], rd[2];
  uint32_t h0[2] = {0, 0}, lrow[2] = {0, 0};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + hi * 8;
    const bool ok = row < Q;
    rl[hi] = ok ? lse[(long long)bh * Q + row] * kLog2e : 1e30f;
    rd[hi] = ok ? delta[(long long)bh * Q + row] : 0.f;
    if (drop.thresh && ok) {
      h0[hi] = row_h0(drop, bh, row);
      lrow[hi] = row % drop.group_rows;
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bf16* sQw = sQ + warp * 16 * S;
  const bf16* sDOw = sDO + warp * 16 * S;
  const float qk = sm_scale * kLog2e;
  const float ks = drop.thresh ? drop.keep_scale : 1.f;
  const int mi = lane >> 3, mr = lane & 7;

  for (int blk = 0; blk < nblocks; ++blk) {
    if (blk + 1 < nblocks) {
      load_kv(blk + 1, (blk + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + (blk & 1) * kBK * S;
    const bf16* cV = sV + (blk & 1) * kBK * S;

    float s[NT][4], dw[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dw[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4], ao[4];
      a[0] = ld32(sQw + g * S + k0 + tig * 2);
      a[1] = ld32(sQw + (g + 8) * S + k0 + tig * 2);
      a[2] = ld32(sQw + g * S + k0 + 8 + tig * 2);
      a[3] = ld32(sQw + (g + 8) * S + k0 + 8 + tig * 2);
      ao[0] = ld32(sDOw + g * S + k0 + tig * 2);
      ao[1] = ld32(sDOw + (g + 8) * S + k0 + tig * 2);
      ao[2] = ld32(sDOw + g * S + k0 + 8 + tig * 2);
      ao[3] = ld32(sDOw + (g + 8) * S + k0 + 8 + tig * 2);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bk[2], bv[2];
        bk[0] = ld32(cK + (j * 8 + g) * S + k0 + tig * 2);
        bk[1] = ld32(cK + (j * 8 + g) * S + k0 + 8 + tig * 2);
        bv[0] = ld32(cV + (j * 8 + g) * S + k0 + tig * 2);
        bv[1] = ld32(cV + (j * 8 + g) * S + k0 + 8 + tig * 2);
        mma_bf16(s[j], a, bk);
        mma_bf16(dw[j], ao, bv);
      }
    }

    const int m0 = blk * kBK;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const uint32_t col = m0 + j * 8 + tig * 2 + (e & 1);
        const float p = col < (uint32_t)N ? exp2f(s[j][e] * qk - rl[hi])
                                          : 0.f;
        const bool keep = !drop.thresh ||
            keep_bit(h0[hi], lrow[hi], col, drop.thresh);
        const float w = keep ? p * ks : 0.f;
        dw[j][e] = w * dw[j][e] - p * rd[hi];
      }
    }
    uint32_t ads[NT / 2][4];
    pack_a<NT>(dw, ads);

    // dQ += dS K: K's B fragments through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk4[4];
        ldmatrix_x4_trans(
            bk4, cK + (kk * 16 + (mi & 1) * 8 + mr) * S + n * 8 + (mi >> 1) * 8);
        mma_bf16(acc[n], ads[kk], bk4);
        mma_bf16(acc[n + 1], ads[kk], bk4 + 2);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  bf16* dqbh = dq + (long long)bh * Q * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + hi * 8;
      if (row < Q)
        *reinterpret_cast<uint32_t*>(dqbh + (long long)row * D + col) =
            pack_bf16(acc[n][hi * 2] * sm_scale, acc[n][hi * 2 + 1] * sm_scale);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* kv, const void* dout,
                   const float* lse, const float* delta, Dropout drop,
                   void* dq, void* dkv, int B, int H, int Q, int N,
                   cudaStream_t stream) {
  const float sm_scale = 1.f / sqrtf(static_cast<float>(D));
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tkv = static_cast<const bf16*>(kv);
  const bf16* tdo = static_cast<const bf16*>(dout);
  flash_bwd_dkv_tc_kernel<D>
      <<<dim3((N + kKVT - 1) / kKVT, H, B), 256, smem, stream>>>(
          tq, tkv, tdo, lse, delta, drop, static_cast<bf16*>(dkv), H, Q, N,
          sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<D>
      <<<dim3((Q + kQT - 1) / kQT, H, B), 128, smem, stream>>>(
          tq, tkv, tdo, lse, delta, drop, static_cast<bf16*>(dq), H, Q, N,
          sm_scale);
  return cudaGetLastError();
}

}  // namespace tcb

template <int D>
cudaError_t dispatch_fwd(const void* q, const void* kv, void* o, float* lse,
                         Dropout drop, int B, int H, int Q, int N,
                         int is_bf16, cudaStream_t s) {
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  if (lse == nullptr)  // eval form
    return is_bf16
        ? tc::launch<D, false>(q, kv, o, lse, drop, B, H, Q, N, qscale, s)
        : simt::launch<D, false>(q, kv, o, lse, drop, B, H, Q, N, qscale, s);
  return is_bf16
      ? tc::launch<D, true>(q, kv, o, lse, drop, B, H, Q, N, qscale, s)
      : simt::launch<D, true>(q, kv, o, lse, drop, B, H, Q, N, qscale, s);
}

cudaError_t fwd(const void* q, const void* kv, void* o, float* lse,
                Dropout drop, int B, int H, int Q, int N, int D, int is_bf16,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return dispatch_fwd<64>(q, kv, o, lse, drop, B, H, Q, N, is_bf16, s);
    case 128: return dispatch_fwd<128>(q, kv, o, lse, drop, B, H, Q, N, is_bf16, s);
    case 256: return dispatch_fwd<256>(q, kv, o, lse, drop, B, H, Q, N, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t dispatch_bwd_d(const void* q, const void* kv, const void* dout,
                           const float* lse, const float* delta, Dropout drop,
                           void* dq, void* dkv, int B, int H, int Q, int N,
                           int is_bf16, cudaStream_t s) {
  return is_bf16
      ? tcb::launch<D>(q, kv, dout, lse, delta, drop, dq, dkv, B, H, Q, N, s)
      : bwd::launch<D>(q, kv, dout, lse, delta, drop, dq, dkv, B, H, Q, N,
                       s);
}

cudaError_t bwd_all(const void* q, const void* kv, const void* dout,
                    const float* lse, const float* delta, Dropout drop,
                    void* dq, void* dkv, int B, int H, int Q, int N, int D,
                    int is_bf16, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_bwd_d<64>(q, kv, dout, lse, delta, drop, dq, dkv, B, H, Q, N, is_bf16, s);
    case 128: return dispatch_bwd_d<128>(q, kv, dout, lse, delta, drop, dq, dkv, B, H, Q, N, is_bf16, s);
    case 256: return dispatch_bwd_d<256>(q, kv, dout, lse, delta, drop, dq, dkv, B, H, Q, N, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Q, D) and o (B, H, Q, D) contiguous, kv (B, N, H*2D) contiguous,
// all bf16 (is_bf16=1) or all f32; D in {64, 128, 256}; N >= 1; every
// pointer 16-byte aligned. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported D).
extern "C" int parq_flash_fwd_kv_fused(const void* q, const void* kv, void* o,
                                       int B, int H, int Q, int N, int D,
                                       int is_bf16, void* stream) {
  const Dropout none{nullptr, 1, 0u, 1.f};
  return static_cast<int>(
      fwd(q, kv, o, nullptr, none, B, H, Q, N, D, is_bf16, stream));
}

// The train form of B2: as parq_flash_fwd_kv_fused, and also lse (B, H, Q)
// f32 in natural-log units. seeds: (G,) int32 on the device with
// group_rows = Q / G; thresh = min(floor(rate * 2^32), 2^32 - 1) (0: no
// dropout) and keep_scale = 1 / (1 - rate), both computed by the caller
// from the double rate so the threshold matches the JAX package's exactly.
extern "C" int parq_flash_fwd_kv_fused_lse(
    const void* q, const void* kv, void* o, void* lse, const void* seeds,
    int B, int H, int Q, int N, int D, int group_rows, unsigned thresh,
    float keep_scale, int is_bf16, void* stream) {
  const Dropout drop{static_cast<const int*>(seeds), group_rows, thresh,
                     keep_scale};
  return static_cast<int>(fwd(q, kv, o, static_cast<float*>(lse), drop, B, H,
                              Q, N, D, is_bf16, stream));
}

// B3. q, dout, dq (B, H, Q, D) and kv, dkv (B, N, H*2D) contiguous, all
// bf16 (is_bf16=1) or all f32; lse and delta (B, H, Q) f32; seeds, thresh
// and keep_scale as for parq_flash_fwd_kv_fused_lse. dkv is written whole
// (every row, K and V lanes of every head), summed over all Q rows.
extern "C" int parq_flash_bwd_kv_fused(
    const void* q, const void* kv, const void* dout, const void* lse,
    const void* delta, const void* seeds, void* dq, void* dkv, int B, int H,
    int Q, int N, int D, int group_rows, unsigned thresh, float keep_scale,
    int is_bf16, void* stream) {
  const Dropout drop{static_cast<const int*>(seeds), group_rows, thresh,
                     keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return static_cast<int>(
      bwd_all(q, kv, dout, l, dl, drop, dq, dkv, B, H, Q, N, D, is_bf16, s));
}
