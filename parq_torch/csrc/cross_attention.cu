// Kernel B2: flash cross-attention forward over the fused K/V buffer, for
// Hopper (sm_90a).
//
// Replaces parq_tpu/kernels/cross_attention_pallas.py:_fwd_call (:457),
// body _fwd_kernel (:120), in its eval form as reached through
// flash_cross_attention_kv_fused (:736): no dropout, no LSE output, the
// head-interleaved (B, N, H*2D) layout where lanes [h*2D, h*2D+D) hold K_h
// and [h*2D+D, (h+1)*2D) hold V_h. The buffer is read in place at offset
// h*2D; it is never sliced in memory.
//
//   o[b,h,q,:] = softmax_n(q[b,h,q,:] . K_h[b,n,:] / sqrt(D)) @ V_h[b,:,:]
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kv,
                      __nv_bfloat16* __restrict__ o, int H, int Q, int N,
                      float qscale) {
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
      const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
      const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
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
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
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

template <int D>
cudaError_t launch(const void* q, const void* kv, void* o, int B, int H,
                   int Q, int N, float qscale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kQT - 1) / kQT, H, B);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv), static_cast<__nv_bfloat16*>(o),
      H, Q, N, qscale);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                     float* __restrict__ o, int H, int Q, int N,
                     float qscale) {
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
      const float p = exp2f(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
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
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // guarded final 1/l
#pragma unroll
    for (int k = 0; k < D / 32; ++k)
      obh[(long long)row * D + lane + 32 * k] = acc[r][k] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* kv, void* o, int B, int H,
                   int Q, int N, float qscale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kQT - 1) / kQT, H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kv),
      static_cast<float*>(o), H, Q, N, qscale);
  return cudaGetLastError();
}

}  // namespace simt

template <int D>
cudaError_t dispatch_d(const void* q, const void* kv, void* o, int B, int H,
                       int Q, int N, int is_bf16, cudaStream_t s) {
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  return is_bf16 ? tc::launch<D>(q, kv, o, B, H, Q, N, qscale, s)
                 : simt::launch<D>(q, kv, o, B, H, Q, N, qscale, s);
}

}  // namespace

// q (B, H, Q, D) and o (B, H, Q, D) contiguous, kv (B, N, H*2D) contiguous,
// all bf16 (is_bf16=1) or all f32; D in {64, 128, 256}; N >= 1; every
// pointer 16-byte aligned. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported D).
extern "C" int parq_flash_fwd_kv_fused(const void* q, const void* kv, void* o,
                                       int B, int H, int Q, int N, int D,
                                       int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = dispatch_d<64>(q, kv, o, B, H, Q, N, is_bf16, s); break;
    case 128: err = dispatch_d<128>(q, kv, o, B, H, Q, N, is_bf16, s); break;
    case 256: err = dispatch_d<256>(q, kv, o, B, H, Q, N, is_bf16, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
