// Kernel B2 for Hopper: the flash cross-attention forward, bf16, D = 256,
// eval and train forms, on K and V in any of the JAX package's layouts
// (the fused (B, N, H*2D) buffer, the natural (B, N, H*D) pair, the legacy
// (B, H, N, D) pair): each of K and V comes through a tensor map of its own
// (flash_common.cuh: KV, kv_map), so one kernel body serves them all.
//
// Replaces parq_tpu/kernels/cross_attention_pallas.py:_fwd_call (:457), body
// _fwd_kernel (:120); cross_attention.cu's head comment states what it
// computes (online-max softmax in base 2, guarded 1/l, natural-log LSE, the
// v1 dropout hash on group-local rows and global kv columns).
//
// What bounds it on this card: at the release shape (B=8, H=4, Q=256,
// N=14400) 121 GFLOP against one 472 MB read of K/V: 0.12 ms of tensor-core
// time, 0.14 ms of memory time. A kernel that feeds mma.sync from 32-bit
// shared-memory loads is bound by neither but by shared-memory bandwidth
// and the register file. What this design does about it:
//   - wgmma.mma_async: S = Q K^T as m64n64k16 with both operands read from
//     128-byte-swizzled shared memory by the tensor cores themselves, and
//     O += P V as m64n256k16 with P from registers (the S accumulator,
//     rounded to bf16, is the A fragment) and V read MN-major from the very
//     tile the TMA wrote: no ldmatrix, no second copy of V.
//   - TMA: one producer thread keeps a ring of 2 stages (K and V of 64
//     tokens, 64 KB a stage) in flight; K and V are 3-D tensor maps whose
//     row dimension ends at N, so the ragged last block reads zeros past N
//     (and past n_valid in a padded legacy buffer) and never the next
//     sample's rows. Scores past N are still masked.
//   - One CTA per (b, h, 128 q rows): two consumer warpgroups of 64 rows
//     each (O: 128 f32 registers a thread) share each K/V stage, so one
//     runs its softmax while the other holds the tensor cores. The producer
//     warpgroup gives its registers to them (setmaxnreg 24 / 240); each role
//     ends in its own exit (hopper.cuh: role_exit) or ptxas keeps the
//     168-register launch limit for the consumers and spills O.
//   - Filling the card: at Q = 256 there are only 64 such CTAs for 132 SMs.
//     The KV range is split over `splits` CTAs per q tile, each writing a
//     normalised f32 partial and its logsumexp; flash_combine_kernel merges
//     them by w_i = exp2(lse_i - max lse), the arithmetic of the JAX
//     package's sequence-parallel merge (parallel/seq_parallel.py:78-91).
//     The dropout hash keys on the global kv column, so a split draws the
//     same bits. The caller picks `splits` from the rows of one seed group,
//     never from Q, so a folded call of G groups sums in the same order as G
//     separate calls and equals them bit for bit.
// Loader shipped: TMA (cp.async.bulk.tensor) with mbarriers.

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace parq {
namespace sm90 {
namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace fwd {
constexpr int kBM = kConsumers * 64;   // q rows per CTA
constexpr int kBN = 64;                // tokens per stage
constexpr int kStages = 2;
constexpr int kQBox = kBM * kRowBytes;       // 16 KB
constexpr int kKVBox = kBN * kRowBytes;      // 8 KB
constexpr int kQBytes = kBoxes * kQBox;      // 64 KB
constexpr int kTileBytes = kBoxes * kKVBox;  // 32 KB: K or V of one stage
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kBarOffset = kQBytes + kStages * kStageBytes;  // 192 KB
constexpr int kSmemBytes = kBarOffset + 64 + 1024;  // + barriers + alignment
}  // namespace fwd

template <bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      TmaCoord at_k, TmaCoord at_v,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ part_o,
                      float* __restrict__ part_lse, Dropout drop, int H,
                      int Q, int N, int splits, int blocks_per_split,
                      float qscale) {
  using namespace fwd;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + kQBytes;  // [stage][K | V]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;             // [kStages]
  uint64_t* empty = bars + 1 + kStages;  // [kStages]

  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int q0 = tile * kBM;
  const int nblocks = (N + kBN - 1) / kBN;
  const int blk0 = split * blocks_per_split;
  const int nit = min(nblocks, blk0 + blocks_per_split) - blk0;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers * 4);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // ---------------------------------- producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x % kWarpgroup == 0) {
      mbar_arrive_expect_tx(q_bar, kQBytes);
      tma_load_tile<kBoxes>(sQ, kQBox, &map_q, q_bar, 0, q0, bh);
      for (int it = 0; it < nit; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, kStageBytes);
        uint8_t* dst = sKV + s * kStageBytes;
        const int n0 = (blk0 + it) * kBN;
        tma_load_tile<kBoxes>(dst, kKVBox, &map_k, full + s, h * at_k.hc,
                              n0, b * at_k.zb + h * at_k.zh);
        tma_load_tile<kBoxes>(dst + kTileBytes, kKVBox, &map_v, full + s,
                              h * at_v.hc, n0, b * at_v.zb + h * at_v.zh);
      }
    }
    role_exit();
  } else {  // ------------------------------------------------ consumers
    reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % kWarpgroup, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
    uint32_t h00 = 0, h01 = 0, lr0 = 0, lr1 = 0;  // dropout: h0, local rows
    if (kTrain && drop.thresh) {
      const int r0 = min(row0, Q - 1), r1 = min(row1, Q - 1);
      const int dbh = drop_bh(drop, b, H, h);
      h00 = row_h0(drop, dbh, r0);
      h01 = row_h0(drop, dbh, r1);
      lr0 = r0 % drop.group_rows;
      lr1 = r1 % drop.group_rows;
    }
    float acc[kD / 2];  // O: this thread's part of 64 rows x 256
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m0 = kMaskValue, m1 = kMaskValue;  // rows g and g + 8
    float l0 = 0.f, l1 = 0.f;                // this thread's partial sums
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * kRowBytes;

    mbar_wait(q_bar, 0);
    for (int it = 0; it < nit; ++it) {
      const int s = it % kStages;
      const uint32_t k_addr = smem_u32(sKV + s * kStageBytes);
      const uint32_t v_addr = k_addr + kTileBytes;
      mbar_wait(full + s, (it / kStages) & 1);

      // S = Q K^T: 64 rows x 64 tokens, k = D in 16 steps
      float sc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k0 = 0; k0 < kD / 16; ++k0)
        wgmma_ss_n64(sc, desc_k(q_addr + (k0 / 4) * kQBox + (k0 % 4) * 32),
                     desc_k(k_addr + (k0 / 4) * kKVBox + (k0 % 4) * 32),
                     k0 != 0);
      wgmma_commit();

      // the keep bits depend on (row, col) alone: draw them while the
      // tensor cores work (bit 4 j + e for sc[4 j + e])
      const int n0 = (blk0 + it) * kBN;
      uint32_t keep = 0xffffffffu;
      if (kTrain && drop.thresh) {
        auto draw = [&](auto v2) {
          uint32_t bits = 0u;
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const uint32_t col = n0 + (i / 4) * 8 + tig * 2 + (i & 1);
            const bool k =
                (i & 2) ? keep_bit<decltype(v2)::value>(h01, lr1, col,
                                                        drop.thresh)
                        : keep_bit<decltype(v2)::value>(h00, lr0, col,
                                                        drop.thresh);
            bits |= static_cast<uint32_t>(k) << i;
          }
          return bits;
        };
        keep = drop.v2 ? draw(std::true_type{}) : draw(std::false_type{});
      }
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in base 2; a quad (same g) shares each row
      float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + j * 8 + tig * 2 + (e & 1);
          sc[4 * j + e] = col < N ? sc[4 * j + e] * qscale : kMaskValue;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
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
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float p0 = exp2f(sc[4 * j] - mn0), p1 = exp2f(sc[4 * j + 1] - mn0);
        float p2 = exp2f(sc[4 * j + 2] - mn1);
        float p3 = exp2f(sc[4 * j + 3] - mn1);
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        if (kTrain && drop.thresh) {  // after l: l sums the undropped p
          const float ks = drop.keep_scale;
          p0 = (keep >> (4 * j)) & 1u ? p0 * ks : 0.f;
          p1 = (keep >> (4 * j + 1)) & 1u ? p1 * ks : 0.f;
          p2 = (keep >> (4 * j + 2)) & 1u ? p2 * ks : 0.f;
          p3 = (keep >> (4 * j + 3)) & 1u ? p3 * ks : 0.f;
        }
        sc[4 * j] = p0;
        sc[4 * j + 1] = p1;
        sc[4 * j + 2] = p2;
        sc[4 * j + 3] = p3;
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        acc[4 * n] *= al0;
        acc[4 * n + 1] *= al0;
        acc[4 * n + 2] *= al1;
        acc[4 * n + 3] *= al1;
      }

      // O += P V: P from registers, V MN-major, k = 64 tokens in 4 steps
      uint32_t p[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) acc_to_a(sc, kk, p[kk]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs_n256_bt(acc, p[kk], desc_mn(v_addr + kk * 16 * kRowBytes,
                                             kKVBox), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // this warp is done with it
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // guarded final 1/l
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    if (splits == 1) {
      if (kTrain && tig == 0) {  // natural-log units: m2 ln 2 + ln l
        float* lbh = lse + (long long)bh * Q;
        if (row0 < Q) lbh[row0] = m0 * kLn2 + logf(fmaxf(l0, 1e-37f));
        if (row1 < Q) lbh[row1] = m1 * kLn2 + logf(fmaxf(l1, 1e-37f));
      }
      bf16* obh = o + (long long)bh * Q * kD;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + tig * 2;
        if (row0 < Q)
          *reinterpret_cast<uint32_t*>(obh + (long long)row0 * kD + col) =
              pack_bf16x2(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
        if (row1 < Q)
          *reinterpret_cast<uint32_t*>(obh + (long long)row1 * kD + col) =
              pack_bf16x2(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
      }
    } else {  // the split's normalised partial and its base-2 logsumexp
      const long long rows = (long long)gridDim.z * H * Q;
      const long long base = split * rows + (long long)bh * Q;
      if (tig == 0) {
        if (row0 < Q) part_lse[base + row0] = m0 + log2f(fmaxf(l0, 1e-37f));
        if (row1 < Q) part_lse[base + row1] = m1 + log2f(fmaxf(l1, 1e-37f));
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + tig * 2;
        if (row0 < Q)
          *reinterpret_cast<float2*>(part_o + (base + row0) * kD + col) =
              make_float2(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
        if (row1 < Q)
          *reinterpret_cast<float2*>(part_o + (base + row1) * kD + col) =
              make_float2(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
      }
    }
    role_exit();
  }
}

// Merges the splits' partials of each row: w_i = exp2(lse_i - max lse),
// o = sum w_i o_i / sum w_i, lse = (max + log2 sum w_i) ln 2. One CTA of 256
// threads per 4 rows; a thread owns 4 columns. kMax bounds `splits` and
// sizes the per-row array: 4 for up to 4 splits (the release shapes take 2;
// an array of 16 made the release B2 1.5% slower on an H100, 0.2232-0.2239
// ms against 0.2199-0.2213), kMaxSplits above 4.
template <int kMax>
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_lse, bf16* __restrict__ o,
                     float* __restrict__ lse, long long rows, int splits) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 64;
  if (row >= rows) return;
  const int col = (threadIdx.x % 64) * 4;
  float ls[kMax], mx = kMaskValue;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    ls[i] = i < splits ? part_lse[i * rows + row] : kMaskValue;
    mx = fmaxf(mx, ls[i]);
  }
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    if (i >= splits) break;
    const float w = exp2f(ls[i] - mx);
    const float4 v = *reinterpret_cast<const float4*>(
        part_o + (i * rows + row) * kD + col);
    den += w;
    num.x += w * v.x;
    num.y += w * v.y;
    num.z += w * v.z;
    num.w += w * v.w;
  }
  const float inv = 1.f / den;  // den >= 1: the largest split has w = 1
  uint2 out;
  out.x = pack_bf16x2(num.x * inv, num.y * inv);
  out.y = pack_bf16x2(num.z * inv, num.w * inv);
  *reinterpret_cast<uint2*>(o + row * kD + col) = out;
  if (lse != nullptr && col == 0) lse[row] = (mx + log2f(den)) * kLn2;
}

template <bool kTrain>
cudaError_t launch_fwd(const CUtensorMap& map_q, const CUtensorMap& map_k,
                       const CUtensorMap& map_v, TmaCoord at_k,
                       TmaCoord at_v, void* o, float* lse, float* part_o,
                       float* part_lse, int splits, int bps, Dropout drop,
                       int B, int H, int Q, int N, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<kTrain>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::kSmemBytes);
  if (err != cudaSuccess) return err;
  const float qscale = kLog2e / sqrtf(static_cast<float>(kD));
  const dim3 grid((Q + fwd::kBM - 1) / fwd::kBM * splits, H, B);
  flash_fwd_sm90_kernel<kTrain><<<grid, kThreads, fwd::kSmemBytes, stream>>>(
      map_q, map_k, map_v, at_k, at_v, static_cast<bf16*>(o), lse, part_o,
      part_lse, drop, H, Q, N, splits, bps, qscale);
  return cudaGetLastError();
}

// ---------------------------------------------------------- selftest --
__global__ void __launch_bounds__(kWarpgroup)
wgmma_selftest_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_v,
                      float* __restrict__ c1, float* __restrict__ c2) {
  constexpr int kBox = 64 * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sA = smem;
  uint8_t* sB = smem + kBox;
  uint8_t* sV = smem + 2 * kBox;  // 4 boxes
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 6 * kBox);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 6 * kBox);
    tma_load_3d(sA, &map_a, bar, 0, 0, 0);
    tma_load_3d(sB, &map_b, bar, 0, 0, 0);
    tma_load_tile<kBoxes>(sV, kBox, &map_v, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  float s[32], acc[kD / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int k0 = 0; k0 < 4; ++k0)
    wgmma_ss_n64(s, desc_k(smem_u32(sA) + k0 * 32),
                 desc_k(smem_u32(sB) + k0 * 32), k0 != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, p[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n256_bt(acc, p[kk],
                     desc_mn(smem_u32(sV) + kk * 16 * kRowBytes, kBox), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int row = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    c1[(row + 8 * ((i >> 1) & 1)) * 64 + (i / 4) * 8 + tig * 2 + (i & 1)] =
        s[i];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i)
    c2[(row + 8 * ((i >> 1) & 1)) * kD + (i / 4) * 8 + tig * 2 + (i & 1)] =
        acc[i];
}

}  // namespace

cudaError_t make_kv_map(void* map, TmaCoord* at, const KV& t, int B, int H,
                        int N, uint32_t box_rows) {
  KVMap m;
  if (!kv_map(t, B, H, N, kD, &m)) return cudaErrorInvalidValue;
  *at = m.at;
  return make_map(static_cast<CUtensorMap*>(map), t.ptr, m.cols, m.rows, m.z,
                  m.row_stride, m.z_stride, box_rows);
}

cudaError_t flash_fwd(const void* q, const KV& k, const KV& v, void* o,
                      float* lse, float* part_o, float* part_lse, int splits,
                      Dropout drop, int B, int H, int Q, int N,
                      cudaStream_t stream) {
  const int nblocks = (N + fwd::kBN - 1) / fwd::kBN;
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const int bps = (nblocks + splits - 1) / splits;
  if ((splits - 1) * bps >= nblocks) return cudaErrorInvalidValue;
  if (splits > 1 && (part_o == nullptr || part_lse == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  TmaCoord at_k, at_v;
  cudaError_t err = make_map(&map_q, q, kD, Q, (uint64_t)B * H, kD,
                             (uint64_t)Q * kD, fwd::kBM);
  if (err != cudaSuccess) return err;
  err = make_kv_map(&map_k, &at_k, k, B, H, N, fwd::kBN);
  if (err != cudaSuccess) return err;
  err = make_kv_map(&map_v, &at_v, v, B, H, N, fwd::kBN);
  if (err != cudaSuccess) return err;
  err = lse == nullptr
      ? launch_fwd<false>(map_q, map_k, map_v, at_k, at_v, o, lse, part_o,
                          part_lse, splits, bps, drop, B, H, Q, N, stream)
      : launch_fwd<true>(map_q, map_k, map_v, at_k, at_v, o, lse, part_o,
                         part_lse, splits, bps, drop, B, H, Q, N, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = (long long)B * H * Q;
  const unsigned ctas = (unsigned)((rows + 3) / 4);
  if (splits <= 4)
    flash_combine_kernel<4><<<ctas, 256, 0, stream>>>(
        part_o, part_lse, static_cast<bf16*>(o), lse, rows, splits);
  else
    flash_combine_kernel<kMaxSplits><<<ctas, 256, 0, stream>>>(
        part_o, part_lse, static_cast<bf16*>(o), lse, rows, splits);
  return cudaGetLastError();
}

cudaError_t wgmma_selftest(const void* a, const void* b, const void* v,
                           float* c1, float* c2, cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_v;
  cudaError_t err = make_map(&map_a, a, 64, 64, 1, 64, 64 * 64, 64);
  if (err != cudaSuccess) return err;
  err = make_map(&map_b, b, 64, 64, 1, 64, 64 * 64, 64);
  if (err != cudaSuccess) return err;
  err = make_map(&map_v, v, kD, 64, 1, kD, 64 * kD, 64);
  if (err != cudaSuccess) return err;
  constexpr int smem = 6 * 64 * kRowBytes + 64 + 1024;
  err = cudaFuncSetAttribute(wgmma_selftest_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  wgmma_selftest_kernel<<<1, kWarpgroup, smem, stream>>>(map_a, map_b, map_v,
                                                         c1, c2);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace parq
