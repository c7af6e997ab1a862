// Kernel B3 for Hopper: the flash cross-attention backward, bf16, D = 256,
// on K and V in any of the JAX package's layouts: K and V are read through
// tensor maps of their own and dK and dV written through their own views
// (flash_common.cuh: KV), so the fused form's dK|dV land in one dKV buffer
// and the split forms' in two.
//
// Replaces parq_tpu/kernels/cross_attention_pallas.py:_bwd_call (:547), body
// _bwd_kernel (:252), every KV form; cross_attention.cu's B3 comment states
// what it computes (p from the saved lse, w = keep p / (1 - rate),
// ds = w dw - p delta, ds and w rounded to bf16 before the last products).
//
// What bounds it on this card: operations. 10 B H Q N D = 2.42 TFLOP at the
// release fold (B=8, H=4, Q=2048, N=14400) against ~1 GB of bytes; with the
// two passes below the work is 7 products, 3.4 TFLOP. What the design does
// about it:
//   - Two passes and no atomics: the TPU kernel's dK/dV and dq accumulators
//     live across its sequential grid; here a dkv pass owns a KV block per
//     CTA and a dq pass owns a q tile per CTA. One pass with dq in f32
//     atomics would add a 2 MB partial per KV-block CTA (7 GB of atomic
//     traffic) to save 1 TFLOP of recompute.
//   - Every product is a wgmma.mma_async on 128-byte-swizzled tiles that a
//     TMA producer thread streams through an mbarrier ring; the K, V, Q and
//     dO tiles are stored once as [row][d] and read K-major (S^T = K Q^T,
//     dP^T = V dO^T, S = Q K^T, dP = dO V^T) or MN-major (dV += W^T dO,
//     dK += dS^T Q, dQ += dS K) in place.
//   - dkv pass: one CTA per (b, h, 64 tokens); K and V stay in shared
//     memory, 64-row q/dO tiles stream through a 2-stage ring. dK and dV are
//     128 f32 registers a thread each, so two consumer warpgroups split the
//     work on the same 64 tokens: warpgroup 0 computes S^T, forms p and the
//     keep bits, owns dV += W^T dO; warpgroup 1 computes dP^T, owns
//     dK += dS^T Q. p crosses once through shared memory in f32, thread for
//     thread in fragment order, with the keep bit in its sign (p >= 0), so
//     S^T and the hash are computed once (4 products, not 6).
//   - dq pass: one CTA per (b, h, 128 q rows, KV range), two consumer
//     warpgroups of 64 rows; Q and dO stay in shared memory (128 KB), K and
//     V tiles of 64 tokens alternate (V first: its slot frees earlier)
//     through a ring of three 32 KB slots, so the next block loads during
//     this one; dS stays in registers as the A operand of dQ += dS K
//     (m64n256k16).
//   - The dq pass at B=1: at Q=256 there are only B H Q/128 = 8 such CTAs
//     for 132 SMs, each walking all N/64 blocks (450 at N=28800), so one
//     SM's work sets the time. The caller cuts the KV range into
//     `dq_splits` runs of whole 64-token blocks (the forward's
//     split_bounds), one CTA each; a CTA of a split call writes its dQ sum
//     in f32 into dq_part (splits, B, H, Q, D) and flash_bwd_dq_combine
//     adds the partials in split order, scales by 1/sqrt(D) and rounds once.
//     No atomics: two launches on the same inputs are equal bit for bit.
//     At the release fold (512 dq CTAs) the rule gives one split and the
//     pass writes dq itself, as before.
//   - The producer warpgroup hands its registers to the consumers
//     (setmaxnreg 24 / 240).
// Rows past Q read as zeros (3-D tensor maps), get lse = 1e30 (p = 0) and
// delta = 0; tokens past N read as zeros and are masked (dq pass) or never
// stored (dkv pass). Loader shipped: TMA (cp.async.bulk.tensor).

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

constexpr int kBox64 = 64 * kRowBytes;        // a 64-row box: 8 KB
constexpr int kTile64 = kBoxes * kBox64;      // 64 rows x 256: 32 KB

// d (64 x 64) = A (64 rows x 256, K-major) * B (64 rows x 256, K-major)^T;
// the tiles' 64-column boxes are a_box and b_box bytes apart
__device__ __forceinline__ void product_kk(float (&d)[32], uint32_t a_addr,
                                           int a_box, uint32_t b_addr,
                                           int b_box) {
#pragma unroll
  for (int k0 = 0; k0 < kD / 16; ++k0)
    wgmma_ss_n64(d, desc_k(a_addr + (k0 / 4) * a_box + (k0 % 4) * 32),
                 desc_k(b_addr + (k0 / 4) * b_box + (k0 % 4) * 32), k0 != 0);
}

// d (64 x 256) += bf16(c) (64 x 64, registers) * B (64 rows x 256, MN-major)
__device__ __forceinline__ void product_rs(float (&d)[kD / 2],
                                           const float (&c)[32],
                                           uint32_t b_addr, int b_box) {
  constexpr int kSteps = 4;  // 64 / 16
  uint32_t a[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) acc_to_a(c, kk, a[kk]);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_rs_n256_bt(d, a[kk], desc_mn(b_addr + kk * 16 * kRowBytes, b_box),
                     1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// seed hash and group-local row of q rows `row` and `row + 1` (row even);
// bh is the hash's global (b*H + h)
struct RowPair {
  uint32_t h0[2], local[2];
};

__device__ __forceinline__ RowPair row_pair(const Dropout& drop, int bh,
                                            int row, int Q) {
  RowPair r;
  const int ra = min(row, Q - 1), rb = min(row + 1, Q - 1);
  const int ga = ra / drop.group_rows;
  r.local[0] = ra - ga * drop.group_rows;
  r.h0[0] = row_h0(drop, bh, ra);
  if (rb == ra || r.local[0] + 1 == (uint32_t)drop.group_rows) {
    r.local[1] = rb - (rb / drop.group_rows) * drop.group_rows;
    r.h0[1] = row_h0(drop, bh, rb);
  } else {
    r.local[1] = r.local[0] + 1;
    r.h0[1] = r.h0[0];
  }
  return r;
}

// ------------------------------------------------------------ dkv pass --
namespace dkv_pass {
constexpr int kBN = 64;        // tokens per CTA
constexpr int kBM = 64;        // q rows per stage
constexpr int kStages = 2;     // q/dO ring (48-row tiles in 3 stages: slower)
constexpr int kPBufs = 2;      // p exchange buffers
constexpr int kRegs = kBM / 2; // S^T or dP^T registers of a thread
constexpr int kQBox = kBM * kRowBytes;
constexpr int kQTile = kBoxes * kQBox;                    // Q or dO of a stage
constexpr int kStageBytes = 2 * kQTile;                   // Q | dO
constexpr int kPBytes = 64 * kBM * 4;                     // p, f32
constexpr int kPOffset = 2 * kTile64 + kStages * kStageBytes;
constexpr int kBarOffset = kPOffset + kPBufs * kPBytes;
constexpr int kSmemBytes = kBarOffset + 64 + 1024;
constexpr int kPFull = 1, kPEmpty = 1 + kPBufs;  // named barrier ids
static_assert(kSmemBytes <= 232448, "dkv pass: shared memory");
}  // namespace dkv_pass

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          TmaCoord at_k, TmaCoord at_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, Dropout drop,
                          KV dk, KV dv, int H, int Q, int N,
                          float sm_scale) {
  using namespace dkv_pass;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + kTile64;
  uint8_t* sQ = smem + 2 * kTile64;  // [stage][Q | dO]
  float* sP = reinterpret_cast<float*>(smem + kPOffset);  // [kPBufs][..][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int n0 = blockIdx.x * kBN, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, dbh = drop_bh(drop, b, H, h);
  const int nsteps = (Q + kBM - 1) / kBM;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers * 4);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // ---------------------------------- producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * kWarpgroup) {
      mbar_arrive_expect_tx(kv_bar, 2 * kTile64);
      tma_load_tile<kBoxes>(sK, kBox64, &map_k, kv_bar, h * at_k.hc, n0,
                            b * at_k.zb + h * at_k.zh);
      tma_load_tile<kBoxes>(sV, kBox64, &map_v, kv_bar, h * at_v.hc, n0,
                            b * at_v.zb + h * at_v.zh);
      int s = 0;
      uint32_t phase = 1;
      for (int it = 0; it < nsteps; ++it) {
        mbar_wait(empty + s, phase);
        mbar_arrive_expect_tx(full + s, kStageBytes);
        uint8_t* dst = sQ + s * kStageBytes;
        tma_load_tile<kBoxes>(dst, kQBox, &map_q, full + s, 0, it * kBM, bh);
        tma_load_tile<kBoxes>(dst + kQTile, kQBox, &map_do, full + s, 0,
                              it * kBM, bh);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    role_exit();
  } else {  // ------------------------------------------------ consumers
    reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % kWarpgroup, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int tok0 = n0 + warp * 16 + g;  // fragment rows: tok0, tok0 + 8
    const float ks = drop.thresh ? drop.keep_scale : 1.f;
    float acc[kD / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    const float* rowstat = (wg == 0 ? lse : delta) + (long long)bh * Q;
    // the tile of the (token, q row) matrix: rows are tokens, columns q rows
    const uint32_t a_addr = smem_u32(wg == 0 ? sK : sV);
    int s = 0, pb = 0;
    uint32_t phase = 0;

    mbar_wait(kv_bar, 0);
    for (int it = 0; it < nsteps; ++it) {
      const int r0 = it * kBM;
      // this thread's columns 8 j + 2 tig + {0, 1}: lse log2 e, or delta
      float st[kRegs / 2];
#pragma unroll
      for (int j = 0; j < kRegs / 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = r0 + 8 * j + 2 * tig + c;
          const float x = row < Q ? rowstat[row] : 0.f;
          st[2 * j + c] = wg == 0 ? (row < Q ? x * kLog2e : 1e30f) : x;
        }
      }
      const uint32_t q_addr = smem_u32(sQ + s * kStageBytes);
      const uint32_t do_addr = q_addr + kQTile;
      mbar_wait(full + s, phase);

      float c[kRegs];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
#pragma unroll
      for (int i = 0; i < kRegs; ++i) c[i] = 0.f;
      wgmma_fence();
      product_kk(c, a_addr, kBox64, wg == 0 ? q_addr : do_addr, kQBox);
      wgmma_commit();
      // the keep bits depend on (row, col) alone: warpgroup 0 draws them
      // while the tensor cores work (bit 4 j + e for c[4 j + e])
      uint32_t keep = 0xffffffffu;
      if (wg == 0 && drop.thresh) {
        auto draw = [&](auto v2) {
          uint32_t bits = 0u;
#pragma unroll
          for (int j = 0; j < kRegs / 4; ++j) {
            const RowPair rp = row_pair(drop, dbh, r0 + 8 * j + 2 * tig, Q);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool k = keep_bit<decltype(v2)::value>(
                  rp.h0[e & 1], rp.local[e & 1], tok0 + 8 * (e >> 1),
                  drop.thresh);
              bits |= static_cast<uint32_t>(k) << (4 * j + e);
            }
          }
          return bits;
        };
        keep = drop.v2 ? draw(std::true_type{}) : draw(std::false_type{});
      }
      wgmma_wait<0>();
      fence_regs(c);

      float4* pbuf = reinterpret_cast<float4*>(sP + pb * (kPBytes / 4));
      if (wg == 0) {
        // p = exp2(s - lse), w = keep ? p ks : 0; p goes to warpgroup 1
        // with the keep bit as its sign
        const float qk = sm_scale * kLog2e;
#pragma unroll
        for (int i = 0; i < kRegs; ++i) {
          const float p = exp2f(c[i] * qk - st[2 * (i / 4) + (i & 1)]);
          c[i] = (keep >> i) & 1u ? p : -p;
        }
        if (it >= kPBufs) named_sync(kPEmpty + pb, 2 * kWarpgroup);
#pragma unroll
        for (int i = 0; i < kRegs / 4; ++i)
          pbuf[i * kWarpgroup + t] = make_float4(c[4 * i], c[4 * i + 1],
                                                 c[4 * i + 2], c[4 * i + 3]);
        named_arrive(kPFull + pb, 2 * kWarpgroup);
#pragma unroll
        for (int i = 0; i < kRegs; ++i) c[i] = c[i] > 0.f ? c[i] * ks : 0.f;
        product_rs(acc, c, do_addr, kQBox);  // dV += W^T dO
      } else {
        named_sync(kPFull + pb, 2 * kWarpgroup);
        float4 pv[kRegs / 4];
#pragma unroll
        for (int i = 0; i < kRegs / 4; ++i) pv[i] = pbuf[i * kWarpgroup + t];
        if (it + kPBufs < nsteps) named_arrive(kPEmpty + pb, 2 * kWarpgroup);
#pragma unroll
        for (int i = 0; i < kRegs / 4; ++i) {
          const float x[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = fabsf(x[e]);
            const float w = x[e] > 0.f ? p * ks : 0.f;
            c[4 * i + e] = w * c[4 * i + e] - p * st[2 * i + (e & 1)];
          }
        }
        product_rs(acc, c, q_addr, kQBox);  // dK += dS^T Q
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
      if (++pb == kPBufs) pb = 0;
    }

    const KV& d_out = wg == 0 ? dv : dk;
    bf16* out = kv_at<bf16>(d_out, b, h);
    const long long out_row = d_out.row;
    const float scale = wg == 0 ? 1.f : sm_scale;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + tig * 2;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int tok = tok0 + hi * 8;
        if (tok < N)
          *reinterpret_cast<uint32_t*>(out + tok * out_row + col) =
              pack_bf16x2(acc[4 * n + 2 * hi] * scale,
                          acc[4 * n + 2 * hi + 1] * scale);
      }
    }
    role_exit();
  }
}

// ------------------------------------------------------------- dq pass --
namespace dq_pass {
constexpr int kBM = kConsumers * 64;  // q rows per CTA
constexpr int kBN = 64;               // tokens per K or V slot
constexpr int kSlots = 3;
constexpr int kQBox = kBM * kRowBytes;      // 16 KB
constexpr int kQBytes = kBoxes * kQBox;     // 64 KB
constexpr int kBarOffset = 2 * kQBytes + kSlots * kTile64;  // 224 KB
constexpr int kSmemBytes = kBarOffset + 64 + 1024;
}  // namespace dq_pass

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         TmaCoord at_k, TmaCoord at_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, Dropout drop,
                         bf16* __restrict__ dq_out,
                         float* __restrict__ dq_part, int H, int Q, int N,
                         int splits, int blocks_per_split, float sm_scale) {
  using namespace dq_pass;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sDO = smem + kQBytes;
  uint8_t* sKV = smem + 2 * kQBytes;  // [slot]: V0 K0 V1 K1 ... in turn
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kSlots;

  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int q0 = tile * kBM, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int nblocks = (N + kBN - 1) / kBN;
  const int blk0 = split * blocks_per_split;
  const int nit = min(nblocks, blk0 + blocks_per_split) - blk0;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers * 4);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // ---------------------------------- producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * kWarpgroup) {
      mbar_arrive_expect_tx(q_bar, 2 * kQBytes);
      tma_load_tile<kBoxes>(sQ, kQBox, &map_q, q_bar, 0, q0, bh);
      tma_load_tile<kBoxes>(sDO, kQBox, &map_do, q_bar, 0, q0, bh);
      int slot = 0;
      uint32_t phase = 1;
      // V before K: V's slot is free again mid-block (after dP), K's only
      // after dQ += dS K, so both tiles of the next block load during this
      for (int j = 0; j < 2 * nit; ++j) {  // even: V, odd: K
        mbar_wait(empty + slot, phase);
        mbar_arrive_expect_tx(full + slot, kTile64);
        const bool is_k = j & 1;
        const TmaCoord& at = is_k ? at_k : at_v;
        tma_load_tile<kBoxes>(sKV + slot * kTile64, kBox64,
                              is_k ? &map_k : &map_v, full + slot,
                              h * at.hc, (blk0 + (j >> 1)) * kBN,
                              b * at.zb + h * at.zh);
        if (++slot == kSlots) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    role_exit();
  } else {  // ------------------------------------------------ consumers
    reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % kWarpgroup, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int row0 = q0 + wg * 64 + warp * 16 + g;
    float rl[2], rd[2];
    uint32_t h0[2] = {0, 0}, lrow[2] = {0, 0};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + hi * 8;
      const bool ok = row < Q;
      rl[hi] = ok ? lse[(long long)bh * Q + row] * kLog2e : 1e30f;
      rd[hi] = ok ? delta[(long long)bh * Q + row] : 0.f;
      if (drop.thresh && ok) {
        h0[hi] = row_h0(drop, drop_bh(drop, b, H, h), row);
        lrow[hi] = row % drop.group_rows;
      }
    }
    float acc[kD / 2];  // dQ
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * kRowBytes;
    const uint32_t do_addr = smem_u32(sDO) + wg * 64 * kRowBytes;
    const float qk = sm_scale * kLog2e;
    const float ks = drop.thresh ? drop.keep_scale : 1.f;
    int slot = 0;
    uint32_t phase = 0;

    mbar_wait(q_bar, 0);
    for (int blk = 0; blk < nit; ++blk) {
      const int v_slot = slot;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      mbar_wait(full + slot, phase);  // V
      wgmma_fence();
      product_kk(dp, do_addr, kQBox, smem_u32(sKV + v_slot * kTile64),
                 kBox64);
      wgmma_commit();                 // dP = dO V^T
      if (++slot == kSlots) {
        slot = 0;
        phase ^= 1;
      }
      const int k_slot = slot;
      const uint32_t k_addr = smem_u32(sKV + k_slot * kTile64);
      mbar_wait(full + slot, phase);  // K
      product_kk(s, q_addr, kQBox, k_addr, kBox64);  // S = Q K^T
      wgmma_commit();
      if (++slot == kSlots) {
        slot = 0;
        phase ^= 1;
      }
      // the keep bits depend on (row, col) alone: draw them while the
      // tensor cores work (bit 4 j + e for s[4 j + e])
      const int m0 = (blk0 + blk) * kBN;
      uint32_t keep = 0xffffffffu;
      if (drop.thresh) {
        auto draw = [&](auto v2) {
          uint32_t bits = 0u;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const uint32_t col = m0 + (i / 4) * 8 + tig * 2 + (i & 1);
            const bool k = keep_bit<decltype(v2)::value>(
                h0[(i >> 1) & 1], lrow[(i >> 1) & 1], col, drop.thresh);
            bits |= static_cast<uint32_t>(k) << i;
          }
          return bits;
        };
        keep = drop.v2 ? draw(std::true_type{}) : draw(std::false_type{});
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + v_slot);

#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1;
          const uint32_t col = m0 + j * 8 + tig * 2 + (e & 1);
          const float p = col < (uint32_t)N
              ? exp2f(s[4 * j + e] * qk - rl[hi]) : 0.f;
          const float w = (keep >> (4 * j + e)) & 1u ? p * ks : 0.f;
          dp[4 * j + e] = w * dp[4 * j + e] - p * rd[hi];
        }
      }
      product_rs(acc, dp, k_addr, kBox64);  // dQ += dS K
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + k_slot);
    }

    if (splits == 1) {
      bf16* dqbh = dq_out + (long long)bh * Q * kD;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + tig * 2;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = row0 + hi * 8;
          if (row < Q)
            *reinterpret_cast<uint32_t*>(dqbh + (long long)row * kD + col) =
                pack_bf16x2(acc[4 * n + 2 * hi] * sm_scale,
                            acc[4 * n + 2 * hi + 1] * sm_scale);
        }
      }
    } else {  // this KV range's dQ sum, f32, unscaled
      float* part = dq_part + ((long long)split * gridDim.z * H + bh) * Q * kD;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + tig * 2;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = row0 + hi * 8;
          if (row < Q)
            *reinterpret_cast<float2*>(part + (long long)row * kD + col) =
                make_float2(acc[4 * n + 2 * hi], acc[4 * n + 2 * hi + 1]);
        }
      }
    }
    role_exit();
  }
}

// dq of a split dq pass: the splits' f32 partials of each row added in
// split order, times sm_scale, rounded to bf16 once. One CTA of 256
// threads per 4 rows; a thread owns 4 columns.
__global__ void __launch_bounds__(256)
flash_bwd_dq_combine_kernel(const float* __restrict__ dq_part,
                            bf16* __restrict__ dq, long long rows,
                            int splits, float sm_scale) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 64;
  if (row >= rows) return;
  const int col = (threadIdx.x % 64) * 4;
  float4 sum = *reinterpret_cast<const float4*>(dq_part + row * kD + col);
  for (int i = 1; i < splits; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(
        dq_part + (i * rows + row) * kD + col);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  uint2 out;
  out.x = pack_bf16x2(sum.x * sm_scale, sum.y * sm_scale);
  out.y = pack_bf16x2(sum.z * sm_scale, sum.w * sm_scale);
  *reinterpret_cast<uint2*>(dq + row * kD + col) = out;
}

}  // namespace

cudaError_t flash_bwd(const void* q, const KV& k, const KV& v,
                      const void* dout, const float* lse, const float* delta,
                      Dropout drop, void* dq, const KV& dk, const KV& dv,
                      float* dq_part, int dq_splits, int B, int H, int Q,
                      int N, cudaStream_t stream) {
  const int nblocks = (N + dq_pass::kBN - 1) / dq_pass::kBN;
  if (dq_splits < 1 || dq_splits > kMaxSplits) return cudaErrorInvalidValue;
  const int bps = (nblocks + dq_splits - 1) / dq_splits;
  if ((dq_splits - 1) * bps >= nblocks) return cudaErrorInvalidValue;
  if (dq_splits > 1 && dq_part == nullptr) return cudaErrorInvalidValue;
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kD));
  const uint64_t bh = (uint64_t)B * H, q_stride = (uint64_t)Q * kD;
  CUtensorMap q64, do64, q128, do128, map_k, map_v;
  TmaCoord at_k, at_v;
  cudaError_t err = make_map(&q64, q, kD, Q, bh, kD, q_stride, dkv_pass::kBM);
  if (err != cudaSuccess) return err;
  err = make_map(&do64, dout, kD, Q, bh, kD, q_stride, dkv_pass::kBM);
  if (err != cudaSuccess) return err;
  err = make_map(&q128, q, kD, Q, bh, kD, q_stride, dq_pass::kBM);
  if (err != cudaSuccess) return err;
  err = make_map(&do128, dout, kD, Q, bh, kD, q_stride, dq_pass::kBM);
  if (err != cudaSuccess) return err;
  err = make_kv_map(&map_k, &at_k, k, B, H, N, 64);
  if (err != cudaSuccess) return err;
  err = make_kv_map(&map_v, &at_v, v, B, H, N, 64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_pass::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_pass::kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_sm90_kernel
      <<<dim3((N + dkv_pass::kBN - 1) / dkv_pass::kBN, H, B), kThreads,
         dkv_pass::kSmemBytes, stream>>>(q64, do64, map_k, map_v, at_k, at_v,
                                         lse, delta, drop, dk, dv, H, Q, N,
                                         sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_sm90_kernel
      <<<dim3((Q + dq_pass::kBM - 1) / dq_pass::kBM * dq_splits, H, B),
         kThreads, dq_pass::kSmemBytes, stream>>>(
          q128, do128, map_k, map_v, at_k, at_v, lse, delta, drop,
          static_cast<bf16*>(dq), dq_part, H, Q, N, dq_splits, bps,
          sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || dq_splits == 1) return err;
  const long long rows = (long long)B * H * Q;
  flash_bwd_dq_combine_kernel<<<(unsigned)((rows + 3) / 4), 256, 0,
                                stream>>>(dq_part, static_cast<bf16*>(dq),
                                          rows, dq_splits, sm_scale);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace parq
