// Hopper (sm_90a) building blocks shared by the flash cross-attention
// kernels: TMA tile loads that complete on an mbarrier, warpgroup matrix
// products (wgmma.mma_async, bf16 in, f32 accumulate) on shared-memory
// tiles in the 128-byte-swizzle layout, and the register hand-over between
// a TMA producer warpgroup and the consumers (setmaxnreg).
//
// Tile convention. A tile of R rows x 64 bf16 columns is one TMA box: R
// rows of 128 bytes, written by the TMA unit with CU_TENSOR_MAP_SWIZZLE_128B
// (the 16-byte chunk index of a row is XORed with the row index mod 8), so
// it must start on a 1024-byte boundary. A tile of D = 256 columns is four
// such boxes, one after the other. The same stored tile serves wgmma in
// two ways:
//   - K-major (desc_k): the tile's columns are the product's k. 16 columns
//     (32 bytes) per wgmma; the descriptor's start address advances
//     by 32 bytes inside a box, 8-row groups are 1024 bytes apart (SBO).
//   - MN-major (desc_mn): the tile's ROWS are the product's k and its
//     columns the n (or m) index, i.e. the transposed operand read in
//     place. 16 rows (2048 bytes) per wgmma; 64-column groups are one
//     box apart (LBO), 8-row groups 1024 bytes apart (SBO).
// A wrong major-ness gives wrong numbers, not an error: the two forms are
// held against a plain product by parq_wgmma_selftest (flash_fwd_sm90.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBoxCols = 64;            // bf16 columns of one TMA box
constexpr int kRowBytes = kBoxCols * 2; // 128: the swizzle span
constexpr int kWarpgroup = 128;         // threads that issue one wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory is 16-byte aligned; the swizzled tiles need 1024
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------- mbarrier --
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(arrivals) : "memory");
}

// make the barriers' initial state visible to the TMA unit
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more to wait for from TMA loads
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the barrier's phase with this parity has completed. It spins
// without a time limit: a trap here would make ptxas keep the kernel-wide
// register limit for every role (see role_exit), so a protocol error hangs
// the launch; find one by reading the arrive/wait pairs, not by a timeout.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- TMA --
// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, no tensor map; completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a tile of `kBoxes` boxes (columns c0, c0 + 64, ...) of `box_bytes` each
template <int kBoxes>
__device__ __forceinline__ void tma_load_tile(void* dst, int box_bytes,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int c0, int c1,
                                              int c2) {
#pragma unroll
  for (int i = 0; i < kBoxes; ++i)
    tma_load_3d(static_cast<char*>(dst) + i * box_bytes, map, bar,
                c0 + i * kBoxCols, c1, c2);
}

// ------------------------------------------------- named barriers --
// bar.sync / bar.arrive on barrier `id` (1..15; 0 is __syncthreads) among
// `threads` threads; writes to shared memory made before an arrive are
// visible to the threads the matching sync releases
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ----------------------------------------------- register hand-over --
// A warp-specialised kernel launches (consumers + 1) warpgroups with
// __launch_bounds__(threads, 1): 168 registers a thread at 384 threads. The
// producer warpgroup then gives registers up and the consumers take them.
// ptxas raises the consumers' allocation limit to kConsumerRegs only if the
// two roles are one if/else whose branches never meet again: each must end
// in role_exit(), and nothing (not even a trap) may leave a branch another
// way. Otherwise it allocates both under the launch limit, spills the
// accumulators and serialises the wgmmas (ptxas note C7512 in the log).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 2 x 128 x 240 + 128 x 24 = 64,512

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void role_exit() { asm volatile("exit;\n"); }

// -------------------------------------------------------------- wgmma --
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pins the accumulators between the compiler's view and the asynchronous
// products: no read or write of d moves across this point. Call it after
// wgmma_wait before d is read, and before wgmma_fence after d was written.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors, 128-byte swizzle (layout type 1 in
// bits 62-63), SBO = 1024 bytes in bits 32-45, LBO in bits 16-29, the
// start address >> 4 in bits 0-13.
constexpr uint64_t kDescB128 = (1ull << 62) | (64ull << 32);

// K-major: `addr` is the box's row 0 (or row 64 of a 128-row box) plus
// 32 bytes per 16-column k step. LBO is not used by this form (1).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return kDescB128 | (1ull << 16) | ((addr & 0x3FFFFu) >> 4);
}

// MN-major: `addr` is the tile's first box plus 2048 bytes per 16-row k
// step; `box_bytes` is the distance between 64-column groups.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int box_bytes) {
  return kDescB128 | (static_cast<uint64_t>(box_bytes >> 4) << 16) |
         ((addr & 0x3FFFFu) >> 4);
}

// The accumulator of an m64nN product: thread t of the warpgroup holds, in
// d[4j + e], the element at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and
// column 8 j + 2 (t % 4) + (e % 2): the mma.sync m16n8 C fragment of each
// warp's 16 rows, repeated along N.

// d (64 x 64, f32) = or += A (64 x 16, shared, K-major) * B (16 x 64,
// shared, K-major); accumulate == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256, f32) = or += A (64 x 16, registers) * B (16 x 256, shared,
// MN-major: the tile is stored [k][n]). Each warp's A registers are the
// mma.sync m16n8k16 A fragment of its 16 rows.
__device__ __forceinline__ void wgmma_rs_n256_bt(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The A registers of k step `kk` (columns 16 kk .. 16 kk + 15) from an
// accumulator tile: its C fragments rounded to bf16 are the A fragments.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kN>
__device__ __forceinline__ void acc_to_a(const float (&c)[kN], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
}

// ------------------------------------------------- tensor maps (host) --
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the loaded libcuda through the
// runtime, so the library has no link-time dependency on libcuda. The
// first call (a warm-up, outside any stream capture) caches the pointer.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The map of a bf16 tensor seen as (batch, rows, cols), cols contiguous,
// `row_stride` and `batch_stride` in elements, read in boxes of box_rows x
// 64 with the 128-byte swizzle. Rows past `rows` read as zeros: a box never
// reaches into the next batch element. Pure host arithmetic: no
// allocation, no synchronisation, legal during stream capture.
inline cudaError_t make_map(CUtensorMap* map, const void* base, uint64_t cols,
                            uint64_t rows, uint64_t batch,
                            uint64_t row_stride, uint64_t batch_stride,
                            uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cols, rows, batch};
  const cuuint64_t strides[2] = {row_stride * 2, batch_stride * 2};
  const cuuint32_t box[3] = {kBoxCols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
