// parse_pred's greedy 3D NMS and the pack of its detections, in one launch
// (sm_90a): the eval path's post-processing of a batch's last iteration.
//
// Replaces no Pallas kernel: the counterpart of the JAX package's plain
// device pass `nms_mask_device` (parq_tpu/evals/nms.py), which the port
// keeps too (parq_torch/evals/nms.py). Before it the port copied seven
// arrays to the host (seven blocking copies a batch) and ran the greedy
// pass there in the host library (native/native.cpp: nms3d). Its plain
// version is kernels/nms.py: nms_pack_plain.
//
// What it computes, per sample b (one CTA):
//   1. The AABB rows of the boxes' local corners (K, 8, 3): the min and max
//      of each axis in f32, then in f64 the volume (x2-x1)*(y2-y1)*(z2-z1),
//      operation for operation as nms3d, each step an _rn intrinsic so that
//      nvcc contracts nothing into an FMA.
//   2. The rank of each foreground box (label != num_semcls) among the
//      foreground boxes: the number of boxes of a higher score, or of an
//      equal score and a lower index. That is the stable descending order
//      of nms3d's std::stable_sort, without a sort.
//   3. The suppression bits, rank against rank: bit s of row r (s < r) is
//      set where the IoU of the two boxes, nms3d's f64 formula
//      inter / (area_r + area_s - inter), is above `thresh` (and, with
//      `same_class`, where their labels are equal). One warp a row, one
//      ballot a word of 32 ranks.
//   4. The greedy walk, in one warp: rank r is kept where no kept rank
//      before it has its bit set in row r. Each lane holds one word of the
//      kept set (K <= 1024: 32 words at most), so a step is one AND and one
//      vote. A background box is never kept and suppresses nothing.
//   5. The pack, one f32 row of C = 71 + S columns a box (S = the classes
//      with background): obb_data (19), corners_local (24), corners_world
//      (24), score, sem_cls_prob (S), label, valid, pred_mask = kept and
//      valid.
// With `nms` 0 steps 2-4 are skipped and every box counts as kept
// (pred_mask = valid), as parse_pred without NMS.
// The keep mask equals nms3d's bit for bit: the same f64 operations in the
// same order on the same f32 inputs; the IoU of a pair is symmetric in its
// two boxes (min, max, + and * commute exactly), so computing it once a
// pair, from either side, gives nms3d's value.
//
// What bounds it on this card: latency. At the release shape (B=1, K=256,
// S=10) it reads some 80 KB and writes 83 KB: 0.05 us at 3.35 TB/s. The
// work is K^2/2 f64 IoUs in one CTA (about 33 K pairs) and a walk of K
// dependent steps. What the design does about it:
//   - One launch for the whole of parse_pred's host half. The NMS runs in
//     CTA (b, 0); the pack's columns, all but pred_mask, in CTAs (b, 1..)
//     of kPackBoxes boxes each, on other SMs, at the same time.
//   - The bounds, volumes, scores, labels and ranks are staged in shared
//     memory once.
//   - A pair whose boxes do not meet on some axis (an f32 compare of the
//     exact f32 bounds) takes no f64 work: its intersection is 0.
//   - The division is taken only near the threshold: where the
//     intersection lies more than a relative 1e-9 above or below
//     thresh * denominator, the rounded quotient is on that side of
//     `thresh` too (the products' rounding is 2^-52 relative).
//   - The walk's row loads do not depend on the kept set, so they run
//     ahead of the votes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;                  // 32 words of kept ranks
constexpr int kFixedCols = 71;               // every column but the classes
constexpr int kPackBoxes = 32;               // boxes a pack CTA copies

__host__ __device__ inline int words(int K) { return (K + 31) / 32; }

// by rank: area (f64), lo and hi (3 + 3 f32), label; by box: key (u64),
// rank; then the suppression bits, K rows of words(K)
__host__ __device__ inline size_t smem_bytes(int K) {
  return (size_t)K * (2 * sizeof(double) + 6 * sizeof(float) +
                      2 * sizeof(int)) +
         (size_t)K * words(K) * sizeof(uint32_t);
}

// std::min / std::max as nms3d calls them (ties return the first argument)
template <typename T>
__device__ inline T smin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ inline T smax(T a, T b) { return a < b ? b : a; }

// numpy's min / max reduction over f32 (a NaN propagates)
__device__ inline float nmin(float m, float v) {
  return (v < m || v != v) ? v : m;
}
__device__ inline float nmax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// The order key of box i: 0 for a background box; else the score's bits
// made monotone (a NaN score, never a probability, lowest) above ~i, so
// that box j goes before box i in nms3d's stable descending order exactly
// where key_j > key_i.
__device__ inline unsigned long long order_key(float score, bool fg, int i) {
  if (!fg) return 0ull;
  if (score == 0.f) score = 0.f;                       // -0 ties +0
  const uint32_t u = __float_as_uint(score);
  const uint32_t m = score != score ? 0u : (u >> 31 ? ~u : u | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32) | ~static_cast<uint32_t>(i);
}

struct Ranked {          // the foreground in rank order, in shared memory
  double* area;
  float* lo[3];          // the AABB's bounds: exact f32, as nms3d's rows
  float* hi[3];
  int* cls;
};

struct Box {
  float lo[3], hi[3];
  double area;
  int cls;
};

__device__ inline Box load(const Ranked& s, int r) {
  Box b;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    b.lo[d] = s.lo[d][r];
    b.hi[d] = s.hi[d][r];
  }
  b.area = s.area[r];
  b.cls = s.cls[r];
  return b;
}

// nms3d's test of candidate a against the earlier box b:
// inter / (area_a + area_b - inter) > thresh in f64, bit for bit
__device__ inline bool over(const Box& a, const Box& b, double thresh,
                            int same_class) {
  if (same_class && a.cls != b.cls) return false;
  float mh[3], ml[3];
  bool meet = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    mh[d] = smin(a.hi[d], b.hi[d]);
    ml[d] = smax(a.lo[d], b.lo[d]);
    meet = meet && mh[d] > ml[d];
  }
  // an axis without overlap: inter = 0, and 0 / d > thresh >= 0 is false
  if (!meet && thresh >= 0.0) return false;
  double ext[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    ext[d] = smax(0.0, __dsub_rn(static_cast<double>(mh[d]),
                                 static_cast<double>(ml[d])));
  const double inter = __dmul_rn(__dmul_rn(ext[0], ext[1]), ext[2]);
  const double denom = __dsub_rn(__dadd_rn(a.area, b.area), inter);
  if (thresh > 0.0 && denom > 0.0) {
    const double p = __dmul_rn(thresh, denom);
    if (p > 1e-290) {                          // normal: 2^-52 relative
      if (inter > __dmul_rn(p, 1.0 + 1e-9)) return true;
      if (inter < __dmul_rn(p, 1.0 - 1e-9)) return false;
    }
  }
  return __ddiv_rn(inter, denom) > thresh;
}

__global__ void __launch_bounds__(kThreads)
nms_pack_kernel(const float* __restrict__ obb, const float* __restrict__ cl,
                const float* __restrict__ cw, const float* __restrict__ score,
                const float* __restrict__ prob,
                const long long* __restrict__ label,
                const uint8_t* __restrict__ valid, int K, int S,
                int num_semcls, double thresh, int same_class, int nms,
                float* __restrict__ out) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int C = kFixedCols + S;
  const long long box0 = (long long)b * K;
  float* o = out + box0 * C;

  if (blockIdx.y > 0) {        // a pack CTA: every column but pred_mask
    const int i0 = (blockIdx.y - 1) * kPackBoxes;
    const int n = min(kPackBoxes, K - i0) * C;
    for (int e = tid; e < n; e += kThreads) {
      const int i = i0 + e / C, c = e % C;
      const long long bi = box0 + i;
      float v;
      if (c < 19) v = obb[bi * 19 + c];
      else if (c < 43) v = cl[bi * 24 + c - 19];
      else if (c < 67) v = cw[bi * 24 + c - 43];
      else if (c == 67) v = score[bi];
      else if (c < 68 + S) v = prob[bi * S + c - 68];
      else if (c == 68 + S) v = static_cast<float>(label[bi]);
      else if (c == 69 + S) v = valid[bi] ? 1.f : 0.f;
      else continue;                           // pred_mask: CTA (b, 0)
      o[(long long)i * C + c] = v;
    }
    return;
  }
  if (!nms) {
    for (int i = tid; i < K; i += kThreads)
      o[(long long)i * C + C - 1] = valid[box0 + i] ? 1.f : 0.f;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = tid & 31, warp = tid >> 5, W = words(K);
  Ranked s;
  s.area = reinterpret_cast<double*>(smem);
  auto* key = reinterpret_cast<unsigned long long*>(s.area + K);
  float* f = reinterpret_cast<float*>(key + K);
  for (int d = 0; d < 3; ++d) {
    s.lo[d] = f + d * K;
    s.hi[d] = f + (3 + d) * K;
  }
  s.cls = reinterpret_cast<int*>(f + 6 * K);
  int* rank = s.cls + K;
  uint32_t* sup = reinterpret_cast<uint32_t*>(rank + K);
  __shared__ uint32_t kept[32];
  __shared__ int n_fg;

  // 1. order keys
  if (tid == 0) n_fg = 0;
  for (int i = tid; i < K; i += kThreads)
    key[i] = order_key(score[box0 + i],
                       label[box0 + i] != num_semcls, i);
  __syncthreads();

  // 2. each foreground box's rank (the boxes whose key is higher), and its
  //    AABB row and volume in nms3d's f64 arithmetic, stored at its rank
  for (int i = tid; i < K; i += kThreads) {
    const unsigned long long ki = key[i];
    int r = -1;
    if (ki) {
      r = 0;
      for (int j = 0; j < K; ++j) r += key[j] > ki;
      const float* p = cl + (box0 + i) * 24;
      float lo[3] = {p[0], p[1], p[2]}, hi[3] = {p[0], p[1], p[2]};
#pragma unroll
      for (int c = 1; c < 8; ++c)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          lo[d] = nmin(lo[d], p[3 * c + d]);
          hi[d] = nmax(hi[d], p[3 * c + d]);
        }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        s.lo[d][r] = lo[d];
        s.hi[d][r] = hi[d];
      }
      s.area[r] = __dmul_rn(
          __dmul_rn(__dsub_rn(hi[0], lo[0]), __dsub_rn(hi[1], lo[1])),
          __dsub_rn(hi[2], lo[2]));
      s.cls[r] = static_cast<int>(label[box0 + i]);
      atomicAdd(&n_fg, 1);
    }
    rank[i] = r;
  }
  __syncthreads();
  const int n = n_fg;

  // 3. suppression bits: row r, word q holds ranks 32q .. 32q + 31 (< r)
  for (int r = warp; r < n; r += kWarps) {
    const Box a = load(s, r);
    for (int q = 0; q <= (r >> 5); ++q) {
      const int t = q * 32 + lane;
      const bool hit = t < r && over(a, load(s, t), thresh, same_class);
      const uint32_t bits = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) sup[r * W + q] = bits;
    }
  }
  __syncthreads();

  // 4. the greedy walk, one warp, 32 ranks at a time: lane l takes rank
  //    32q + l, dead where a kept rank of an earlier word suppresses it;
  //    then the word's own ranks in order, from their bits in word q
  if (warp == 0) {
    for (int q = 0; q < (n + 31) / 32; ++q) {
      const int r = q * 32 + lane;
      bool dead = r >= n;
      for (int w = 0; w < q && !dead; ++w) dead = sup[r * W + w] & kept[w];
      const uint32_t mine = dead ? 0u : sup[r * W + q];
      const uint32_t gone = __ballot_sync(0xffffffffu, dead);
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const uint32_t row = __shfl_sync(0xffffffffu, mine, t);
        if (!((gone >> t) & 1u) && !(row & word)) word |= 1u << t;
      }
      if (lane == 0) kept[q] = word;
      __syncwarp();
    }
  }
  __syncthreads();

  // 5. pred_mask = kept and valid
  for (int i = tid; i < K; i += kThreads) {
    const int r = rank[i];
    const bool keep = r >= 0 && ((kept[r >> 5] >> (r & 31)) & 1u);
    o[(long long)i * C + C - 1] = keep && valid[box0 + i] ? 1.f : 0.f;
  }
}

}  // namespace

// obb (B, K, 19), corners_local and corners_world (B, K, 8, 3), score
// (B, K), prob (B, K, S) f32; label (B, K) int64; valid (B, K) bytes (0/1,
// torch.bool); all contiguous on the card. out: (B, K, 71 + S) f32. With
// `nms` 0 no box is suppressed. Grid (B, 1 + ceil(K / kPackBoxes)).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for K outside
// 1 .. 1024).
extern "C" int parq_nms_pack(const void* obb, const void* corners_local,
                             const void* corners_world, const void* score,
                             const void* prob, const void* label,
                             const void* valid, int B, int K, int S,
                             int num_semcls, double thresh, int same_class,
                             int nms, void* out, void* stream) {
  if (K < 1 || K > kMaxK || S < 1 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, 1 + (K + kPackBoxes - 1) / kPackBoxes);
  nms_pack_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obb), static_cast<const float*>(corners_local),
      static_cast<const float*>(corners_world),
      static_cast<const float*>(score), static_cast<const float*>(prob),
      static_cast<const long long*>(label),
      static_cast<const uint8_t*>(valid), K, S, num_semcls, thresh,
      same_class, nms, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
