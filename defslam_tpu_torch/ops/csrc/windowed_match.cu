// Windowed Hamming matching with a two-minimum reduction per row, batched
// over keyframe pairs, on Hopper (sm_90a).
//
// Replaces defslam_tpu/ops/pallas_kernels.py::windowed_match_pallas (body
// _match_reduce_kernel).  For every row keypoint r of every pair:
//
//   d(r, c) = popcount(desc_a[r] ^ desc_b[c])   if both are valid and
//             max(|xa - xb|, |ya - yb|) <= radius (float32),
//             `invalid` otherwise               (invalid > 256)
//   best    = min_c d(r, c)
//   idx     = the LOWEST c attaining it (0 for a row with no admissible c)
//   second  = min over all columns but idx (two columns tied for the
//             minimum give second == best)
//
// The (B, N, M) distance array exists only in registers.  The TPU kernel
// unpacks descriptors to +-1 bf16 and takes 128 - dot/2 on the matrix unit
// because popcount is emulated there, and merges sequential column tiles
// with a strict `<`; here popcount is one instruction and the columns are
// split over the lanes of a warp, so partial results merge with an
// order-free rule: the smaller best wins, the smaller index on equal best,
// and second = min(second_1, second_2, the loser's best).
//
// Bound: at the mapping path's shape (B = 8 pairs, N = M = 1536) the
// kernel reads ~0.7 MB and writes 147 KB, which the card moves in well
// under a microsecond; the 18.9 M (row, column) pairs cost ~6 window
// operations each and 24 more (xor, popc, add per word) where the window
// admits the pair, so the integer/float instruction rate bounds it.  As
// written the kernel is latency-bound instead, at a few percent of that
// bound: the column tiles load one after the other with nothing prefetched.
//
// Design (correct first): a block of 8 warps owns 32 rows of one pair, 4
// rows per warp held in registers.  The block walks the pair's columns in
// tiles of 256 staged through shared memory (descriptor rows padded to 9
// words: conflict-free).  Lane l of every warp visits columns l, l+32, ...
// of a tile in ascending order, loads the column once into registers and
// updates its 4 rows; the popcounts are skipped when the window rejects the
// pair.  A butterfly shuffle merges the 32 lanes at the end.  Ragged N and
// M are masked here; the caller pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32
constexpr int kTileM = 256;
constexpr int kThreads = kWarps * 32;

struct Top2 {
  int best, idx, second;
};

__device__ __forceinline__ Top2 merge(const Top2& p, const Top2& q) {
  const bool p_wins = (p.best < q.best) || (p.best == q.best && p.idx <= q.idx);
  Top2 out;
  out.best = p_wins ? p.best : q.best;
  out.idx = p_wins ? p.idx : q.idx;
  const int loser = p_wins ? q.best : p.best;
  out.second = min(min(p.second, q.second), loser);
  return out;
}

__global__ void __launch_bounds__(kThreads)
windowed_match_kernel(const uint32_t* __restrict__ desc_a, const uint32_t* __restrict__ desc_b,
                      const float* __restrict__ xy_a, const float* __restrict__ xy_b,
                      const uint8_t* __restrict__ valid_a, const uint8_t* __restrict__ valid_b,
                      int32_t* __restrict__ best, int32_t* __restrict__ idx,
                      int32_t* __restrict__ second, int n, int m, float radius, int invalid) {
  __shared__ uint32_t sb[kTileM][kWords + 1];
  __shared__ float sx[kTileM], sy[kTileM];
  __shared__ uint8_t sv[kTileM];

  const int pair = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

  desc_a += (size_t)pair * n * kWords;
  desc_b += (size_t)pair * m * kWords;
  xy_a += (size_t)pair * n * 2;
  xy_b += (size_t)pair * m * 2;
  valid_a += (size_t)pair * n;
  valid_b += (size_t)pair * m;

  // this warp's rows, in registers (the same values in every lane)
  uint32_t aw[kRowsPerWarp][kWords];
  float ax[kRowsPerWarp], ay[kRowsPerWarp];
  bool av[kRowsPerWarp];
  Top2 acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + i;
    const bool in = r < n;
    av[i] = in && valid_a[in ? r : 0] != 0;
    ax[i] = in ? xy_a[(size_t)r * 2] : 0.f;
    ay[i] = in ? xy_a[(size_t)r * 2 + 1] : 0.f;
#pragma unroll
    for (int w = 0; w < kWords; ++w) aw[i][w] = in ? desc_a[(size_t)r * kWords + w] : 0u;
    acc[i].best = invalid;
    acc[i].idx = 0;
    acc[i].second = invalid;
  }

  for (int col0 = 0; col0 < m; col0 += kTileM) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < kTileM * kWords; i += kThreads) {
      const int c = i / kWords, w = i % kWords;
      sb[c][w] = (col0 + c < m) ? desc_b[(size_t)(col0 + c) * kWords + w] : 0u;
    }
    for (int c = tid; c < kTileM; c += kThreads) {
      const bool in = col0 + c < m;
      sx[c] = in ? xy_b[(size_t)(col0 + c) * 2] : 0.f;
      sy[c] = in ? xy_b[(size_t)(col0 + c) * 2 + 1] : 0.f;
      sv[c] = in ? valid_b[col0 + c] : (uint8_t)0;
    }
    __syncthreads();

    const int cols = min(kTileM, m - col0);
    for (int c = lane; c < cols; c += 32) {
      if (!sv[c]) continue;  // d = invalid: changes nothing (see below)
      const float bx = sx[c], by = sy[c];
      uint32_t bw[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) bw[w] = sb[c][w];
      const int col = col0 + c;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float dx = fabsf(ax[i] - bx), dy = fabsf(ay[i] - by);
        // an inadmissible column has d = invalid >= every running value,
        // and a lane visits its columns in ascending order, so skipping it
        // leaves (best, idx, second) as the update below would
        if (!(av[i] && fmaxf(dx, dy) <= radius) || isnan(dx) || isnan(dy)) continue;
        int d = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) d += __popc(aw[i][w] ^ bw[w]);
        if (d < acc[i].best) {
          acc[i].second = acc[i].best;
          acc[i].best = d;
          acc[i].idx = col;
        } else if (d < acc[i].second) {
          acc[i].second = d;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    Top2 t = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o;
      o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
      o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
      o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
      t = merge(t, o);
    }
    const int r = row0 + i;
    if (lane == 0 && r < n) {
      const size_t o = (size_t)pair * n + r;
      // a row with no admissible column reports index 0
      best[o] = t.best;
      idx[o] = (t.best >= invalid) ? 0 : t.idx;
      second[o] = t.second;
    }
  }
}

}  // namespace

// desc_a (b, n, 8), desc_b (b, m, 8) 32-bit words; xy_a (b, n, 2), xy_b
// (b, m, 2) float32; valid_a (b, n), valid_b (b, m) bytes; outputs three
// (b, n) int32 arrays.  Launches on `stream`; returns the cudaError_t of the
// launch (0 = success).
extern "C" int windowed_match_launch(const void* desc_a, const void* desc_b, const void* xy_a,
                                     const void* xy_b, const void* valid_a, const void* valid_b,
                                     void* best, void* idx, void* second, int b, int n, int m,
                                     float radius, int invalid, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, b);
  windowed_match_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc_a), static_cast<const uint32_t*>(desc_b),
      static_cast<const float*>(xy_a), static_cast<const float*>(xy_b),
      static_cast<const uint8_t*>(valid_a), static_cast<const uint8_t*>(valid_b),
      static_cast<int32_t*>(best), static_cast<int32_t*>(idx), static_cast<int32_t*>(second),
      n, m, radius, invalid);
  return static_cast<int>(cudaGetLastError());
}
