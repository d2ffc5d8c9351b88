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
// The (B, N, M) distance array exists nowhere.  The TPU kernel unpacks
// descriptors to +-1 bf16 and takes 128 - dot/2 on the matrix unit for
// every pair of a tile, and merges sequential column tiles with a strict
// `<`.  Here the window admits about one pair in a hundred, so the work is
// the window test, and the popcounts run only for the admitted pairs, in
// any order: partial results merge with an order-free rule (the smaller
// best wins, the smaller index on equal best, and second = min(second_1,
// second_2, the loser's best)), which gives the first minimum and
// second == best on a tie whatever the order.
//
// Bound: at the mapping path's shape (B = 8 pairs, N = M = 1536, 1.2% of
// the pairs admitted) the function moves 0.9 MB, under a microsecond of
// the card's memory rate; validity belongs to a row and to a column, so
// each of the 18.9 M (row, column) pairs needs the window test alone, 2
// subtractions and 2 compares of magnitudes, and an admitted pair 20
// instructions more and 8 __popc, which at the card's rates (132 SMs x 128
// instructions, x 16 __popc, a clock at 1.98 GHz) is 0.0028 ms: bound by
// operations.  Measured on an H100 80GB HBM3 at 700 W by chip_smoke.py, per
// launch of a CUDA graph of 20: 0.011 ms, four times the bound, where the
// kernel this one replaces (descriptor words loaded before the test,
// popcounts in a divergent branch, six load-barrier-compute rounds) took
// 0.060 ms.  Of the 0.011 ms about 0.004 are the launch, the rows' loads and
// the staging, 0.006 the tests and the queueing (instruction-bound: about
// 6.5 a tested pair, queue writes included, against the 4 of the bound) and
// 0.002 the popcounts of the admitted pairs; PERF.md has the breakdown.
//
// Design:
// - Test first, load later.  A block owns 32 rows of one pair and stages
//   what the test needs of ALL columns, once: (x, y) as one float2 with
//   x = NaN for an invalid column, so the test loads no flag and no
//   descriptor (8 bytes a column, 12 KB at the path's shape; more than
//   kChunk columns are staged in further rounds).  One barrier a round.
//   While testing, lane l of each of the 8 warps holds row l in registers
//   (an invalid row as NaN) and the warps split the columns in runs of 32:
//   16-byte broadcast loads, two subtractions and two compares a pair, the
//   outcomes kept as one bit a column.  NaN fails both compares, in rows
//   and in columns.  No step waits for the step before it.
// - Compaction.  A lane whose run admitted columns reserves room in its
//   row's queue in shared memory with ONE atomic add and writes the column
//   numbers there.  After the barrier the 8 lanes of a row take the queue's
//   entries s, s + 8, ... as whole descriptors (two 16-byte loads from
//   device memory through the read-only path, kDepth entries in flight a
//   lane), and merge by three butterfly steps.  No lane idles on another's
//   popcount.
// - Dense scenes.  A row's queue holds kQueue columns; the path admits at
//   most 43 a row.  When a lane of a warp could not queue all of its run,
//   the warp takes what is left of that run for all its 32 rows at once as
//   a 32 x 32 tile on the tensor cores (8 mma.m16n8k256 .and.popc, the bit
//   product of hamming.cu), the outcome bits choosing among the distances;
//   the drain folds the tiles' results in.  With every pair admitted
//   ((2, 1536, 1536)) a launch takes 0.030 ms, the replaced kernel 0.037.
// - Rows in flight.  The path's 384 blocks of 256 threads and 23 KB are
//   all resident at once (3 an SM); a block whose rows are all invalid
//   (the padded pair lanes of the first keyframes) finds that out from one
//   32-byte load and a ballot, writes its sentinels and returns before it
//   stages anything.  Flags, positions and descriptors of the rows are
//   loaded side by side, and the staging loads are unconditional, so each
//   phase costs one trip to memory.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 32;  // rows per block: one per lane while testing
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 4096;  // columns staged at a time: 32 KB
constexpr int kQueue = 64;    // queued columns per row
constexpr int kDepth = 3;     // queue entries a lane has in flight together
constexpr unsigned kFull = 0xffffffffu;

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

// merge(acc, {d, col, invalid}) for a column not seen before
__device__ __forceinline__ void update(Top2& acc, int d, int col) {
  if (d < acc.best || (d == acc.best && col < acc.idx)) {
    acc.second = acc.best;  // best <= second always
    acc.best = d;
    acc.idx = col;
  } else {
    acc.second = min(acc.second, d);
  }
}

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1, const uint4& b0,
                                       const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// d += popc(a & b) over a 16 x 256-bit by 256-bit x 8 tile (tensor cores)
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sum over the four lanes of a quad, in every lane of it
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

// Some row's queue is full: the whole warp takes what is left of this
// 32-column run, `rest` (lane l: row row0 + l, bit c: column col0 + c), as
// one 32 x 32 tile.  All its distances come from the tensor cores, as
// popc(a) + popc(b) - 2 popc(a & b) with the fragment layout of hamming.cu
// (lane = 4 g + t holds words t and t + 4 of rows g and g + 8 of a 16-row
// tile and of column g of an 8-column tile, and the results of rows g,
// g + 8 at columns 2 t, 2 t + 1), and the bits of `rest` choose among them.
// The rows' results are merged into `mine`, this warp's 32 entries.  Out of
// line, so that the testing loop stays a few instructions.
__device__ __noinline__ void take_tile(Top2* mine, const uint32_t* __restrict__ desc_a,
                                       const uint32_t* __restrict__ desc_b, unsigned rest,
                                       int row0, int col0, int n, int m, int invalid) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t bf[4][2];
  int pb[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + 8 * j + g;
    const uint32_t* p = desc_b + (size_t)col * 8 + t;
    bf[j][0] = col < m ? __ldg(p) : 0u;
    bf[j][1] = col < m ? __ldg(p + 4) : 0u;
    const int q = quad_sum(__popc(bf[j][0]) + __popc(bf[j][1]));
    pb[j][0] = __shfl_sync(kFull, q, 8 * t);
    pb[j][1] = __shfl_sync(kFull, q, 8 * t + 4);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // rows 16 half + g and 16 half + g + 8
    const int r0 = row0 + 16 * half + g, r1 = r0 + 8;
    const uint32_t* p = desc_a + (size_t)r0 * 8 + t;
    uint32_t af[4];
    af[0] = r0 < n ? __ldg(p) : 0u;
    af[2] = r0 < n ? __ldg(p + 4) : 0u;
    af[1] = r1 < n ? __ldg(p + 64) : 0u;
    af[3] = r1 < n ? __ldg(p + 68) : 0u;
    const int pa0 = quad_sum(__popc(af[0]) + __popc(af[2]));
    const int pa1 = quad_sum(__popc(af[1]) + __popc(af[3]));
    const unsigned bits0 = __shfl_sync(kFull, rest, 16 * half + g);
    const unsigned bits1 = __shfl_sync(kFull, rest, 16 * half + g + 8);
    Top2 t0 = {invalid, 0, invalid}, t1 = t0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int d[4] = {0, 0, 0, 0};
      mma_and_popc(d, af, bf[j][0], bf[j][1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if ((bits0 >> c) & 1u) update(t0, pa0 + pb[j][e] - 2 * d[e], col0 + c);
        if ((bits1 >> c) & 1u) update(t1, pa1 + pb[j][e] - 2 * d[2 + e], col0 + c);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad's four lanes share the rows
      Top2 o0, o1;
      o0.best = __shfl_xor_sync(kFull, t0.best, off);
      o0.idx = __shfl_xor_sync(kFull, t0.idx, off);
      o0.second = __shfl_xor_sync(kFull, t0.second, off);
      o1.best = __shfl_xor_sync(kFull, t1.best, off);
      o1.idx = __shfl_xor_sync(kFull, t1.idx, off);
      o1.second = __shfl_xor_sync(kFull, t1.second, off);
      t0 = merge(t0, o0);
      t1 = merge(t1, o1);
    }
    if (t == 0) {
      mine[16 * half + g] = merge(mine[16 * half + g], t0);
      mine[16 * half + g + 8] = merge(mine[16 * half + g + 8], t1);
    }
  }
  __syncwarp();
}

static_assert(kWarps == 8 && kRows == 32,
              "a warp's tile is 32 rows; the 8 lanes that drain a row gather one warp's each");

__global__ void __launch_bounds__(kThreads)
windowed_match_kernel(const uint4* __restrict__ desc_a, const uint4* __restrict__ desc_b,
                      const float2* __restrict__ xy_a, const float2* __restrict__ xy_b,
                      const uint8_t* __restrict__ valid_a, const uint8_t* __restrict__ valid_b,
                      int32_t* __restrict__ best, long long* __restrict__ idx,
                      int32_t* __restrict__ second, int n, int m, int row_blocks, float radius,
                      int invalid) {
  extern __shared__ float4 staged[];  // the columns of one round, two to a float4
  __shared__ int queues[kRows][kQueue];
  __shared__ int counts[kRows];
  __shared__ Top2 tiles[kWarps][kRows];  // what each warp took as tiles, by row

  const int pair = blockIdx.x / row_blocks;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = (blockIdx.x - pair * row_blocks) * kRows;

  desc_a += (size_t)pair * n * 2;  // a descriptor is two uint4
  desc_b += (size_t)pair * m * 2;
  xy_a += (size_t)pair * n;
  xy_b += (size_t)pair * m;
  valid_a += (size_t)pair * n;
  valid_b += (size_t)pair * m;
  best += (size_t)pair * n;
  idx += (size_t)pair * n;
  second += (size_t)pair * n;

  // While testing, lane l of EVERY warp owns row row0 + l (the warps split
  // the columns); while draining, lane 8 g + s of warp w owns every eighth
  // entry, from s on, of the queue of row row0 + 4 w + g, and what warp s
  // took as tiles for that row.  What both need of the rows is loaded here,
  // flags, positions and descriptors side by side: one trip to memory.
  const int test_row = row0 + lane;
  const int drain_slot = warp * 4 + (lane >> 3), eighth = lane & 7;
  const int drain_row = row0 + drain_slot;
  const bool flag = test_row < n && __ldg(valid_a + test_row) != 0;
  const float2 pos = test_row < n ? __ldg(xy_a + test_row) : make_float2(0.f, 0.f);
  uint4 a0 = make_uint4(0u, 0u, 0u, 0u), a1 = a0;
  if (drain_row < n) {
    a0 = __ldg(desc_a + 2 * (size_t)drain_row);
    a1 = __ldg(desc_a + 2 * (size_t)drain_row + 1);
  }
  if (__ballot_sync(kFull, flag) == 0u) {  // no live row in the block: nothing is staged
    if (warp == 0 && test_row < n) {
      best[test_row] = invalid;
      idx[test_row] = 0;
      second[test_row] = invalid;
    }
    return;
  }
  // an invalid row tests as NaN: it admits no column, like a NaN row
  const float ax = flag ? pos.x : CUDART_NAN_F, ay = pos.y;
  tiles[warp][lane] = Top2{invalid, 0, invalid};
  if (warp == 0) counts[lane] = 0;

  for (int col0 = 0; col0 < m; col0 += kChunk) {
    const int cols = min(kChunk, m - col0);
    const int padded = (cols + 31) & ~31;
    if (col0 > 0) __syncthreads();  // the previous round has been tested
    float2* sxy = reinterpret_cast<float2*>(staged);
#pragma unroll 8
    for (int c = tid; c < padded; c += kThreads) {
      // flag and position: unconditional, independent loads (the padding
      // reads the last column again), so the unrolled trips overlap
      const int src = col0 + min(c, cols - 1);
      const float2 p = __ldg(xy_b + src);
      const bool ok = __ldg(valid_b + src) != 0 && c < cols;
      sxy[c] = make_float2(ok ? p.x : CUDART_NAN_F, p.y);
    }
    __syncthreads();

    // warp w tests the 32-column runs w, w + 8, ...: 16-byte broadcast
    // loads, four tests a lane for each pair of them, the outcomes kept as
    // one bit a column; nothing waits for the step before
    for (int run = warp; run < padded / 32; run += kWarps) {
      unsigned mask = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 u = staged[16 * run + 2 * j], v = staged[16 * run + 2 * j + 1];
        if (fabsf(ax - u.x) <= radius && fabsf(ay - u.y) <= radius) mask |= 1u << (4 * j);
        if (fabsf(ax - u.z) <= radius && fabsf(ay - u.w) <= radius) mask |= 2u << (4 * j);
        if (fabsf(ax - v.x) <= radius && fabsf(ay - v.y) <= radius) mask |= 4u << (4 * j);
        if (fabsf(ax - v.z) <= radius && fabsf(ay - v.w) <= radius) mask |= 8u << (4 * j);
      }
      if (mask != 0u) {  // about a third of the lanes: one atomic for the run
        int slot = atomicAdd(&counts[lane], __popc(mask));
        while (mask != 0u && slot < kQueue) {
          queues[lane][slot++] = col0 + 32 * run + __ffs(mask) - 1;
          mask &= mask - 1u;
        }
      }
      // what did not fit a queue (dense scenes, not the path): as a tile
      if (__any_sync(kFull, mask != 0u))
        take_tile(tiles[warp], reinterpret_cast<const uint32_t*>(desc_a),
                  reinterpret_cast<const uint32_t*>(desc_b), mask, row0, col0 + 32 * run, n, m,
                  invalid);
    }
  }
  __syncthreads();  // every row's queue is complete

  // lane s of the row's 8 takes entries s, s + 8, ...: whole descriptors,
  // kDepth of them in flight, and starts from what warp s took as tiles
  Top2 acc = tiles[eighth][drain_slot];
  const int total = min(counts[drain_slot], kQueue);
  const int* mine = queues[drain_slot];
  for (int k0 = eighth; k0 < total; k0 += 8 * kDepth) {
    int col[kDepth];
    uint4 b0[kDepth], b1[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) col[u] = mine[min(k0 + 8 * u, total - 1)];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      b0[u] = __ldg(desc_b + 2 * (size_t)col[u]);
      b1[u] = __ldg(desc_b + 2 * (size_t)col[u] + 1);
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u)
      if (k0 + 8 * u < total) update(acc, hamming(a0, a1, b0[u], b1[u]), col[u]);
  }
  // the row's 8 lanes
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(kFull, acc.best, off);
    o.idx = __shfl_xor_sync(kFull, acc.idx, off);
    o.second = __shfl_xor_sync(kFull, acc.second, off);
    acc = merge(acc, o);
  }
  if (eighth == 0 && drain_row < n) {
    // a row with no admissible column reports index 0
    best[drain_row] = acc.best;
    idx[drain_row] = (acc.best >= invalid) ? 0 : acc.idx;
    second[drain_row] = acc.second;
  }
}

}  // namespace

// desc_a (b, n, 8), desc_b (b, m, 8) 32-bit words, 16-byte aligned; xy_a
// (b, n, 2), xy_b (b, m, 2) float32, 8-byte aligned; valid_a (b, n), valid_b (b, m) bytes;
// outputs best and second (b, n) int32 and idx (b, n) int64.  Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int windowed_match_launch(const void* desc_a, const void* desc_b, const void* xy_a,
                                     const void* xy_b, const void* valid_a, const void* valid_b,
                                     void* best, void* idx, void* second, int b, int n, int m,
                                     float radius, int invalid, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const long long row_blocks = (n + kRows - 1) / kRows;
  if (row_blocks * b > 0x7fffffffLL || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int staged = m < kChunk ? m : kChunk;
  const size_t shared = sizeof(float2) * static_cast<size_t>((staged + 31) & ~31);
  windowed_match_kernel<<<static_cast<unsigned>(row_blocks * b), kThreads, shared,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc_a), static_cast<const uint4*>(desc_b),
      static_cast<const float2*>(xy_a), static_cast<const float2*>(xy_b),
      static_cast<const uint8_t*>(valid_a), static_cast<const uint8_t*>(valid_b),
      static_cast<int32_t*>(best), static_cast<long long*>(idx), static_cast<int32_t*>(second),
      n, m, static_cast<int>(row_blocks), radius, invalid);
  return static_cast<int>(cudaGetLastError());
}
