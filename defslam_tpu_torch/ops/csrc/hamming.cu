// All-pairs Hamming distances of 256-bit descriptors on Hopper (sm_90a).
//
// Replaces defslam_tpu/ops/pallas_kernels.py::hamming_matrix_pallas, which
// on the TPU unpacks the bits to +-1 bf16 and runs (256 - a.b) / 2 on the
// matrix unit because popcount is emulated there.  On this card popcount
// exists but is the scarce instruction too (16 results a clock an SM), so
// the bit product goes to the tensor cores here as well, without unpacking:
// one mma.sync.m16n8k256 .and.popc multiplies 16 descriptors by 8, a
// descriptor being exactly the instruction's 256-bit depth, and
//
//   hamming(a, b) = popc(a) + popc(b) - 2 * popc(a & b).
//
// Bound: at the tracking path's shape (N = 2048 map points, M = 1536 frame
// keypoints) the function writes N*M int32 = 12.6 MB and reads 115 KB, so
// the card's least time is the stores': 0.0038 ms at 3.35 TB/s.  A design
// that takes 8 __popc per output needs 25 M of them, 0.0060 ms at 132 SMs x
// 16 a clock x 1.98 GHz: above the stores, which is why the XOR + __popc
// kernel this one replaces (0.0099 ms a launch) could not reach the bound
// however it stored.  Here the popcounts left are those of the row and
// column sums, 12 a lane per 512 outputs.  Measured on an H100 80GB HBM3 at
// 700 W by chip_smoke.py, per launch of a CUDA graph of 20: 0.0065 ms, of
// which about 0.0014 ms is what an empty kernel costs there; 2 to 8 blocks
// an SM and streaming or cache-global store hints all gave 0.0064-0.0073
// ms, so what is left is the rate at which the L2 takes the stores.
//
// Design: no shared memory and no barrier.  A work item is 16 rows x 32
// columns = one A fragment and four B fragments, read straight from device
// memory through the read-only path in the layout the instruction wants
// (lane = 4 * g + t holds words t and t + 4 of row g, g + 8 and of column
// g).  The four column tiles are not neighbouring columns: tile j's
// logical column c is column 16*(j/2) + 4*(c/2) + 2*(j%2) + c%2 of the
// item, so that the accumulators of a lane are 2 x 2 runs of four
// consecutive columns and go out as 16-byte stores; each store instruction
// of a warp writes 64 contiguous bytes (two whole sectors) of 8 rows, two
// of them a whole 128-byte line.  A row stride that is no multiple of 16
// bytes, a misaligned output and the ragged last columns take 4-byte
// stores; rows and columns past the edge are loaded as zeros and not
// stored.  The grid is sized to the card: 4 blocks of 8 warps for each SM
// (fewer when there are fewer items), and every warp takes one contiguous
// run of the items in row-major order, so all warps carry the same load to
// within one item and a warp reloads its A fragment only when its run
// crosses into the next 16 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWords = 8;
constexpr int kWarps = 8;  // per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 4;
constexpr int kItemRows = 16;
constexpr int kItemCols = 32;
constexpr unsigned kFull = 0xffffffffu;

// d += popc(a & b) over a 16 x 256-bit by 256-bit x 8 tile
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

__device__ __forceinline__ void store4(int32_t* __restrict__ out, int r, int c, int n, int m,
                                       bool vec, int4 v) {
  if (r >= n || c >= m) return;
  int32_t* dst = out + (size_t)r * m + c;
  if (vec) {  // m % 4 == 0 and c % 4 == 0: c < m means c + 3 < m
    *reinterpret_cast<int4*>(dst) = v;
    return;
  }
  dst[0] = v.x;
  if (c + 1 < m) dst[1] = v.y;
  if (c + 2 < m) dst[2] = v.z;
  if (c + 3 < m) dst[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n, int m, int col_items, int items, int vec) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarps;
  const int first = (int)(items * warp / n_warps);
  const int last = (int)(items * (warp + 1) / n_warps);

  int cur_rb = -1;
  uint32_t af[4] = {0u, 0u, 0u, 0u};
  int pa0 = 0, pa1 = 0;  // popc of rows g and g + 8 of the item
  for (int it = first; it < last; ++it) {
    const int rb = it / col_items;
    const int cb = it - rb * col_items;
    const int r0 = rb * kItemRows + g, r1 = r0 + 8;
    if (rb != cur_rb) {
      cur_rb = rb;
      const uint32_t* pa = a + (size_t)r0 * kWords + t;
      af[0] = r0 < n ? __ldg(pa) : 0u;
      af[2] = r0 < n ? __ldg(pa + 4) : 0u;
      af[1] = r1 < n ? __ldg(pa + 8 * kWords) : 0u;
      af[3] = r1 < n ? __ldg(pa + 8 * kWords + 4) : 0u;
      pa0 = quad_sum(__popc(af[0]) + __popc(af[2]));
      pa1 = quad_sum(__popc(af[1]) + __popc(af[3]));
    }
    const int c0 = cb * kItemCols;

    // this lane's B fragments: column g of each of the four tiles
    uint32_t bf[4][2];
    int pbq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 16 * (j >> 1) + 4 * (g >> 1) + 2 * (j & 1) + (g & 1);
      const uint32_t* pb = b + (size_t)col * kWords + t;
      bf[j][0] = col < m ? __ldg(pb) : 0u;
      bf[j][1] = col < m ? __ldg(pb + 4) : 0u;
      pbq[j] = quad_sum(__popc(bf[j][0]) + __popc(bf[j][1]));
    }

    int d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
      mma_and_popc(d[j], af, bf[j][0], bf[j][1]);
    }

    // the accumulators of tile j are its logical columns 2t and 2t + 1,
    // whose popcounts the quads 2t and 2t + 1 hold
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pb0 = __shfl_sync(kFull, pbq[j], 8 * t);
      const int pb1 = __shfl_sync(kFull, pbq[j], 8 * t + 4);
      d[j][0] = pa0 + pb0 - 2 * d[j][0];
      d[j][1] = pa0 + pb1 - 2 * d[j][1];
      d[j][2] = pa1 + pb0 - 2 * d[j][2];
      d[j][3] = pa1 + pb1 - 2 * d[j][3];
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns c0 + 16 h + 4 t .. + 3
      const int c = c0 + 16 * h + 4 * t;
      store4(out, r0, c, n, m, vec != 0,
             make_int4(d[2 * h][0], d[2 * h][1], d[2 * h + 1][0], d[2 * h + 1][1]));
      store4(out, r1, c, n, m, vec != 0,
             make_int4(d[2 * h][2], d[2 * h][3], d[2 * h + 1][2], d[2 * h + 1][3]));
    }
  }
}

// SMs of the current device, asked of the CUDA runtime once per device; minus the
// cudaError_t where it cannot be told
int sm_count() {
  constexpr int kDevices = 64;
  static std::atomic<int> cache[kDevices];
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const bool cached = device >= 0 && device < kDevices;
  if (cached && (sms = cache[device].load(std::memory_order_relaxed)) > 0) return sms;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (cached) cache[device].store(sms, std::memory_order_relaxed);
  return sms;
}

}  // namespace

// (n, 8) x (m, 8) 32-bit words -> (n, m) int32, on `stream`.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out, int n, int m,
                                     void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const long long row_items = (n + kItemRows - 1) / kItemRows;
  const long long col_items = (m + kItemCols - 1) / kItemCols;
  if (row_items * col_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int items = static_cast<int>(row_items * col_items);
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const int want = (items + kWarps - 1) / kWarps;
  const int blocks = want < sms * kBlocksPerSm ? want : sms * kBlocksPerSm;
  const int vec = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  hamming_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), n, m, static_cast<int>(col_items), items, vec);
  return static_cast<int>(cudaGetLastError());
}
