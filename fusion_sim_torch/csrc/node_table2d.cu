// The node-centred E|B table of the 2D3V EM shells in one launch, Hopper.
//
// Replaces: no Pallas kernel.  The reference builds the table with the XLA
// composition center_fields (fusion_sim_tpu/ops/fdtd.py:115): each staggered
// component averaged with its rolled neighbour along each axis it is offset
// on, then the six columns stacked.  The port's plain version
// (ops/fdtd.center_fields with the 2D offsets, through
// ops/node_table2d.node_table_2d_plain) runs it on the card as 19 device
// operations a step (6 roll, 6 add, 6 mul, 1 stack), each a launch from
// Python over a 1 MB component grid at 512^2.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  E and B read once (24 B a node)
// and the (X, Y, 6) table written once (24 B): 48 B a node, 12.6 MB or
// 0.0038 ms at 512^2.  The arithmetic, 14 f32 operations a node, would take
// 1.5% of that time at the card's f32 rate.
//
// Design.  A CTA owns a tile of kTileX grid rows (axis 0) by kTileY cells
// (axis 1, contiguous) and builds its table in one pass: E and B come into
// shared memory once, over the tile and a halo of one row at x-1 and one
// cell at y-1, by cp.async.  The table of the tile is staged in shared
// memory and stored row by row, so that each 24-byte node lands beside the
// next and a warp writes one contiguous run.  Where Y is a multiple of 4
// and the grids are 16-byte aligned, the tile's cells move as 16-byte
// words, in and out, and the halo cells as floats; else every float alone.
// The periodic wrap is index arithmetic: a table of each staged row's and
// cell's grid index, so a grid of any size, ragged or smaller than the
// halo, is read right; stores are masked to the grid.  At 512^2: 64 x 8
// tiles, 512 CTAs of 26.7 KB, resident in one wave.
//
// Rounding: -fmad=false and center_fields' operation order with
// E_OFFSETS_2D / B_OFFSETS_2D: one average 0.5f * (c + c_prev) for each
// offset axis, in increasing axis order: Ex along x, Ey along y, Ez copied;
// Bx along y, By along x, Bz along x then along y of the x-averages.  So
// the kernel equals the plain version on the card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 8;   // grid rows (axis 0) a tile
constexpr int kTileY = 64;  // cells of a row (axis 1) a tile
static_assert(kTileY % 4 == 0, "the tile's cells move as 16-byte words");

// E or B in shared memory: grid rows x0-1 .. x0+kTileX-1 and cells y0-1 ..
// y0+kTileY-1, 3 floats a cell.  Each row starts at a multiple of 4 floats
// and one float of padding puts its cell y0 at a multiple of 4 too, so the
// tile's cells move as 16-byte words.
struct Region {
  static constexpr int kRows = kTileX + 1;
  static constexpr int kCells = kTileY + 1;
  static constexpr int kPad = 1;
  static constexpr int kStride = (kPad + 3 * kCells + 3) / 4 * 4;
  static constexpr int kFloats = kRows * kStride;
  // the float offset of cell q (q = 0 at y0 - 1) of row r (r = 0 at x0 - 1)
  __host__ __device__ static constexpr int at(int r, int q) {
    return r * kStride + kPad + 3 * q;
  }
};
static_assert(Region::at(0, 1) % 4 == 0 && Region::kStride % 4 == 0 &&
                  Region::kFloats % 4 == 0,
              "the tile's cells sit on 16-byte boundaries");
// the table of one tile row: kTileY nodes of 6 floats
constexpr int kOutStride = 6 * kTileY;
constexpr size_t kSharedBytes =
    (2 * Region::kFloats + kTileX * kOutStride + Region::kRows +
     Region::kCells) * 4;
static_assert(kSharedBytes <= 48 * 1024, "no opt-in to more shared memory");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The region of one grid into dst: row r from grid row xtab[r] (times Y),
// cell q from grid column ytab[q].  With vec the tile's cells come as
// 16-byte words and the halo cell as floats; else every float alone.
__device__ __forceinline__ void load_region(float* dst, const float* grid,
                                            const int* xtab, const int* ytab,
                                            int y0, bool vec) {
  if (vec) {
    constexpr int kVec = 3 * kTileY / 4;
    constexpr int kItems = kVec + 3;
    for (int t = threadIdx.x; t < Region::kRows * kItems; t += kThreads) {
      const int r = t / kItems;
      const int u = t - r * kItems;
      const float* src = grid + xtab[r] * 3;
      if (u < kVec)
        cp_async16(dst + Region::at(r, 1) + 4 * u, src + y0 * 3 + 4 * u);
      else
        cp_async4(dst + Region::at(r, 0) + u - kVec,
                  src + ytab[0] * 3 + u - kVec);
    }
    return;
  }
  constexpr int kRow = 3 * Region::kCells;
  for (int t = threadIdx.x; t < Region::kRows * kRow; t += kThreads) {
    const int r = t / kRow;
    const int i = t - r * kRow;
    const int q = i / 3;
    cp_async4(dst + Region::at(r, 0) + i,
              grid + (xtab[r] + ytab[q]) * 3 + i - 3 * q);
  }
}

// The tile's table into out (row r at r * kOutStride, node q at 6 q), from
// the staged E and B.  center_fields' averages, axis by axis.
__device__ __forceinline__ void table_tile(float* out, const float* e,
                                           const float* b) {
  for (int c = threadIdx.x; c < kTileX * kTileY; c += kThreads) {
    const int r = c / kTileY;
    const int q = c - r * kTileY;
    const int i = Region::at(r + 1, q + 1);
    const int ix = i - Region::kStride;
    const int iy = i - 3;
    const int ixy = ix - 3;
    float* o = out + r * kOutStride + 6 * q;
    o[0] = 0.5f * (e[i] + e[ix]);
    o[1] = 0.5f * (e[i + 1] + e[iy + 1]);
    o[2] = e[i + 2];
    o[3] = 0.5f * (b[i] + b[iy]);
    o[4] = 0.5f * (b[i + 1] + b[ix + 1]);
    o[5] = 0.5f * (0.5f * (b[i + 2] + b[ix + 2]) +
                   0.5f * (b[iy + 2] + b[ixy + 2]));
  }
}

// Rows r < rows and nodes q < cols of the staged table to the table at
// (x0 + r, y0 + q).
__device__ __forceinline__ void store_rows(float* table, const float* out,
                                           int rows, int cols, int x0, int y0,
                                           int Y, bool vec) {
  if (vec) {
    constexpr int kVec = kOutStride / 4;
    for (int t = threadIdx.x; t < rows * kVec; t += kThreads) {
      const int r = t / kVec;
      const int u = t - r * kVec;
      *reinterpret_cast<float4*>(table + ((x0 + r) * Y + y0) * 6 + 4 * u) =
          *reinterpret_cast<const float4*>(out + r * kOutStride + 4 * u);
    }
    return;
  }
  const int row = 6 * cols;
  for (int t = threadIdx.x; t < rows * row; t += kThreads) {
    const int r = t / row;
    const int i = t - r * row;
    table[((x0 + r) * Y + y0) * 6 + i] = out[r * kOutStride + i];
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// blockIdx.x: the (x, y) tile, y fastest.
__global__ void __launch_bounds__(kThreads)
    node_table2d_kernel(const float* __restrict__ e,
                        const float* __restrict__ b,
                        float* __restrict__ table, int X, int Y, int tiles_y,
                        int aligned) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                    // E
  float* bs = es + Region::kFloats;    // B
  float* os = bs + Region::kFloats;    // the tile's table
  int* xtab = reinterpret_cast<int*>(os + kTileX * kOutStride);
  int* ytab = xtab + Region::kRows;

  const int tx = blockIdx.x / tiles_y;
  const int x0 = tx * kTileX;
  const int y0 = (blockIdx.x - tx * tiles_y) * kTileY;
  const int rows = min(kTileX, X - x0), cols = min(kTileY, Y - y0);
  const bool vec = aligned && cols == kTileY;

  for (int i = threadIdx.x; i < Region::kRows + Region::kCells;
       i += kThreads) {
    if (i < Region::kRows)
      xtab[i] = wrap(x0 - 1 + i, X) * Y;
    else
      ytab[i - Region::kRows] = wrap(y0 - 1 + i - Region::kRows, Y);
  }
  __syncthreads();
  load_region(es, e, xtab, ytab, y0, vec);
  load_region(bs, b, xtab, ytab, y0, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  table_tile(os, es, bs);
  __syncthreads();
  store_rows(table, os, rows, cols, x0, y0, Y, vec);
}

}  // namespace

extern "C" {

// E and B: (X, Y, 3) float32, contiguous, on the current device; table:
// (X, Y, 6) float32, contiguous, distinct from both.  Returns a
// cudaError_t (0 on success).
int node_table2d(const float* e, const float* b, float* table, int X, int Y,
                 void* stream) {
  if (X < 1 || Y < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_y = (Y + kTileY - 1) / kTileY;
  const long long tiles =
      static_cast<long long>((X + kTileX - 1) / kTileX) * tiles_y;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte words where Y keeps every row 16-byte aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(e) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(table);
  const int aligned = Y % 4 == 0 && any % 16 == 0;
  node_table2d_kernel<<<static_cast<unsigned>(tiles), kThreads,
                        kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      e, b, table, X, Y, tiles_y, aligned);
  return static_cast<int>(cudaGetLastError());
}

const char* node_table2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
