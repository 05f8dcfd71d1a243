// The node-centred E|B table of the 3D EM shells in one launch, Hopper.
//
// Replaces: no Pallas kernel.  The reference builds the table with the XLA
// composition center_fields (fusion_sim_tpu/ops/fdtd.py:115): each staggered
// component averaged with its rolled neighbour along each axis it is offset
// on, then the six columns stacked.  The port's plain version
// (ops/fdtd.center_fields, through ops/node_table3d.node_table_3d_plain)
// runs it on the card as 34 device operations a step, nine rolls, the
// averages and a stack that interleaves six 8 MB columns of a 128^3 grid.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  E and B read once (24 B a node)
// and the (X, Y, Z, 6) table written once (24 B): 48 B a node, 100.7 MB or
// 0.0300 ms at 128^3.  The arithmetic, 24 f32 operations a node, would take
// 1.5% of that time at the card's f32 rate.
//
// Design.  A CTA owns a tile of kTileY grid rows by kTileZ cells of the
// (y, z) plane over a run of x planes and marches along x, one plane an
// iteration.  Each plane of E and of B comes into shared memory once, over
// the tile and a halo of one row at y-1 and one cell at z-1, and stays
// there for the next iteration, which averages Ex, By and Bz with it along
// x: so E and B are read from device memory once, but for the halo and the
// one plane before each run.  The copies are cp.async into a ring of three
// planes, the next plane in flight while one is averaged.  The table of a
// plane is staged in shared memory and stored row by row, so that each
// 24-byte node lands beside the next and a warp writes one contiguous run.
// Where Z is a multiple of 4 and the grids are 16-byte aligned, the tile's
// cells move as 16-byte words, in and out, and the halo cells as floats;
// else every float alone.  The periodic wrap is index arithmetic: a table of
// each halo row's and column's grid index, so a grid of any size, ragged or
// smaller than the tile, is read right; stores are masked to the grid.  The
// runs are as long as fills the card's resident CTAs once (at 128^3: 32
// tiles x 16 runs of 8 planes, 4 CTAs an SM).
//
// Measured on an H100 80GB HBM3 (700 W) at 128^3, median of 10-20
// launches: 0.0452-0.0455 ms, 66% of the bound; the plain version 0.70 ms.
//
// Why a launch of its own.  Y1 (csrc/yee3d.cu) holds each tile's new E and
// B in shared memory, but a table written in its epilogue would save only
// the re-read of E and B (24 B a node, ~0.015 ms at 128^3) and one launch:
// it needs the new fields at y-1 and z-1, halo cells that Y1 does not
// compute.  B6 (csrc/em3d_substep.cu) reads the table, but runs at its
// 80-register cap.
//
// Rounding: -fmad=false and center_fields' operation order: one average
// 0.5f * (c + c_prev) for each offset axis, in increasing axis order: Ex
// along x, Ey along y, Ez along z; Bx along y then along z of the
// y-averages, By along x then z, Bz along x then y.  So the kernel equals
// the plain version on the card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileY = 8;
constexpr int kTileZ = 64;
static_assert(kTileZ % 4 == 0, "the tile's cells move as 16-byte words");

// One x plane of E or B in shared memory: grid rows y0-1 .. y0+kTileY-1 and
// cells z0-1 .. z0+kTileZ-1, 3 floats a cell.  Each row starts at a
// multiple of 4 floats and one float of padding puts its cell z0 at a
// multiple of 4 too, so the tile's cells move as 16-byte words.
struct Region {
  static constexpr int kRows = kTileY + 1;
  static constexpr int kCells = kTileZ + 1;
  static constexpr int kPad = 1;
  static constexpr int kStride = (kPad + 3 * kCells + 3) / 4 * 4;
  static constexpr int kFloats = kRows * kStride;
  // the float offset of cell q (q = 0 at z0 - 1) of row r (r = 0 at y0 - 1)
  __host__ __device__ static constexpr int at(int r, int q) {
    return r * kStride + kPad + 3 * q;
  }
};
static_assert(Region::at(0, 1) % 4 == 0 && Region::kStride % 4 == 0 &&
                  Region::kFloats % 4 == 0,
              "the tile's cells sit on 16-byte boundaries");
// the table of one tile row: kTileZ nodes of 6 floats
constexpr int kOutStride = 6 * kTileZ;
constexpr size_t kSharedBytes =
    (6 * Region::kFloats + kTileY * kOutStride + Region::kRows +
     Region::kCells) * 4;

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

// The region of one grid plane into dst: row r from grid row ytab[r] (times
// Z), cell q from grid column ztab[q].  With vec the tile's cells come as
// 16-byte words and the halo cell as floats; else every float alone.
__device__ __forceinline__ void load_region(float* dst, const float* plane,
                                            const int* ytab, const int* ztab,
                                            int z0, bool vec) {
  if (vec) {
    constexpr int kVec = 3 * kTileZ / 4;
    constexpr int kItems = kVec + 3;
    for (int t = threadIdx.x; t < Region::kRows * kItems; t += kThreads) {
      const int r = t / kItems;
      const int u = t - r * kItems;
      const float* src = plane + ytab[r] * 3;
      if (u < kVec)
        cp_async16(dst + Region::at(r, 1) + 4 * u, src + z0 * 3 + 4 * u);
      else
        cp_async4(dst + Region::at(r, 0) + u - kVec,
                  src + ztab[0] * 3 + u - kVec);
    }
    return;
  }
  constexpr int kRow = 3 * Region::kCells;
  for (int t = threadIdx.x; t < Region::kRows * kRow; t += kThreads) {
    const int r = t / kRow;
    const int i = t - r * kRow;
    const int q = i / 3;
    cp_async4(dst + Region::at(r, 0) + i,
              plane + (ytab[r] + ztab[q]) * 3 + i - 3 * q);
  }
}

// The tile's table at plane x into out (row r at r * kOutStride, node q at
// 6 q), from E and B at x (ec, bc) and at x - 1 (ep, bp).  center_fields'
// averages, axis by axis.
__device__ __forceinline__ void table_plane(float* out, const float* ec,
                                            const float* ep, const float* bc,
                                            const float* bp) {
  for (int c = threadIdx.x; c < kTileY * kTileZ; c += kThreads) {
    const int r = c / kTileZ;
    const int q = c - r * kTileZ;
    const int i = Region::at(r + 1, q + 1);
    const int iy = i - Region::kStride;
    const int iz = i - 3;
    const int iyz = iy - 3;
    float* o = out + r * kOutStride + 6 * q;
    o[0] = 0.5f * (ec[i] + ep[i]);
    o[1] = 0.5f * (ec[i + 1] + ec[iy + 1]);
    o[2] = 0.5f * (ec[i + 2] + ec[iz + 2]);
    o[3] = 0.5f * (0.5f * (bc[i] + bc[iy]) + 0.5f * (bc[iz] + bc[iyz]));
    o[4] = 0.5f * (0.5f * (bc[i + 1] + bp[i + 1]) +
                   0.5f * (bc[iz + 1] + bp[iz + 1]));
    o[5] = 0.5f * (0.5f * (bc[i + 2] + bp[i + 2]) +
                   0.5f * (bc[iy + 2] + bp[iy + 2]));
  }
}

// Rows r < rows and nodes q < cols of the staged table to the table's plane
// at (y0 + r, z0 + q).
__device__ __forceinline__ void store_rows(float* plane, const float* out,
                                           int rows, int cols, int y0, int z0,
                                           int Z, bool vec) {
  if (vec) {
    constexpr int kVec = kOutStride / 4;
    for (int t = threadIdx.x; t < rows * kVec; t += kThreads) {
      const int r = t / kVec;
      const int u = t - r * kVec;
      *reinterpret_cast<float4*>(plane + ((y0 + r) * Z + z0) * 6 + 4 * u) =
          *reinterpret_cast<const float4*>(out + r * kOutStride + 4 * u);
    }
    return;
  }
  const int row = 6 * cols;
  for (int t = threadIdx.x; t < rows * row; t += kThreads) {
    const int r = t / row;
    const int i = t - r * row;
    plane[((y0 + r) * Z + z0) * 6 + i] = out[r * kOutStride + i];
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// blockIdx.x: the (y, z) tile, z fastest; blockIdx.y: the run of x planes.
__global__ void __launch_bounds__(kThreads)
    node_table3d_kernel(const float* __restrict__ e,
                        const float* __restrict__ b,
                        float* __restrict__ table, int X, int Y, int Z,
                        int run_len, int tiles_z, int aligned) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kR = Region::kFloats;
  float* es = smem;         // 3 E planes
  float* bs = es + 3 * kR;  // 3 B planes
  float* os = bs + 3 * kR;  // the tile's table of one plane
  int* ytab = reinterpret_cast<int*>(os + kTileY * kOutStride);
  int* ztab = ytab + Region::kRows;

  const int ty = blockIdx.x / tiles_z;
  const int y0 = ty * kTileY;
  const int z0 = (blockIdx.x - ty * tiles_z) * kTileZ;
  const int x0 = blockIdx.y * run_len;
  const int end = min(x0 + run_len, X);
  const int rows = min(kTileY, Y - y0), cols = min(kTileZ, Z - z0);
  const bool vec = aligned && cols == kTileZ;
  const long long plane = static_cast<long long>(Y) * Z * 3;

  for (int i = threadIdx.x; i < Region::kRows + Region::kCells;
       i += kThreads) {
    if (i < Region::kRows)
      ytab[i] = wrap(y0 - 1 + i, Y) * Z;
    else
      ztab[i - Region::kRows] = wrap(z0 - 1 + i - Region::kRows, Z);
  }
  __syncthreads();
  auto at = [&](const float* g, int x) { return g + wrap(x, X) * plane; };

  load_region(es, at(e, x0 - 1), ytab, ztab, z0, vec);
  load_region(bs, at(b, x0 - 1), ytab, ztab, z0, vec);
  load_region(es + kR, at(e, x0), ytab, ztab, z0, vec);
  load_region(bs + kR, at(b, x0), ytab, ztab, z0, vec);
  cp_async_commit();

  // iteration it writes plane s = x0 + it: E and B at s in slot (it + 1) % 3
  // of each ring, at s - 1 in slot it % 3
  for (int it = 0, s = x0; s < end; ++it, ++s) {
    const int kp = it % 3, kc = (it + 1) % 3, kn = (it + 2) % 3;
    cp_async_wait_all();
    __syncthreads();
    // the next plane, into the slot that iteration it - 1 finished with
    if (s + 1 < end) {
      load_region(es + kn * kR, at(e, s + 1), ytab, ztab, z0, vec);
      load_region(bs + kn * kR, at(b, s + 1), ytab, ztab, z0, vec);
    }
    cp_async_commit();
    table_plane(os, es + kc * kR, es + kp * kR, bs + kc * kR, bs + kp * kR);
    __syncthreads();
    store_rows(table + static_cast<long long>(s) * plane * 2, os, rows, cols,
               y0, z0, Z, vec);
  }
}

struct Launch {
  int sms = 0, per_sm = 0;
};

Launch launch_shape(int device) {
  static Launch cache[64];
  if (device < 0 || device >= 64) return Launch{};
  Launch& l = cache[device];
  if (l.sms == 0) {
    cudaFuncSetAttribute(node_table3d_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSharedBytes));
    int sms = 0, per = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, node_table3d_kernel,
                                                  kThreads, kSharedBytes);
    l.sms = sms;
    l.per_sm = per;
  }
  return l;
}

}  // namespace

extern "C" {

// E and B: (X, Y, Z, 3) float32, contiguous, on the current device; table:
// (X, Y, Z, 6) float32, contiguous, distinct from both.  Returns a
// cudaError_t (0 on success).
int node_table3d(const float* e, const float* b, float* table, int X, int Y,
                 int Z, void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch l = launch_shape(device);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l.sms <= 0 || l.per_sm <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_z = (Z + kTileZ - 1) / kTileZ;
  const long long tiles =
      static_cast<long long>((Y + kTileY - 1) / kTileY) * tiles_z;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // runs of x planes: as many as fill the card's resident CTAs once
  long long runs = static_cast<long long>(l.sms) * l.per_sm / tiles;
  runs = runs < 1 ? 1 : (runs > X ? X : runs);
  const int run_len = static_cast<int>((X + runs - 1) / runs);
  runs = (X + run_len - 1) / run_len;
  if (runs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte words where Z keeps every row and plane 16-byte aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(e) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(table);
  const int aligned = Z % 4 == 0 && any % 16 == 0;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(runs));
  node_table3d_kernel<<<grid, kThreads, kSharedBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      e, b, table, X, Y, Z, run_len, tiles_z, aligned);
  return static_cast<int>(cudaGetLastError());
}

const char* node_table3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
