// Windowed gather of C grid channels for tile-sorted particles, Hopper.
//
// Replaces: fusion_sim_tpu/ops/pallas_gather.py : gather_sorted_2d_pallas
//           (_gather2d_kernel).
//
// Per row of the padded tile-sorted layout (ops/sorted_deposit.py), in its
// block's window-local frame l = mod(x - origin, n) (origin = the block's
// tile corner minus the margin):
//   nearest: the window cell floor(l), if it lies in the window, else 0;
//   cic:     tents max(0, 1 - |l - i|) at floor(l) and floor(l) + 1, each
//            corner counted only inside the window, summed r first and then
//            z (the reference's matmul order):
//              az0 * (ar0 W00 + ar1 W10) + az1 * (ar0 W01 + ar1 W11);
//   in_win:  floor(x) - origin (integer, periodic) inside the window
//            (rows outside it get values the caller replaces).
// A window cell (a, b) is the grid cell ((origin_r + a) mod nr,
// (origin_z + b) mod nz), so the kernel reads the grid directly and never
// materializes windows; every index is wrapped, so sentinel-tile blocks
// (tile id n_tiles) read inside the grid too.
//
// Design.  One thread per (row, channel): neighbouring threads read
// neighbouring channels of one grid cell and write neighbouring outputs, so
// the (N, C) output and the cell's channels move in coalesced runs; the
// row's position and tile id are re-read per channel from L1.  The TPU form
// (one-hot tent matmuls per block, a resident VMEM window set) stays behind.
//
// Arithmetic.  Built with -fmad=false and in the plain version's operation
// order (ops/sorted_gather.py), so values and in_win match it bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  Each row reads its position
// (8 B) and writes C values and in_win (4C + 1 B); the grid (4C B a cell)
// is read once at best.  At 1.18 M rows and C = 12 that is ~0.02 ms; the
// few f32 operations a value do not bind.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float floor_mod(float x, float n) {
  float r = fmodf(x, n);
  if (r != 0.0f && r < 0.0f) r += n;
  return r;
}

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads)
gather2d_kernel(const float* __restrict__ grid, const float2* __restrict__ pos,
                const int* __restrict__ tile_id, float* __restrict__ out,
                unsigned char* __restrict__ in_win, int n_rows, int n_c,
                int block, int nr, int nz, int ntz, int tile_r, int tile_z,
                int margin, int cic) {
  // 32-bit indices: the wrapper checks n_rows * n_c < 2^31
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_rows * n_c) return;
  const int row = e / n_c;
  const int c = e - row * n_c;
  const int wr = tile_r + 2 * margin + 1;
  const int wz = tile_z + 2 * margin + 1;
  const int t = tile_id[(row / block) * block];
  const int org_r = (t / ntz) * tile_r - margin;
  const int org_z = (t % ntz) * tile_z - margin;
  const float2 p = pos[row];
  const float lr = floor_mod(p.x - (float)org_r, (float)nr);
  const float lz = floor_mod(p.y - (float)org_z, (float)nz);
  const float fi = floorf(lr), fj = floorf(lz);
  const int i = (int)fi, j = (int)fj;
  const int gi = wrap(org_r + i, nr), gj = wrap(org_z + j, nz);

  float val;
  if (!cic) {
    val = (i < wr && j < wz) ? grid[((int64_t)gi * nz + gj) * n_c + c] : 0.0f;
  } else {
    const int gi1 = wrap(org_r + i + 1, nr), gj1 = wrap(org_z + j + 1, nz);
    const float ar0 = i < wr ? 1.0f - (lr - fi) : 0.0f;
    const float ar1 = i + 1 < wr ? 1.0f - ((fi + 1.0f) - lr) : 0.0f;
    const float az0 = j < wz ? 1.0f - (lz - fj) : 0.0f;
    const float az1 = j + 1 < wz ? 1.0f - ((fj + 1.0f) - lz) : 0.0f;
    const float w00 = grid[((int64_t)gi * nz + gj) * n_c + c];
    const float w10 = grid[((int64_t)gi1 * nz + gj) * n_c + c];
    const float w01 = grid[((int64_t)gi * nz + gj1) * n_c + c];
    const float w11 = grid[((int64_t)gi1 * nz + gj1) * n_c + c];
    val = az0 * (ar0 * w00 + ar1 * w10) + az1 * (ar0 * w01 + ar1 * w11);
  }
  out[e] = val;
  if (c == 0) {
    const int dr = wrap((int)floorf(p.x) - org_r, nr);
    const int dz = wrap((int)floorf(p.y) - org_z, nz);
    in_win[row] = (dr < wr - 1 && dz < wz - 1) ? 1 : 0;
  }
}

}  // namespace

// Launches the gather on `stream`; returns cudaGetLastError() after the
// launch.  Device pointers: grid (nr, nz, n_c) f32, pos (n_rows, 2) f32 in
// grid units, tile_id (n_rows,) int32, out (n_rows, n_c) f32, in_win
// (n_rows,) bytes.  n_rows is a multiple of block and n_rows * n_c < 2^31;
// cic is 0 (nearest) or 1.
extern "C" int gather2d(const void* grid, const void* pos, const void* tile_id,
                        void* out, void* in_win, int n_rows, int n_c,
                        int block, int nr, int nz, int ntz, int tile_r,
                        int tile_z, int margin, int cic, void* stream) {
  const int total = n_rows * n_c;
  if (total == 0) return 0;
  const int grid_dim = (total - 1) / kThreads + 1;
  gather2d_kernel<<<grid_dim, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)grid, (const float2*)pos, (const int*)tile_id,
      (float*)out, (unsigned char*)in_win, n_rows, n_c, block, nr, nz, ntz,
      tile_r, tile_z, margin, cic);
  return (int)cudaGetLastError();
}

extern "C" const char* gather2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
