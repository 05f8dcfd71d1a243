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
// Design.  A row's C channels of each corner move with the widest aligned
// vector the cell stride allows (12 channels: three float4 a corner; 6:
// three float2; 1: a scalar; any other count a scalar loop), the C outputs
// the same way.  NEAREST gives each of a row's vectors its own thread:
// thread t writes vector t of the output, so a warp's stores (and its loads
// of one cell's channels) are contiguous, and the row's ~40 integer and f32
// operations (tile id, origin, l, floor(l), the wrapped cell, in_win) are
// done by each of its threads.  CIC has four corners and their weights to
// work out, so one thread a row does them once (in variant timings on an
// H100 80GB HBM3 3 threads a row were the faster NEAREST form, 0.038 against
// 0.049 ms at 12 channels, and the slower CIC form, 0.050 against 0.041 at
// 6).  The periodic wraps are a conditional +-n (positions lie in [0, n),
// origins in [-margin, n)), with fmodf and % kept for values outside
// (-n, 2n), so every result is the one the plain version computes.  The TPU
// form (one-hot tent matmuls per block, a resident VMEM window set) stays
// behind.
//
// Arithmetic.  Built with -fmad=false and in the plain version's operation
// order (ops/sorted_gather.py), so values and in_win match it bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  Each row reads its position
// (8 B) and writes C values and in_win (4C + 1 B); the grid (4C B a cell)
// is read once at best.  At 1.18 M rows and C = 12 that is ~0.025 ms; the
// few f32 operations a value do not bind.  Measured on an H100 80GB HBM3
// (examples/kernel_pair.py, with its grid reads replaced by zeros for the
// second figure): C = 12 nearest 0.049 ms (50% of the bound), 0.031 without
// the reads; C = 1 0.013, 0.011 without: the fixed cost of a launch of 1.2 M
// threads; cic C = 6 0.043, 0.020 without: its 4 corners' 96 B a row from
// L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float floor_mod(float x, float n) {
  if (x >= 0.0f && x < n) return x;
  if (x >= n && x < 2.0f * n) return x - n;  // exact (Sterbenz)
  if (x < 0.0f && x > -n) return x + n;      // fmodf(x, n) is x here
  float r = fmodf(x, n);
  if (r != 0.0f && r < 0.0f) r += n;
  return r;
}

__device__ __forceinline__ int wrap(int i, int n) {
  i = i < 0 ? i + n : (i >= n ? i - n : i);
  if ((unsigned)i >= (unsigned)n) {  // i was outside [-n, 2n)
    i %= n;
    if (i < 0) i += n;
  }
  return i;
}

// A cell of kC channels as kN vectors of type T (kC = 0: n_c scalars)
template <int kC> struct Cell { using T = float; static constexpr int kN = 0; };
template <> struct Cell<1> { using T = float; static constexpr int kN = 1; };
template <> struct Cell<6> { using T = float2; static constexpr int kN = 3; };
template <> struct Cell<12> { using T = float4; static constexpr int kN = 3; };

__device__ __forceinline__ float cic(float ar0, float ar1, float az0,
                                     float az1, float w00, float w10,
                                     float w01, float w11) {
  return az0 * (ar0 * w00 + ar1 * w10) + az1 * (ar0 * w01 + ar1 * w11);
}

__device__ __forceinline__ float2 cic(float ar0, float ar1, float az0,
                                      float az1, float2 w00, float2 w10,
                                      float2 w01, float2 w11) {
  return make_float2(cic(ar0, ar1, az0, az1, w00.x, w10.x, w01.x, w11.x),
                     cic(ar0, ar1, az0, az1, w00.y, w10.y, w01.y, w11.y));
}

__device__ __forceinline__ float4 cic(float ar0, float ar1, float az0,
                                      float az1, float4 w00, float4 w10,
                                      float4 w01, float4 w11) {
  return make_float4(cic(ar0, ar1, az0, az1, w00.x, w10.x, w01.x, w11.x),
                     cic(ar0, ar1, az0, az1, w00.y, w10.y, w01.y, w11.y),
                     cic(ar0, ar1, az0, az1, w00.z, w10.z, w01.z, w11.z),
                     cic(ar0, ar1, az0, az1, w00.w, w10.w, w01.w, w11.w));
}

template <int kC, int kLanes>
__global__ void __launch_bounds__(kThreads)
gather2d_kernel(const float* __restrict__ grid, const float2* __restrict__ pos,
                const int* __restrict__ tile_id, float* __restrict__ out,
                unsigned char* __restrict__ in_win, int n_rows, int n_c,
                int block, int nr, int nz, int ntz, int tile_r, int tile_z,
                int margin, int cic_mode) {
  using T = typename Cell<kC>::T;
  constexpr int kN = Cell<kC>::kN;  // kLanes threads a row share its vectors
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)n_rows * kLanes) return;
  const int row = (int)(e / kLanes);
  const int m0 = (int)(e - (int64_t)row * kLanes);  // its first vector
  const int nc = kC ? kC : n_c;
  const int wr = tile_r + 2 * margin + 1;
  const int wz = tile_z + 2 * margin + 1;
  const int t = tile_id[(row / block) * block];
  const int tr = t / ntz;
  const int org_r = tr * tile_r - margin;
  const int org_z = (t - tr * ntz) * tile_z - margin;
  const float2 p = pos[row];
  const float lr = floor_mod(p.x - (float)org_r, (float)nr);
  const float lz = floor_mod(p.y - (float)org_z, (float)nz);
  const float fi = floorf(lr), fj = floorf(lz);
  const int i = (int)fi, j = (int)fj;
  const int gi = wrap(org_r + i, nr), gj = wrap(org_z + j, nz);
  const float* c00 = grid + ((int64_t)gi * nz + gj) * nc;
  float* dst = out + (int64_t)row * nc;

  if (!cic_mode) {
    const bool inside = i < wr && j < wz;
    if constexpr (kN > 0) {
#pragma unroll
      for (int m = m0; m < kN; m += kLanes) {
        reinterpret_cast<T*>(dst)[m] =
            inside ? __ldg(reinterpret_cast<const T*>(c00) + m) : T{};
      }
    } else {
      for (int c = 0; c < nc; ++c) dst[c] = inside ? __ldg(c00 + c) : 0.0f;
    }
  } else {
    const int gi1 = wrap(org_r + i + 1, nr), gj1 = wrap(org_z + j + 1, nz);
    const float ar0 = i < wr ? 1.0f - (lr - fi) : 0.0f;
    const float ar1 = i + 1 < wr ? 1.0f - ((fi + 1.0f) - lr) : 0.0f;
    const float az0 = j < wz ? 1.0f - (lz - fj) : 0.0f;
    const float az1 = j + 1 < wz ? 1.0f - ((fj + 1.0f) - lz) : 0.0f;
    const float* c10 = grid + ((int64_t)gi1 * nz + gj) * nc;
    const float* c01 = grid + ((int64_t)gi * nz + gj1) * nc;
    const float* c11 = grid + ((int64_t)gi1 * nz + gj1) * nc;
    if constexpr (kN > 0) {
#pragma unroll
      for (int m = m0; m < kN; m += kLanes) {
        reinterpret_cast<T*>(dst)[m] = cic(
            ar0, ar1, az0, az1, __ldg(reinterpret_cast<const T*>(c00) + m),
            __ldg(reinterpret_cast<const T*>(c10) + m),
            __ldg(reinterpret_cast<const T*>(c01) + m),
            __ldg(reinterpret_cast<const T*>(c11) + m));
      }
    } else {
      for (int c = 0; c < nc; ++c) {
        dst[c] = cic(ar0, ar1, az0, az1, __ldg(c00 + c), __ldg(c10 + c),
                     __ldg(c01 + c), __ldg(c11 + c));
      }
    }
  }
  if (m0 == 0) {
    const int dr = wrap((int)floorf(p.x) - org_r, nr);
    const int dz = wrap((int)floorf(p.y) - org_z, nz);
    in_win[row] = (dr < wr - 1 && dz < wz - 1) ? 1 : 0;
  }
}

template <int kC, int kLanes>
int launch_lanes(const void* grid, const void* pos, const void* tile_id,
                 void* out, void* in_win, int n_rows, int n_c, int block,
                 int nr, int nz, int ntz, int tile_r, int tile_z, int margin,
                 int cic_mode, cudaStream_t stream) {
  const int grid_dim = (int)(((int64_t)n_rows * kLanes - 1) / kThreads + 1);
  gather2d_kernel<kC, kLanes><<<grid_dim, kThreads, 0, stream>>>(
      (const float*)grid, (const float2*)pos, (const int*)tile_id,
      (float*)out, (unsigned char*)in_win, n_rows, n_c, block, nr, nz, ntz,
      tile_r, tile_z, margin, cic_mode);
  return (int)cudaGetLastError();
}

// NEAREST: a thread for each vector of a row; CIC: a thread a row
template <int kC>
int launch(const void* grid, const void* pos, const void* tile_id, void* out,
           void* in_win, int n_rows, int n_c, int block, int nr, int nz,
           int ntz, int tile_r, int tile_z, int margin, int cic_mode,
           cudaStream_t stream) {
  constexpr int kN = Cell<kC>::kN > 0 ? Cell<kC>::kN : 1;
  if (cic_mode) {
    return launch_lanes<kC, 1>(grid, pos, tile_id, out, in_win, n_rows, n_c,
                               block, nr, nz, ntz, tile_r, tile_z, margin,
                               cic_mode, stream);
  }
  return launch_lanes<kC, kN>(grid, pos, tile_id, out, in_win, n_rows, n_c,
                              block, nr, nz, ntz, tile_r, tile_z, margin,
                              cic_mode, stream);
}

}  // namespace

// Launches the gather on `stream`; returns cudaGetLastError() after the
// launch.  Device pointers: grid (nr, nz, n_c) f32, pos (n_rows, 2) f32 in
// grid units, tile_id (n_rows,) int32, out (n_rows, n_c) f32, in_win
// (n_rows,) bytes.  n_rows is a multiple of block and nr * nz < 2^31; cic is
// 0 (nearest) or 1.  The vector forms need grid and out aligned to their
// vector (16 bytes for 12 channels, 8 for 6); others take the scalar loop.
extern "C" int gather2d(const void* grid, const void* pos, const void* tile_id,
                        void* out, void* in_win, int n_rows, int n_c,
                        int block, int nr, int nz, int ntz, int tile_r,
                        int tile_z, int margin, int cic, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)grid | (uintptr_t)out;
  if (n_c == 12 && align % 16 == 0) {
    return launch<12>(grid, pos, tile_id, out, in_win, n_rows, n_c, block, nr,
                      nz, ntz, tile_r, tile_z, margin, cic, st);
  }
  if (n_c == 6 && align % 8 == 0) {
    return launch<6>(grid, pos, tile_id, out, in_win, n_rows, n_c, block, nr,
                     nz, ntz, tile_r, tile_z, margin, cic, st);
  }
  if (n_c == 1) {
    return launch<1>(grid, pos, tile_id, out, in_win, n_rows, n_c, block, nr,
                     nz, ntz, tile_r, tile_z, margin, cic, st);
  }
  return launch<0>(grid, pos, tile_id, out, in_win, n_rows, n_c, block, nr,
                   nz, ntz, tile_r, tile_z, margin, cic, st);
}

extern "C" const char* gather2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
