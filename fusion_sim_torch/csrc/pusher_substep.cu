// One fused half-step of the tile-sorted grid-parity pusher, Hopper.
//
// Replaces: fusion_sim_tpu/ops/pallas_pusher.py : fused_pusher_substep
//           (_pusher_kernel, windows from build_pusher_windows).
//
// Per row of the padded tile-sorted layout (models/pusher_sorted.py), with
// origin = the row's block tile corner minus the margin:
//   1. the NEAREST/CLAMP sample cell (r*nr, z*nz) clamped to the grid
//      (_cell_coords), and its window-local coordinate l = mod(cell -
//      origin, n); the 12 coefficient channels R1|R2|R3|A at window cell
//      floor(l), i.e. grid cell (origin + floor(l)) mod n;
//   2. the cylindrical Boris rotation, in the reference's operation order
//      (rows[0]*vr + rows[1]*va + rows[2]*vz + rows[9], ...);
//   3. rows with alive <= 0.5 instead take the thermal re-init
//      0.001 * (2 u - 1) from rand[:, :3];
//   4. the drift x' = x + step_factor * v';
//   5. the sink channel (12) at the drifted cell, whose window coordinate
//      is clip(cell') - origin with NO periodic wrap (the reference forms
//      the two samples differently; both are kept);
//   6. a row whose first sample (wrapped) or second sample (unwrapped)
//      leaves the window comes back frozen at its inputs with sink = 1 and
//      in_win = 0; the model re-pushes it exactly (its spill patch).
// Every index is wrapped into the table, so the trailing sentinel-tile
// blocks (tile id n_tiles) never read past it.
//
// Design.  One thread per row.  The TPU's streamed per-tile windows, its
// exact 3-way bf16 split and its channel-stacked MXU matmuls stay behind: a
// NEAREST sample from a tile window is a plain f32 load, so the kernel
// loads the 13 channels straight from the packed (nr, nz, 13) table, which
// at 400 x 800 (16.6 MB) stays in the H100's 50 MB L2.  rand is read only
// for fresh rows (alive <= 0.5).  Staging windows in shared memory is left
// to later work.
//
// Arithmetic.  Built with -fmad=false, with IEEE sqrt and division, and in
// the operation order of the plain PyTorch version (ops/fused_pusher.py),
// so positions, velocities, sink and in_win match it bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  Per row: position, velocity,
// alive read (28 B), position, velocity, sink, in_win written (29 B), plus
// 12 B of rand for each fresh row; about 0.30 ms a launch at 17.2 M rows,
// against ~60 f32 operations a row (~0.02 ms at 67 TFLOP/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 13;

__device__ __forceinline__ float floor_mod(float x, float n) {
  float r = fmodf(x, n);
  if (r != 0.0f && r < 0.0f) r += n;
  return r;
}

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// clip(x, lo, hi) as jnp.clip/torch.clamp: NaN stays NaN
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
pusher_substep_kernel(const float* __restrict__ table,
                      const float* __restrict__ pos,
                      const float* __restrict__ vel,
                      const float* __restrict__ alive,
                      const float4* __restrict__ rand,
                      const int* __restrict__ tile_id,
                      float* __restrict__ pos_out, float* __restrict__ vel_out,
                      float* __restrict__ sink_out,
                      unsigned char* __restrict__ in_win, int n_rows,
                      int block, int nr, int nz, int ntz, int tile_r,
                      int tile_z, int margin, float cell_hi_r,
                      float cell_hi_z, float step_factor) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int t = tile_id[(row / block) * block];
  const int org_r = (t / ntz) * tile_r - margin;
  const int org_z = (t % ntz) * tile_z - margin;
  const float org_rf = (float)org_r, org_zf = (float)org_z;
  const float nr_f = (float)nr, nz_f = (float)nz;
  const float wr1 = (float)(tile_r + 2 * margin);  // wr - 1
  const float wz1 = (float)(tile_z + 2 * margin);  // wz - 1

  const int64_t b3 = (int64_t)row * 3;
  const float x = pos[b3], y = pos[b3 + 1], z = pos[b3 + 2];
  const float vx = vel[b3], vy = vel[b3 + 1], vz = vel[b3 + 2];
  float ox = x, oy = y, oz = z, ovx = vx, ovy = vy, ovz = vz, sink = 1.0f;
  bool inw = false;

  const float r = sqrtf(x * x + y * y);
  const float lcr = floor_mod(clip(r * nr_f, 0.0f, cell_hi_r) - org_rf, nr_f);
  const float lcz = floor_mod(clip(z * nz_f, 0.0f, cell_hi_z) - org_zf, nz_f);
  if (lcr >= 0.0f && lcr < wr1 && lcz >= 0.0f && lcz < wz1) {
    float nvx, nvy, nvz;
    if (alive[row] <= 0.5f) {
      const float4 u = rand[row];
      nvx = 0.001f * (2.0f * u.x - 1.0f);
      nvy = 0.001f * (2.0f * u.y - 1.0f);
      nvz = 0.001f * (2.0f * u.z - 1.0f);
    } else {
      const float* c =
          table + ((int64_t)wrap(org_r + (int)floorf(lcr), nr) * nz +
                   wrap(org_z + (int)floorf(lcz), nz)) * kChannels;
      const float dir_x = x / r;
      const float dir_y = y / r;
      const float vr = vx * dir_x + vy * dir_y;
      const float va = vy * dir_x - vx * dir_y;
      const float rot_r = c[0] * vr + c[1] * va + c[2] * vz + c[9];
      const float rot_a = c[3] * vr + c[4] * va + c[5] * vz + c[10];
      const float rot_z = c[6] * vr + c[7] * va + c[8] * vz + c[11];
      nvx = rot_r * dir_x - rot_a * dir_y;
      nvy = rot_r * dir_y + rot_a * dir_x;
      nvz = rot_z;
    }
    const float nx = x + step_factor * nvx;
    const float ny = y + step_factor * nvy;
    const float nzp = z + step_factor * nvz;
    const float nrad = sqrtf(nx * nx + ny * ny);
    const float cu = clip(nrad * nr_f, 0.0f, cell_hi_r) - org_rf;
    const float cv = clip(nzp * nz_f, 0.0f, cell_hi_z) - org_zf;
    if (cu >= 0.0f && cu < wr1 && cv >= 0.0f && cv < wz1) {
      inw = true;
      sink = table[((int64_t)wrap(org_r + (int)floorf(cu), nr) * nz +
                    wrap(org_z + (int)floorf(cv), nz)) * kChannels + 12];
      ox = nx; oy = ny; oz = nzp;
      ovx = nvx; ovy = nvy; ovz = nvz;
    }
  }
  pos_out[b3] = ox; pos_out[b3 + 1] = oy; pos_out[b3 + 2] = oz;
  vel_out[b3] = ovx; vel_out[b3 + 1] = ovy; vel_out[b3 + 2] = ovz;
  sink_out[row] = sink;
  in_win[row] = inw ? 1 : 0;
}

}  // namespace

// Launches the half-step on `stream`; returns cudaGetLastError() after the
// launch.  Device pointers: table (nr, nz, 13) f32, pos/vel/pos_out/vel_out
// (n_rows, 3) f32, alive/sink_out (n_rows,) f32, rand (n_rows, 4) f32,
// tile_id (n_rows,) int32, in_win (n_rows,) bytes.  n_rows is a multiple of
// block; cell_hi_* = f32(n - 1e-3) are the clamp bounds of _cell_coords.
extern "C" int pusher_substep(const void* table, const void* pos,
                              const void* vel, const void* alive,
                              const void* rand, const void* tile_id,
                              void* pos_out, void* vel_out, void* sink_out,
                              void* in_win, int n_rows, int block, int nr,
                              int nz, int ntz, int tile_r, int tile_z,
                              int margin, float cell_hi_r, float cell_hi_z,
                              float step_factor, void* stream) {
  if (n_rows == 0) return 0;
  const int grid = (n_rows + kThreads - 1) / kThreads;
  pusher_substep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)pos, (const float*)vel,
      (const float*)alive, (const float4*)rand, (const int*)tile_id,
      (float*)pos_out, (float*)vel_out, (float*)sink_out,
      (unsigned char*)in_win, n_rows, block, nr, nz, ntz, tile_r, tile_z,
      margin, cell_hi_r, cell_hi_z, step_factor);
  return (int)cudaGetLastError();
}

extern "C" const char* pusher_substep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
