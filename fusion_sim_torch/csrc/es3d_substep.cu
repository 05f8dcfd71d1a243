// Fused 3D electrostatic PIC substep for tile-sorted particles, Hopper.
//
// Replaces: fusion_sim_tpu/ops/pallas_pic3d.py : fused_es3d_substep
//           (_es3d_kernel, _local_coords_3d, the flat tile windows and
//           their fold).
//
// Per particle row of the padded tile-sorted 3D layout
// (ops/sorted_deposit.py), in its block's window-local frame
// l = mod(x - origin, n) per axis:
//   CIC gather of E (3 channels, 8 corners) from the block's tile window,
//   kick v' = v + qm_dt * E (v' = 0 for a weight-0 row), drift l' = l + c * v',
//   CIC deposit of the weight at l' into rho,
//   wrap back to global periodic coordinates and flag in_win.
// A row whose l (upper bounds only: l is a mod) or l' (both bounds) leaves
// [0, w - 1) on any axis comes back frozen (position mod(l + origin, n),
// velocity as given) with no deposit; the model re-pushes it exactly (spill
// patch).  Rows of blocks carrying the sentinel tile id (n_tiles) have no
// window: they come back exactly as given, in_win = 0.
//
// Design.  One CTA of kThreads threads walks consecutive particle blocks,
// kRowsPerCta rows of them (8 blocks of 512).  A particle block lies in one
// tile and consecutive blocks usually share it, so the CTA stages the tile's
// E window ((wx, wy, wz, 3) f32: 26.4 KB at tile 8 / margin 2) straight from
// e_grid with periodic wrap into shared memory once per tile run, gathers the
// 8 corners from it, and accumulates the run's deposit in a shared (wx, wy,
// wz) f32 window (8.8 KB) with shared-memory atomics.  When the tile changes
// (and at the end) the window is flushed onto the periodic grid with one
// global atomicAdd per nonzero cell: rho comes out on the grid, so the
// reference's (n_tiles + 1) per-tile buffer, its `present` mask and its fold
// pass are not needed.  Shared memory is sized from the tiling at launch;
// above 48 KB the launch opts in, and a window beyond the 227 KB a block can
// use is refused.  The TPU form (the (y, z) pair flattened onto lanes,
// one-hot tent matmuls, bf16 hi/lo splits, lane padding, scalar-prefetched
// block -> tile map, double-buffered window DMA) stays behind.
//
// Arithmetic.  Built with -fmad=false, and every expression keeps the
// operation order of the plain PyTorch version (ops/fused_pic3d.py), so
// positions, velocities and in_win match it bit for bit; rho differs only by
// atomic summation order.  floor_mod reproduces torch.remainder/jnp.mod,
// including mod(-tiny, n) == n.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory.  Each row reads
// position, velocity and weight (28 B) and writes position, velocity and
// in_win (25 B): 53 B a row plus the E grid read and rho written once,
// against ~110 f32 operations a row.  Rows are indexed with 64-bit offsets
// (32 M rows x 3 columns x 4 B passes 2^31 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = 4096;  // a CTA walks about this many rows

struct Params {
  int n_blocks, block, blocks_per_cta;
  int nx, ny, nz, nty, ntz, n_tiles, tile_x, tile_y, tile_z, margin;
  float qm_dt, c_x, c_y, c_z;
};

__device__ __forceinline__ float floor_mod(float x, float n) {
  float r = fmodf(x, n);
  if (r != 0.0f && r < 0.0f) r += n;
  return r;
}

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// adds the nonzero cells of the (wx, wy, wz) window at (ox, oy, oz) onto rho
__device__ __forceinline__ void flush_window(const float* rho_s,
                                             float* __restrict__ rho, int wn,
                                             int wy, int wz, int ox, int oy,
                                             int oz, int nx, int ny, int nz) {
  for (int k = threadIdx.x; k < wn; k += blockDim.x) {
    const float val = rho_s[k];
    if (val != 0.0f) {
      const int i = k / (wy * wz), rem = k - i * (wy * wz);
      const int j = rem / wz, l = rem - j * wz;
      atomicAdd(&rho[(wrap(ox + i, nx) * ny + wrap(oy + j, ny)) * nz
                     + wrap(oz + l, nz)], val);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
es3d_substep_kernel(const float* __restrict__ e_grid,
                    const float* __restrict__ pos,
                    const float* __restrict__ vel,
                    const float* __restrict__ wts,
                    const int* __restrict__ tile_id,
                    float* __restrict__ pos_out, float* __restrict__ vel_out,
                    float* __restrict__ rho,
                    unsigned char* __restrict__ in_win, const Params p) {
  extern __shared__ float smem[];
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int wx = p.tile_x + 2 * p.margin + 1;
  const int wy = p.tile_y + 2 * p.margin + 1;
  const int wz = p.tile_z + 2 * p.margin + 1;
  const int wn = wx * wy * wz;
  float* e_s = smem;             // (wx, wy, wz, 3)
  float* rho_s = smem + 3 * wn;  // (wx, wy, wz)
  const float nx_f = (float)nx, ny_f = (float)ny, nz_f = (float)nz;
  const float wx1 = (float)(wx - 1), wy1 = (float)(wy - 1),
              wz1 = (float)(wz - 1);

  const int b_begin = blockIdx.x * p.blocks_per_cta;
  const int b_end = min(b_begin + p.blocks_per_cta, p.n_blocks);
  int cur = -1, ox = 0, oy = 0, oz = 0;

  for (int b = b_begin; b < b_end; ++b) {
    const int t = tile_id[(int64_t)b * p.block];  // same for every thread
    if (t != cur) {
      __syncthreads();
      if (cur >= 0 && cur < p.n_tiles) {
        flush_window(rho_s, rho, wn, wy, wz, ox, oy, oz, nx, ny, nz);
        __syncthreads();
      }
      // the tile index unrolls z fastest
      oz = (t % p.ntz) * p.tile_z - p.margin;
      oy = ((t / p.ntz) % p.nty) * p.tile_y - p.margin;
      ox = (t / (p.ntz * p.nty)) * p.tile_x - p.margin;
      if (t < p.n_tiles) {
        for (int k = threadIdx.x; k < wn; k += blockDim.x) {
          const int i = k / (wy * wz), rem = k - i * (wy * wz);
          const int j = rem / wz, l = rem - j * wz;
          const float* src = e_grid
              + ((size_t)(wrap(ox + i, nx) * ny + wrap(oy + j, ny)) * nz
                 + wrap(oz + l, nz)) * 3;
          e_s[3 * k] = src[0];
          e_s[3 * k + 1] = src[1];
          e_s[3 * k + 2] = src[2];
          rho_s[k] = 0.0f;
        }
      }
      __syncthreads();
      cur = t;
    }
    const float ox_f = (float)ox, oy_f = (float)oy, oz_f = (float)oz;

    for (int r = threadIdx.x; r < p.block; r += blockDim.x) {
      const size_t row = (size_t)b * p.block + r;
      const float px = pos[row * 3], py = pos[row * 3 + 1],
                  pz = pos[row * 3 + 2];
      const float vx = vel[row * 3], vy = vel[row * 3 + 1],
                  vz = vel[row * 3 + 2];
      if (t >= p.n_tiles) {  // sentinel block: no window
        pos_out[row * 3] = px;
        pos_out[row * 3 + 1] = py;
        pos_out[row * 3 + 2] = pz;
        vel_out[row * 3] = vx;
        vel_out[row * 3 + 1] = vy;
        vel_out[row * 3 + 2] = vz;
        in_win[row] = 0;
        continue;
      }
      const float w = wts[row];
      const bool valid = w != 0.0f;
      const float lx = floor_mod(px - ox_f, nx_f);
      const float ly = floor_mod(py - oy_f, ny_f);
      const float lz = floor_mod(pz - oz_f, nz_f);
      bool inw = lx < wx1 && ly < wy1 && lz < wz1;
      float nlx = lx, nly = ly, nlz = lz, nvx = vx, nvy = vy, nvz = vz;

      if (inw) {
        float ex = 0.0f, ey = 0.0f, ez = 0.0f;
        if (valid) {
          const float fi = floorf(lx), fj = floorf(ly), fk = floorf(lz);
          const float ax0 = 1.0f - (lx - fi), ax1 = 1.0f - ((fi + 1.0f) - lx);
          const float ay0 = 1.0f - (ly - fj), ay1 = 1.0f - ((fj + 1.0f) - ly);
          const float az0 = 1.0f - (lz - fk), az1 = 1.0f - ((fk + 1.0f) - lz);
          const float c00 = ay0 * az0, c01 = ay0 * az1;
          const float c10 = ay1 * az0, c11 = ay1 * az1;
          const float* q0 = e_s + (((int)fi * wy + (int)fj) * wz + (int)fk) * 3;
          const float* q1 = q0 + wy * wz * 3;
          const int sy = wz * 3;
          float e0[3], e1[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            e0[c] = c00 * q0[c] + c01 * q0[3 + c] + c10 * q0[sy + c]
                  + c11 * q0[sy + 3 + c];
            e1[c] = c00 * q1[c] + c01 * q1[3 + c] + c10 * q1[sy + c]
                  + c11 * q1[sy + 3 + c];
          }
          ex = ax0 * e0[0] + ax1 * e1[0];
          ey = ax0 * e0[1] + ax1 * e1[1];
          ez = ax0 * e0[2] + ax1 * e1[2];
        }
        nvx = valid ? vx + p.qm_dt * ex : 0.0f;
        nvy = valid ? vy + p.qm_dt * ey : 0.0f;
        nvz = valid ? vz + p.qm_dt * ez : 0.0f;
        nlx = lx + p.c_x * nvx;
        nly = ly + p.c_y * nvy;
        nlz = lz + p.c_z * nvz;
        inw = nlx >= 0.0f && nlx < wx1 && nly >= 0.0f && nly < wy1
              && nlz >= 0.0f && nlz < wz1;
      }

      if (inw && valid) {
        const float fi = floorf(nlx), fj = floorf(nly), fk = floorf(nlz);
        const float bx0 = 1.0f - (nlx - fi), bx1 = 1.0f - ((fi + 1.0f) - nlx);
        const float by0 = 1.0f - (nly - fj), by1 = 1.0f - ((fj + 1.0f) - nly);
        const float bz0 = 1.0f - (nlz - fk), bz1 = 1.0f - ((fk + 1.0f) - nlz);
        const float d00 = (by0 * bz0) * w, d01 = (by0 * bz1) * w;
        const float d10 = (by1 * bz0) * w, d11 = (by1 * bz1) * w;
        float* c0 = rho_s + ((int)fi * wy + (int)fj) * wz + (int)fk;
        float* c1 = c0 + wy * wz;
        atomicAdd(c0, bx0 * d00);
        atomicAdd(c0 + 1, bx0 * d01);
        atomicAdd(c0 + wz, bx0 * d10);
        atomicAdd(c0 + wz + 1, bx0 * d11);
        atomicAdd(c1, bx1 * d00);
        atomicAdd(c1 + 1, bx1 * d01);
        atomicAdd(c1 + wz, bx1 * d10);
        atomicAdd(c1 + wz + 1, bx1 * d11);
      }

      pos_out[row * 3] = floor_mod((inw ? nlx : lx) + ox_f, nx_f);
      pos_out[row * 3 + 1] = floor_mod((inw ? nly : ly) + oy_f, ny_f);
      pos_out[row * 3 + 2] = floor_mod((inw ? nlz : lz) + oz_f, nz_f);
      vel_out[row * 3] = inw ? nvx : vx;
      vel_out[row * 3 + 1] = inw ? nvy : vy;
      vel_out[row * 3 + 2] = inw ? nvz : vz;
      in_win[row] = inw ? 1 : 0;
    }
  }

  __syncthreads();
  if (cur >= 0 && cur < p.n_tiles) {
    flush_window(rho_s, rho, wn, wy, wz, ox, oy, oz, nx, ny, nz);
  }
}

}  // namespace

// Launches the substep on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, and a synchronize does not report it).
// Device pointers: e_grid (nx, ny, nz, 3) f32, pos/vel/pos_out/vel_out
// (n_rows, 3) f32, wts (n_rows,) f32, tile_id (n_rows,) int32, rho
// (nx, ny, nz) f32 zeroed, in_win (n_rows,) bytes.  n_rows is a multiple of
// block.
extern "C" int es3d_substep(const void* e_grid, const void* pos,
                            const void* vel, const void* wts,
                            const void* tile_id, void* pos_out, void* vel_out,
                            void* rho, void* in_win, int n_rows, int block,
                            int nx, int ny, int nz,
                            int nty, int ntz, int n_tiles, int tile_x,
                            int tile_y, int tile_z, int margin, float qm_dt,
                            float c_x, float c_y, float c_z, void* stream) {
  Params p;
  p.n_blocks = n_rows / block;
  if (p.n_blocks == 0) return 0;
  p.block = block;
  p.blocks_per_cta = kRowsPerCta / block < 1 ? 1 : kRowsPerCta / block;
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  p.nty = nty;
  p.ntz = ntz;
  p.n_tiles = n_tiles;
  p.tile_x = tile_x;
  p.tile_y = tile_y;
  p.tile_z = tile_z;
  p.margin = margin;
  p.qm_dt = qm_dt;
  p.c_x = c_x;
  p.c_y = c_y;
  p.c_z = c_z;
  const size_t wn = (size_t)(tile_x + 2 * margin + 1)
                    * (tile_y + 2 * margin + 1) * (tile_z + 2 * margin + 1);
  const size_t smem = 4 * wn * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        es3d_substep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (p.n_blocks + p.blocks_per_cta - 1) / p.blocks_per_cta;
  es3d_substep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)e_grid, (const float*)pos, (const float*)vel,
      (const float*)wts, (const int*)tile_id, (float*)pos_out,
      (float*)vel_out, (float*)rho, (unsigned char*)in_win, p);
  return (int)cudaGetLastError();
}

extern "C" const char* es3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
