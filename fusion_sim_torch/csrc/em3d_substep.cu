// Fused 3D3V electromagnetic PIC substep for tile-sorted particles, Hopper.
//
// Replaces: fusion_sim_tpu/ops/pallas_em3d.py : fused_em3d_substep
//           (_em3d_kernel, pallas_pic3d._local_coords_3d, the flat tile
//           windows and their fold).
//
// Per particle row of the padded tile-sorted 3D layout
// (ops/sorted_deposit.py), in its block's window-local frame
// l = mod(x - origin, n) per axis:
//   CIC gather of the 6-channel node-centered E|B table at l0 (8 corners),
//   Boris kick (optionally relativistic, proper velocity u = gamma v),
//   drift l1 = l0 + dt v' / dx (v' = u'/gamma' when relativistic),
//   3D Esirkepov deposit of J (3 components) for the motion l0 -> l1,
//   wrap back to global periodic coordinates and flag in_win.
// A row whose l0 or l1 leaves [0, w - 1) on any axis comes back frozen
// (position mod(l0 + origin, n), velocity as given) with no deposit; the
// model re-pushes it exactly (spill patch).  An invalid row carries no charge
// but is pushed like any other.  Rows of blocks carrying the sentinel tile id
// (n_tiles) come back exactly as given, in_win = 0.
//
// Design.  One CTA of kThreads threads walks consecutive particle blocks,
// kRowsPerCta rows of them (8 blocks of 512).  A particle block lies in one
// tile and consecutive blocks usually share it, so the CTA accumulates the
// run's current in a shared (wx, wy, wz, 3) f32 window (26.4 KB at tile 8 /
// margin 2) with shared-memory atomics and, when the tile changes (and at the
// end), flushes the nonzero cells onto the periodic grid with global atomics:
// J comes out on the grid, and the reference's (n_tiles + 1) per-tile buffer,
// its `present` mask and its fold pass are not needed.  The field table is
// not copied into shared memory: each row reads its 8 corner cells (three
// float2 loads each) through L1/L2 at the wrapped grid index of the window
// cell, which keeps shared memory at the J window so that several CTAs share
// an SM (a 6-channel window beside J would take 79 KB at tile 8 / margin 2
// and measured slower on an H100).  The deposit walks the window nodes
// floor(min(l0, l1)) ..
// floor(max(l0, l1)) + 1 of each axis: 2 or 3 of them while the drift stays
// under a cell, more for a faster row, which the reference's window-wide
// tents cover too.  The TPU form (the (y, z) pair flattened onto lanes,
// one-hot tent matmuls, bf16 hi/lo splits, lane padding, streamed windows)
// stays behind.
//
// Arithmetic.  Built with -fmad=false; IEEE division and square root; every
// expression keeps the operation order of the plain PyTorch version
// (ops/fused_em3d.py), so positions, velocities and in_win match it bit for
// bit, and J differs only by atomic summation order.  floor_mod reproduces
// torch.remainder/jnp.mod, including mod(-tiny, n) == n.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory.  Each row reads
// position, velocity and valid (25 B) and writes position, velocity and
// in_win (25 B): 50 B a row plus the table read and J written once, against
// ~700 f32 operations a charged row with a 27-node stencil.  Rows are indexed
// with 64-bit offsets (32 M rows x 3 columns x 4 B passes 2^31 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = 4096;  // a CTA walks about this many rows

struct Params {
  int n_blocks, block, blocks_per_cta;
  int nx, ny, nz, nty, ntz, n_tiles, tile_x, tile_y, tile_z, margin;
  int relativistic;
  float h, dt, inv_dx, inv_dy, inv_dz, coef_x, coef_y, coef_z, inv_c2, charge;
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

__device__ __forceinline__ float tent(float l, float node) {
  return fmaxf(1.0f - fabsf(l - node), 0.0f);
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// closed-form cumulative tent difference of the motion l0 -> l1 at `node`
__device__ __forceinline__ float cum_tent(float l0, float l1, float node) {
  return clip01(node - l1 + 1.0f) - clip01(node - l0 + 1.0f);
}

// adds the nonzero values of the (wx, wy, wz, 3) window at (ox, oy, oz)
// onto the periodic J grid
__device__ __forceinline__ void flush_window(const float* j_s,
                                             float* __restrict__ j_grid,
                                             int wn3, int wy, int wz, int ox,
                                             int oy, int oz, int nx, int ny,
                                             int nz) {
  for (int k = threadIdx.x; k < wn3; k += blockDim.x) {
    const float val = j_s[k];
    if (val != 0.0f) {
      const int cell = k / 3, c = k - cell * 3;
      const int i = cell / (wy * wz), rem = cell - i * (wy * wz);
      const int j = rem / wz, l = rem - j * wz;
      atomicAdd(&j_grid[((size_t)(wrap(ox + i, nx) * ny + wrap(oy + j, ny))
                         * nz + wrap(oz + l, nz)) * 3 + c], val);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
em3d_substep_kernel(const float2* __restrict__ table,
                    const float* __restrict__ pos,
                    const float* __restrict__ vel,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ tile_id,
                    float* __restrict__ pos_out, float* __restrict__ vel_out,
                    float* __restrict__ j_grid,
                    unsigned char* __restrict__ in_win, const Params p) {
  extern __shared__ float smem[];
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int wx = p.tile_x + 2 * p.margin + 1;
  const int wy = p.tile_y + 2 * p.margin + 1;
  const int wz = p.tile_z + 2 * p.margin + 1;
  const int wn = wx * wy * wz;
  const int wn3 = wn * 3;
  float* j_s = smem;  // (wx, wy, wz, 3)
  const float nx_f = (float)nx, ny_f = (float)ny, nz_f = (float)nz;
  const float wx1 = (float)(wx - 1), wy1 = (float)(wy - 1),
              wz1 = (float)(wz - 1);
  const float h = p.h;

  const int b_begin = blockIdx.x * p.blocks_per_cta;
  const int b_end = min(b_begin + p.blocks_per_cta, p.n_blocks);
  int cur = -1, ox = 0, oy = 0, oz = 0;

  for (int b = b_begin; b < b_end; ++b) {
    const int t = tile_id[(int64_t)b * p.block];  // same for every thread
    if (t != cur) {
      __syncthreads();
      if (cur >= 0 && cur < p.n_tiles) {
        flush_window(j_s, j_grid, wn3, wy, wz, ox, oy, oz, nx, ny, nz);
        __syncthreads();
      }
      // the tile index unrolls z fastest
      oz = (t % p.ntz) * p.tile_z - p.margin;
      oy = ((t / p.ntz) % p.nty) * p.tile_y - p.margin;
      ox = (t / (p.ntz * p.nty)) * p.tile_x - p.margin;
      if (t < p.n_tiles) {
        for (int k = threadIdx.x; k < wn3; k += blockDim.x) j_s[k] = 0.0f;
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
      const float l0x = floor_mod(px - ox_f, nx_f);
      const float l0y = floor_mod(py - oy_f, ny_f);
      const float l0z = floor_mod(pz - oz_f, nz_f);
      bool inw = l0x < wx1 && l0y < wy1 && l0z < wz1;
      float l1x = l0x, l1y = l0y, l1z = l0z, nvx = vx, nvy = vy, nvz = vz;

      if (inw) {
        // 6-channel CIC gather: the (y, z) pair first, then x
        const float fi = floorf(l0x), fj = floorf(l0y), fk = floorf(l0z);
        const float ax0 = 1.0f - (l0x - fi), ax1 = 1.0f - ((fi + 1.0f) - l0x);
        const float ay0 = 1.0f - (l0y - fj), ay1 = 1.0f - ((fj + 1.0f) - l0y);
        const float az0 = 1.0f - (l0z - fk), az1 = 1.0f - ((fk + 1.0f) - l0z);
        const float c00 = ay0 * az0, c01 = ay0 * az1;
        const float c10 = ay1 * az0, c11 = ay1 * az1;
        // the 8 corner cells as float2 triples: [x][y][z]
        const float2* q[2][2][2];
        int gi[2], gj[2], gk[2];
        gi[0] = wrap(ox + (int)fi, nx);
        gj[0] = wrap(oy + (int)fj, ny);
        gk[0] = wrap(oz + (int)fk, nz);
        gi[1] = gi[0] + 1 == nx ? 0 : gi[0] + 1;
        gj[1] = gj[0] + 1 == ny ? 0 : gj[0] + 1;
        gk[1] = gk[0] + 1 == nz ? 0 : gk[0] + 1;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              q[a][bb][c] =
                  table + ((size_t)(gi[a] * ny + gj[bb]) * nz + gk[c]) * 3;
        float eb[6];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float2 v[2][2][2];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int bb = 0; bb < 2; ++bb)
#pragma unroll
              for (int d = 0; d < 2; ++d)
                v[a][bb][d] = __ldg(q[a][bb][d] + c);
          const float p0x = c00 * v[0][0][0].x + c01 * v[0][0][1].x
                          + c10 * v[0][1][0].x + c11 * v[0][1][1].x;
          const float p1x = c00 * v[1][0][0].x + c01 * v[1][0][1].x
                          + c10 * v[1][1][0].x + c11 * v[1][1][1].x;
          const float p0y = c00 * v[0][0][0].y + c01 * v[0][0][1].y
                          + c10 * v[0][1][0].y + c11 * v[0][1][1].y;
          const float p1y = c00 * v[1][0][0].y + c01 * v[1][0][1].y
                          + c10 * v[1][1][0].y + c11 * v[1][1][1].y;
          eb[2 * c] = ax0 * p0x + ax1 * p1x;
          eb[2 * c + 1] = ax0 * p0y + ax1 * p1y;
        }
        const float ex = eb[0], ey = eb[1], ez = eb[2];
        const float bx = eb[3], by = eb[4], bz = eb[5];

        // Boris kick
        const float vmx = vx + h * ex, vmy = vy + h * ey, vmz = vz + h * ez;
        float tx = h * bx, ty = h * by, tz = h * bz;
        if (p.relativistic) {
          const float gamma =
              sqrtf(1.0f + (vmx * vmx + vmy * vmy + vmz * vmz) * p.inv_c2);
          tx = tx / gamma;
          ty = ty / gamma;
          tz = tz / gamma;
        }
        const float sfac = 2.0f / (1.0f + (tx * tx + ty * ty + tz * tz));
        const float sx = tx * sfac, sy = ty * sfac, sz = tz * sfac;
        const float vpx = vmx + (vmy * tz - vmz * ty);
        const float vpy = vmy + (vmz * tx - vmx * tz);
        const float vpz = vmz + (vmx * ty - vmy * tx);
        nvx = vmx + (vpy * sz - vpz * sy) + h * ex;
        nvy = vmy + (vpz * sx - vpx * sz) + h * ey;
        nvz = vmz + (vpx * sy - vpy * sx) + h * ez;

        // drift
        float cvx = nvx, cvy = nvy, cvz = nvz;
        if (p.relativistic) {
          const float gamma1 =
              sqrtf(1.0f + (nvx * nvx + nvy * nvy + nvz * nvz) * p.inv_c2);
          cvx = nvx / gamma1;
          cvy = nvy / gamma1;
          cvz = nvz / gamma1;
        }
        l1x = l0x + p.dt * cvx * p.inv_dx;
        l1y = l0y + p.dt * cvy * p.inv_dy;
        l1z = l0z + p.dt * cvz * p.inv_dz;
        inw = l1x >= 0.0f && l1x < wx1 && l1y >= 0.0f && l1y < wy1
              && l1z >= 0.0f && l1z < wz1;
      }

      if (inw && valid[row]) {
        // Esirkepov: the window nodes the motion l0 -> l1 touches
        const float q = p.charge;
        const float qcx = q * p.coef_x, qcy = q * p.coef_y,
                    qcz = q * p.coef_z;
        const int i_lo = (int)floorf(fminf(l0x, l1x));
        const int i_hi = min((int)floorf(fmaxf(l0x, l1x)) + 1, wx - 1);
        const int j_lo = (int)floorf(fminf(l0y, l1y));
        const int j_hi = min((int)floorf(fmaxf(l0y, l1y)) + 1, wy - 1);
        const int k_lo = (int)floorf(fminf(l0z, l1z));
        const int k_hi = min((int)floorf(fmaxf(l0z, l1z)) + 1, wz - 1);
        for (int i = i_lo; i <= i_hi; ++i) {
          const float ni = (float)i;
          const float s0x = tent(l0x, ni);
          const float dsx = tent(l1x, ni) - s0x;
          const float kxq = qcx * cum_tent(l0x, l1x, ni);
          const float p1x = s0x + 0.5f * dsx;
          const float p2x = 0.5f * s0x + dsx / 3.0f;
          for (int j = j_lo; j <= j_hi; ++j) {
            const float nj = (float)j;
            const float s0y = tent(l0y, nj);
            const float dsy = tent(l1y, nj) - s0y;
            const float kyq = qcy * cum_tent(l0y, l1y, nj);
            const float m1y = s0y + 0.5f * dsy;
            const float m2y = 0.5f * s0y + dsy / 3.0f;
            float* cell = j_s + ((i * wy + j) * wz + k_lo) * 3;
            for (int k = k_lo; k <= k_hi; ++k, cell += 3) {
              const float nk = (float)k;
              const float s0z = tent(l0z, nk);
              const float dsz = tent(l1z, nk) - s0z;
              const float kzq = qcz * cum_tent(l0z, l1z, nk);
              const float jx = kxq * (m1y * s0z + m2y * dsz);
              const float jy = p1x * (kyq * s0z) + p2x * (kyq * dsz);
              const float jz = p1x * (kzq * s0y) + p2x * (kzq * dsy);
              if (jx != 0.0f) atomicAdd(cell, jx);
              if (jy != 0.0f) atomicAdd(cell + 1, jy);
              if (jz != 0.0f) atomicAdd(cell + 2, jz);
            }
          }
        }
      }

      pos_out[row * 3] = floor_mod((inw ? l1x : l0x) + ox_f, nx_f);
      pos_out[row * 3 + 1] = floor_mod((inw ? l1y : l0y) + oy_f, ny_f);
      pos_out[row * 3 + 2] = floor_mod((inw ? l1z : l0z) + oz_f, nz_f);
      vel_out[row * 3] = inw ? nvx : vx;
      vel_out[row * 3 + 1] = inw ? nvy : vy;
      vel_out[row * 3 + 2] = inw ? nvz : vz;
      in_win[row] = inw ? 1 : 0;
    }
  }

  __syncthreads();
  if (cur >= 0 && cur < p.n_tiles) {
    flush_window(j_s, j_grid, wn3, wy, wz, ox, oy, oz, nx, ny, nz);
  }
}

}  // namespace

// Launches the substep on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, and a synchronize does not report it).
// Device pointers: table (nx, ny, nz, 6) f32, pos/pos_out and vel/vel_out
// (n_rows, 3) f32, valid and in_win (n_rows,) bytes, tile_id (n_rows,) int32,
// j_grid (nx, ny, nz, 3) f32 zeroed.  n_rows is a multiple of block.
extern "C" int em3d_substep(const void* table, const void* pos,
                            const void* vel, const void* valid,
                            const void* tile_id, void* pos_out, void* vel_out,
                            void* j_grid, void* in_win, int n_rows, int block,
                            int nx, int ny, int nz,
                            int nty, int ntz, int n_tiles, int tile_x,
                            int tile_y, int tile_z, int margin,
                            int relativistic,
                            float qm_half_dt, float dt, float inv_dx,
                            float inv_dy, float inv_dz, float coef_x,
                            float coef_y, float coef_z, float inv_c2,
                            float charge, void* stream) {
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
  p.relativistic = relativistic;
  p.h = qm_half_dt;
  p.dt = dt;
  p.inv_dx = inv_dx;
  p.inv_dy = inv_dy;
  p.inv_dz = inv_dz;
  p.coef_x = coef_x;
  p.coef_y = coef_y;
  p.coef_z = coef_z;
  p.inv_c2 = inv_c2;
  p.charge = charge;
  const size_t wn = (size_t)(tile_x + 2 * margin + 1)
                    * (tile_y + 2 * margin + 1) * (tile_z + 2 * margin + 1);
  const size_t smem = 3 * wn * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        em3d_substep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (p.n_blocks + p.blocks_per_cta - 1) / p.blocks_per_cta;
  em3d_substep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)table, (const float*)pos, (const float*)vel,
      (const unsigned char*)valid, (const int*)tile_id, (float*)pos_out,
      (float*)vel_out, (float*)j_grid, (unsigned char*)in_win, p);
  return (int)cudaGetLastError();
}

extern "C" const char* em3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
