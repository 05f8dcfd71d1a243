// Fused 2D3V electromagnetic PIC substep for tile-sorted particles, Hopper.
//
// Replaces: fusion_sim_tpu/ops/pallas_em.py : fused_em2d_substep
//           (_em2d_kernel + accumulate_tile_2d).
//
// Per particle row of the padded tile-sorted layout (ops/sorted_deposit.py),
// in its block's window-local frame l = mod(x - origin, n):
//   CIC gather of the 6-channel node-centered E|B table at l0,
//   Boris kick (optionally relativistic, proper velocity u = gamma v),
//   drift l1 = l0 + dt v' / dx (v' = u'/gamma' when relativistic),
//   Esirkepov deposit of J (3 components) for the motion l0 -> l1,
//   wrap back to global periodic coordinates and flag in_win.
// A row whose l0 or l1 leaves [0, w - 1) on either axis comes back frozen
// (position mod(l0 + origin, n), velocity as given) with no deposit; the
// model re-pushes it exactly (spill patch).  Rows of blocks carrying the
// sentinel tile id (n_tiles) come back exactly as given, in_win = 0.
//
// Design.  One CTA of kThreads threads walks kBlocksPerCta consecutive
// particle blocks.  A particle block lies in one tile and consecutive blocks
// usually share it, so the CTA accumulates the run's current in a shared
// (wr, wz, 3) f32 window with shared-memory atomics and, when the tile
// changes (and at the end), flushes the nonzero cells onto the periodic grid
// with global atomics: J comes out on the grid, and the reference's per-tile
// buffer and fold pass are not needed.  The window is 24.3 KB at tile 32 /
// margin 6, so several CTAs share an SM.  The field table (6.3 MB at 512^2)
// stays in L2/L1: each row reads its four corner cells as three float2
// loads each, at the wrapped grid index of the window cell, so no field
// window is staged (with it the CTA would need 72.9 KB).  The deposit walks
// the window nodes floor(min(l0, l1)) .. floor(max(l0, l1)) + 1 of each
// axis: 2 or 3 of them while the drift stays under a cell, more for a
// faster row, which the reference's window-wide tents cover too.  The TPU
// form (one-hot tent matmuls, bf16 hi/lo splits, lane padding, streamed
// windows) stays behind.
//
// Arithmetic.  Built with -fmad=false; IEEE division and square root; every
// expression keeps the operation order of the plain PyTorch version
// (ops/fused_em.py), so positions, velocities and in_win match it bit for
// bit, and J differs only by atomic summation order.  floor_mod reproduces
// torch.remainder/jnp.mod, including mod(-tiny, n) == n.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory.  Each row reads
// position, velocity and valid (21 B) and writes position, velocity and
// in_win (21 B): 42 B/row, about 0.13 ms a launch at 10.26 M rows with the
// table read and J written once, against ~300 f32 operations/row
// (~0.05 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = 4;

struct Params {
  int n_blocks, block, nr, nz, ntz, n_tiles, tile_r, tile_z, margin;
  int relativistic;
  float h, dt, inv_dx, inv_dz, coef_x, coef_z, inv_vol, inv_c2, charge;
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

__device__ __forceinline__ void flush_window(const float* j_s,
                                             float* __restrict__ j_grid,
                                             int wn3, int wz, int otr,
                                             int otz, int nr, int nz) {
  for (int k = threadIdx.x; k < wn3; k += blockDim.x) {
    const float val = j_s[k];
    if (val != 0.0f) {
      const int cell = k / 3, c = k - cell * 3;
      const int i = cell / wz, j = cell - i * wz;
      atomicAdd(&j_grid[(wrap(otr + i, nr) * nz + wrap(otz + j, nz)) * 3 + c],
                val);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
em2d_substep_kernel(const float2* __restrict__ table,
                    const float2* __restrict__ pos,
                    const float* __restrict__ vel,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ tile_id,
                    float2* __restrict__ pos_out,
                    float* __restrict__ vel_out,
                    float* __restrict__ j_grid,
                    unsigned char* __restrict__ in_win, const Params p) {
  extern __shared__ float j_s[];  // (wr, wz, 3)
  const int nr = p.nr, nz = p.nz;
  const int wr = p.tile_r + 2 * p.margin + 1;
  const int wz = p.tile_z + 2 * p.margin + 1;
  const int wn3 = wr * wz * 3;
  const float nr_f = (float)nr, nz_f = (float)nz;
  const float wr1 = (float)(wr - 1), wz1 = (float)(wz - 1);
  const float h = p.h;

  const int b_begin = blockIdx.x * kBlocksPerCta;
  const int b_end = min(b_begin + kBlocksPerCta, p.n_blocks);
  int cur = -1, otr = 0, otz = 0;

  for (int b = b_begin; b < b_end; ++b) {
    const int t = tile_id[(int64_t)b * p.block];  // same for every thread
    if (t != cur) {
      __syncthreads();
      if (cur >= 0 && cur < p.n_tiles) {
        flush_window(j_s, j_grid, wn3, wz, otr, otz, nr, nz);
        __syncthreads();
      }
      otr = (t / p.ntz) * p.tile_r - p.margin;
      otz = (t % p.ntz) * p.tile_z - p.margin;
      if (t < p.n_tiles) {
        for (int k = threadIdx.x; k < wn3; k += blockDim.x) j_s[k] = 0.0f;
      }
      __syncthreads();
      cur = t;
    }
    const float otr_f = (float)otr, otz_f = (float)otz;

    for (int r = threadIdx.x; r < p.block; r += blockDim.x) {
      const int64_t row = (int64_t)b * p.block + r;
      const float2 x = pos[row];
      const float vx = vel[row * 3], vy = vel[row * 3 + 1],
                  vz = vel[row * 3 + 2];
      if (t >= p.n_tiles) {  // sentinel block: no window
        pos_out[row] = x;
        vel_out[row * 3] = vx;
        vel_out[row * 3 + 1] = vy;
        vel_out[row * 3 + 2] = vz;
        in_win[row] = 0;
        continue;
      }
      const float l0r = floor_mod(x.x - otr_f, nr_f);
      const float l0z = floor_mod(x.y - otz_f, nz_f);
      bool inw = l0r < wr1 && l0z < wz1;
      float l1r = l0r, l1z = l0z, nvx = vx, nvy = vy, nvz = vz, cvz = 0.0f;

      if (inw) {
        // 6-channel CIC gather, r first and then z
        const float fi = floorf(l0r), fj = floorf(l0z);
        const float ar0 = 1.0f - (l0r - fi);
        const float ar1 = 1.0f - ((fi + 1.0f) - l0r);
        const float az0 = 1.0f - (l0z - fj);
        const float az1 = 1.0f - ((fj + 1.0f) - l0z);
        const int gi = wrap(otr + (int)fi, nr), gj = wrap(otz + (int)fj, nz);
        const int gi1 = gi + 1 == nr ? 0 : gi + 1;
        const int gj1 = gj + 1 == nz ? 0 : gj + 1;
        const float2* c00 = table + (gi * nz + gj) * 3;
        const float2* c10 = table + (gi1 * nz + gj) * 3;
        const float2* c01 = table + (gi * nz + gj1) * 3;
        const float2* c11 = table + (gi1 * nz + gj1) * 3;
        float eb[6];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 w00 = __ldg(c00 + c), w10 = __ldg(c10 + c);
          const float2 w01 = __ldg(c01 + c), w11 = __ldg(c11 + c);
          eb[2 * c] = az0 * (ar0 * w00.x + ar1 * w10.x)
                    + az1 * (ar0 * w01.x + ar1 * w11.x);
          eb[2 * c + 1] = az0 * (ar0 * w00.y + ar1 * w10.y)
                        + az1 * (ar0 * w01.y + ar1 * w11.y);
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
        float cvx = nvx, cvy = nvy;
        cvz = nvz;
        if (p.relativistic) {
          const float gamma1 =
              sqrtf(1.0f + (nvx * nvx + nvy * nvy + nvz * nvz) * p.inv_c2);
          cvx = nvx / gamma1;
          cvy = nvy / gamma1;
          cvz = nvz / gamma1;
        }
        l1r = l0r + p.dt * cvx * p.inv_dx;
        l1z = l0z + p.dt * cvy * p.inv_dz;
        inw = l1r >= 0.0f && l1r < wr1 && l1z >= 0.0f && l1z < wz1;
      }

      if (inw && valid[row]) {
        // Esirkepov: the window nodes the motion l0 -> l1 touches
        const float q = p.charge;
        const float qcx = q * p.coef_x, qcz = q * p.coef_z;
        const float qvz = q * cvz * p.inv_vol;
        const int i_lo = (int)floorf(fminf(l0r, l1r));
        const int i_hi = min((int)floorf(fmaxf(l0r, l1r)) + 1, wr - 1);
        const int j_lo = (int)floorf(fminf(l0z, l1z));
        const int j_hi = min((int)floorf(fmaxf(l0z, l1z)) + 1, wz - 1);
        for (int i = i_lo; i <= i_hi; ++i) {
          const float ni = (float)i;
          const float s0r = tent(l0r, ni);
          const float dsr = tent(l1r, ni) - s0r;
          const float ax = qcx * cum_tent(l0r, l1r, ni);
          const float ay = s0r + 0.5f * dsr;
          const float a1 = qvz * ay;
          const float a2 = qvz * (0.5f * s0r + dsr / 3.0f);
          for (int j = j_lo; j <= j_hi; ++j) {
            const float nj = (float)j;
            const float s0z = tent(l0z, nj);
            const float dsz = tent(l1z, nj) - s0z;
            const float by_ = qcz * cum_tent(l0z, l1z, nj);
            const float jx = ax * (s0z + 0.5f * dsz);
            const float jy = ay * by_;
            const float jz = a1 * s0z + a2 * dsz;
            float* cell = j_s + (i * wz + j) * 3;
            if (jx != 0.0f) atomicAdd(cell, jx);
            if (jy != 0.0f) atomicAdd(cell + 1, jy);
            if (jz != 0.0f) atomicAdd(cell + 2, jz);
          }
        }
      }

      pos_out[row] = make_float2(
          floor_mod((inw ? l1r : l0r) + otr_f, nr_f),
          floor_mod((inw ? l1z : l0z) + otz_f, nz_f));
      vel_out[row * 3] = inw ? nvx : vx;
      vel_out[row * 3 + 1] = inw ? nvy : vy;
      vel_out[row * 3 + 2] = inw ? nvz : vz;
      in_win[row] = inw ? 1 : 0;
    }
  }

  __syncthreads();
  if (cur >= 0 && cur < p.n_tiles) {
    flush_window(j_s, j_grid, wn3, wz, otr, otz, nr, nz);
  }
}

}  // namespace

// Launches the substep on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, and a synchronize does not report it).
// Device pointers: table (nr, nz, 6) f32, pos/pos_out (n_rows, 2) f32,
// vel/vel_out (n_rows, 3) f32, valid and in_win (n_rows,) bytes, tile_id
// (n_rows,) int32, j_grid (nr, nz, 3) f32 zeroed.  n_rows is a multiple of
// block.
extern "C" int em2d_substep(const void* table, const void* pos,
                            const void* vel, const void* valid,
                            const void* tile_id, void* pos_out, void* vel_out,
                            void* j_grid, void* in_win, int n_rows, int block,
                            int nr, int nz, int ntz, int n_tiles, int tile_r,
                            int tile_z, int margin, int relativistic,
                            float qm_half_dt, float dt, float inv_dx,
                            float inv_dz, float coef_x, float coef_z,
                            float inv_vol, float inv_c2, float charge,
                            void* stream) {
  Params p;
  p.n_blocks = n_rows / block;
  if (p.n_blocks == 0) return 0;
  p.block = block;
  p.nr = nr;
  p.nz = nz;
  p.ntz = ntz;
  p.n_tiles = n_tiles;
  p.tile_r = tile_r;
  p.tile_z = tile_z;
  p.margin = margin;
  p.relativistic = relativistic;
  p.h = qm_half_dt;
  p.dt = dt;
  p.inv_dx = inv_dx;
  p.inv_dz = inv_dz;
  p.coef_x = coef_x;
  p.coef_z = coef_z;
  p.inv_vol = inv_vol;
  p.inv_c2 = inv_c2;
  p.charge = charge;
  const int wr = tile_r + 2 * margin + 1;
  const int wz = tile_z + 2 * margin + 1;
  const size_t smem = 3 * (size_t)wr * wz * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        em2d_substep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (p.n_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  em2d_substep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)table, (const float2*)pos, (const float*)vel,
      (const unsigned char*)valid, (const int*)tile_id, (float2*)pos_out,
      (float*)vel_out, (float*)j_grid, (unsigned char*)in_win, p);
  return (int)cudaGetLastError();
}

extern "C" const char* em2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
