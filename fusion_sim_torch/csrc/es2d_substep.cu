// Fused 2D electrostatic PIC substep for tile-sorted particles, Hopper.
//
// Replaces: fusion_sim_tpu/ops/pallas_pic.py : fused_es2d_substep
//           (_es2d_kernel + accumulate_tile_2d).
//
// Per particle row of the padded tile-sorted layout (ops/sorted_deposit.py):
//   CIC gather of E (2 channels) from the block's tile window,
//   kick v' = v + qm_dt * E, drift x' = x + c * v' (window-local coordinates),
//   CIC deposit of the weight at x' into rho,
//   wrap back to global periodic coordinates and flag in_win.
// Rows that leave their window (gather or deposit) come back frozen at their
// inputs with no deposit; the model patches them exactly (spill patch).
// Rows of blocks carrying the sentinel tile id (n_tiles) are weightless.
//
// Design.  One CTA of kThreads threads walks kBlocksPerCta consecutive
// particle blocks.  A particle block lies in one tile, and consecutive
// blocks usually share it, so the CTA stages the tile's E window
// (wr x wz x 2 f32, 22.5 KB at tile 32 / margin 10) straight from e_grid
// with periodic wrap into shared memory once per tile run, gathers from
// it, and accumulates the run's deposit in a shared wr x wz f32 window with
// shared-memory atomics.  When the tile changes (and at the end) the window
// is flushed onto the periodic grid with one global atomicAdd per nonzero
// cell: rho comes out on the grid directly, so the reference's per-tile
// buffer and fold_tile_windows pass are not needed.  The TPU form (one-hot
// tent matmuls, sublane pads, bf16 hi/lo splits, grid grouping) stays
// behind: the gather is four f32 loads from shared memory.
//
// Arithmetic.  Built with -fmad=false, and every expression keeps the
// operation order of the plain PyTorch version (ops/fused_pic.py), so
// positions, velocities and in_win match it bit for bit; rho differs only
// by atomic summation order.  floor_mod reproduces torch.remainder/jnp.mod,
// including mod(-tiny, n) == n.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory.  Each row reads
// position, velocity and weight (20 B) and writes position, velocity and
// in_win (17 B): 37 B/row, about 0.11 ms a launch at 10.26 M rows, against
// ~60 f32 operations/row (~0.01 ms).  The design keeps the grid traffic
// (e_grid read once per tile run, rho flushed once per tile run) in L2 and
// off that budget, and reads rows with coalesced 8-byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = 4;

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
es2d_substep_kernel(const float2* __restrict__ e_grid,
                    const float2* __restrict__ pos,
                    const float2* __restrict__ vel,
                    const float* __restrict__ wts,
                    const int* __restrict__ tile_id,
                    float2* __restrict__ pos_out,
                    float2* __restrict__ vel_out,
                    float* __restrict__ rho,
                    unsigned char* __restrict__ in_win,
                    int n_blocks, int block, int nr, int nz, int ntz,
                    int n_tiles, int tile_r, int tile_z, int margin,
                    float qm_dt, float c_r, float c_z) {
  extern __shared__ float smem[];
  const int wr = tile_r + 2 * margin + 1;
  const int wz = tile_z + 2 * margin + 1;
  const int wn = wr * wz;
  float2* e_s = reinterpret_cast<float2*>(smem);
  float* rho_s = smem + 2 * wn;
  const float nr_f = (float)nr, nz_f = (float)nz;
  const float wr1 = (float)(wr - 1), wz1 = (float)(wz - 1);

  const int b_begin = blockIdx.x * kBlocksPerCta;
  const int b_end = min(b_begin + kBlocksPerCta, n_blocks);
  int cur = -1, otr = 0, otz = 0;

  for (int b = b_begin; b < b_end; ++b) {
    const int t = tile_id[(int64_t)b * block];  // same for every thread
    if (t != cur) {
      __syncthreads();
      if (cur >= 0 && cur < n_tiles) {
        for (int k = threadIdx.x; k < wn; k += blockDim.x) {
          const float val = rho_s[k];
          if (val != 0.0f) {
            const int i = k / wz, j = k - i * wz;
            atomicAdd(&rho[wrap(otr + i, nr) * nz + wrap(otz + j, nz)], val);
          }
        }
        __syncthreads();
      }
      otr = (t / ntz) * tile_r - margin;
      otz = (t % ntz) * tile_z - margin;
      if (t < n_tiles) {
        for (int k = threadIdx.x; k < wn; k += blockDim.x) {
          const int i = k / wz, j = k - i * wz;
          e_s[k] = e_grid[wrap(otr + i, nr) * nz + wrap(otz + j, nz)];
          rho_s[k] = 0.0f;
        }
      }
      __syncthreads();
      cur = t;
    }
    const bool real_tile = t < n_tiles;
    const float otr_f = (float)otr, otz_f = (float)otz;

    for (int r = threadIdx.x; r < block; r += blockDim.x) {
      const int64_t row = (int64_t)b * block + r;
      const float2 p = pos[row];
      const float2 v = vel[row];
      const float w = real_tile ? wts[row] : 0.0f;
      const float lr = floor_mod(p.x - otr_f, nr_f);
      const float lz = floor_mod(p.y - otz_f, nz_f);
      const bool g_inw = lr < wr1 && lz < wz1;
      const bool valid = w != 0.0f;

      float nvr = 0.0f, nvz = 0.0f;
      if (valid) {
        float ex = 0.0f, ez = 0.0f;
        if (g_inw) {
          const float fi = floorf(lr), fj = floorf(lz);
          const int i = (int)fi, j = (int)fj;
          const float ar0 = 1.0f - (lr - fi);
          const float ar1 = 1.0f - ((fi + 1.0f) - lr);
          const float az0 = 1.0f - (lz - fj);
          const float az1 = 1.0f - ((fj + 1.0f) - lz);
          const float2 e00 = e_s[i * wz + j];
          const float2 e10 = e_s[(i + 1) * wz + j];
          const float2 e01 = e_s[i * wz + j + 1];
          const float2 e11 = e_s[(i + 1) * wz + j + 1];
          ex = az0 * (ar0 * e00.x + ar1 * e10.x)
             + az1 * (ar0 * e01.x + ar1 * e11.x);
          ez = az0 * (ar0 * e00.y + ar1 * e10.y)
             + az1 * (ar0 * e01.y + ar1 * e11.y);
        }
        nvr = v.x + qm_dt * ex;
        nvz = v.y + qm_dt * ez;
      }
      const float nlr = lr + c_r * nvr;
      const float nlz = lz + c_z * nvz;
      const bool inw = g_inw && nlr >= 0.0f && nlr < wr1
                       && nlz >= 0.0f && nlz < wz1;

      float2 po, vo;
      if (inw) {
        if (valid) {
          const float fi = floorf(nlr), fj = floorf(nlz);
          const int i = (int)fi, j = (int)fj;
          const float br0 = 1.0f - (nlr - fi);
          const float br1 = 1.0f - ((fi + 1.0f) - nlr);
          const float bz0 = 1.0f - (nlz - fj);
          const float bz1 = 1.0f - ((fj + 1.0f) - nlz);
          const float wz0 = bz0 * w, wz1w = bz1 * w;
          atomicAdd(&rho_s[i * wz + j], br0 * wz0);
          atomicAdd(&rho_s[i * wz + j + 1], br0 * wz1w);
          atomicAdd(&rho_s[(i + 1) * wz + j], br1 * wz0);
          atomicAdd(&rho_s[(i + 1) * wz + j + 1], br1 * wz1w);
        }
        po = make_float2(floor_mod(nlr + otr_f, nr_f),
                         floor_mod(nlz + otz_f, nz_f));
        vo = make_float2(nvr, nvz);
      } else {
        po = make_float2(floor_mod(lr + otr_f, nr_f),
                         floor_mod(lz + otz_f, nz_f));
        vo = v;
      }
      pos_out[row] = po;
      vel_out[row] = vo;
      in_win[row] = inw ? 1 : 0;
    }
  }

  __syncthreads();
  if (cur >= 0 && cur < n_tiles) {
    for (int k = threadIdx.x; k < wn; k += blockDim.x) {
      const float val = rho_s[k];
      if (val != 0.0f) {
        const int i = k / wz, j = k - i * wz;
        atomicAdd(&rho[wrap(otr + i, nr) * nz + wrap(otz + j, nz)], val);
      }
    }
  }
}

}  // namespace

// Launches the substep on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, and a synchronize does not report it).
// Pointers are device pointers: e_grid (nr, nz, 2), pos/vel/pos_out/vel_out
// (n_rows, 2), wts (n_rows,), tile_id (n_rows,) int32, rho (nr, nz) zeroed,
// in_win (n_rows,) bytes.  n_rows is a multiple of block.
extern "C" int es2d_substep(const void* e_grid, const void* pos,
                            const void* vel, const void* wts,
                            const void* tile_id, void* pos_out, void* vel_out,
                            void* rho, void* in_win, int n_rows, int block,
                            int nr, int nz, int ntz, int n_tiles, int tile_r,
                            int tile_z, int margin, float qm_dt, float c_r,
                            float c_z, void* stream) {
  const int n_blocks = n_rows / block;
  if (n_blocks == 0) return 0;
  const int wr = tile_r + 2 * margin + 1;
  const int wz = tile_z + 2 * margin + 1;
  const size_t smem = 3 * (size_t)wr * wz * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        es2d_substep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  es2d_substep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)e_grid, (const float2*)pos, (const float2*)vel,
      (const float*)wts, (const int*)tile_id, (float2*)pos_out,
      (float2*)vel_out, (float*)rho, (unsigned char*)in_win, n_blocks, block,
      nr, nz, ntz, n_tiles, tile_r, tile_z, margin, qm_dt, c_r, c_z);
  return (int)cudaGetLastError();
}

extern "C" const char* es2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
