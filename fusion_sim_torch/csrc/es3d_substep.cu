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
// Design (the tile-owned form of em3d_substep.cu, with a deposit that sums
// a warp's rows of one cell before it adds them):
//
// * One CTA owns one whole tile.  It finds the tile's blocks (sorted by tile
//   id, as the layout and its repair keep them) by a parallel search over
//   the blocks' first tile ids inside the kernel: no extra launch, no host
//   read.  Trailing CTAs copy the sentinel blocks.
// * It stages the tile's (wx, wy, wz, 3) E window (26.4 KB at tile 8^3,
//   margin 2) once, with 4-byte cp.async copies at the wrapped grid index
//   of every window cell, one window row (i, j) a warp, while it zeroes its
//   (wx, wy, wz) rho window (35 KB in all).  Four CTAs share an SM at the
//   main path, so one CTA's fill overlaps the others' rows.  rho is flushed
//   once a tile onto the periodic grid with global atomics (nonzero cells
//   only).
// * Each warp walks its own contiguous eighth of the tile's rows, 32 at a
//   time, and loads the next 32 rows' position, velocity and weight while
//   it works on the current ones (twice the bytes in flight).  The warps
//   of a CTA thus sit in different cells, and their shared adds do not
//   race for the same words.
// * The deposit.  A float add to shared memory is a compare-and-swap loop on
//   Hopper (ATOMS.CAST.SPIN in the SASS); the older form's 8 a row took 0.46
//   of its 1.23 ms on an H100 80GB HBM3 (by ablation).  The ES 3D shell orders each tile's rows by cell at every resort
//   (build_padded_layout(cell_order=True)), so a warp's 32 rows fall in a
//   few cells: the lanes are grouped by deposit cell (__match_any_sync),
//   each group's 8 corner values are summed by a tree of shuffles, and the
//   group's lowest lane alone makes the 8 shared adds.  Rows in any order
//   give the same sums, in smaller groups.
//
// Arithmetic.  Built with -fmad=false, and every value keeps the operation
// order of the plain PyTorch version (ops/fused_pic3d.py), so positions,
// velocities and in_win match it bit for bit; rho differs only by the order
// of its sums.  floor_mod reproduces torch.remainder/jnp.mod, including
// mod(-tiny, n) == n; inside (-n, 2n) it takes the one subtraction or
// addition that fmodf's result comes to (exact there), and fmodf outside.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory.  Each row reads
// position, velocity and weight (28 B) and writes position, velocity and
// in_win (25 B): 53 B a row plus the E grid read and rho written once,
// against ~110 f32 operations a row.  Measured on an H100 80GB HBM3 at the
// ES 3D main path (examples/kernel_pair.py --ablate): 0.78 ms, 66% of the
// 0.52 ms bound; 0.69 ms without gather and deposit, so the row stream with
// the tiles' fills and flushes is what bounds it now.  Rows are indexed
// with 64-bit offsets (32 M rows x 3 columns x 4 B passes 2^31 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;        // resident CTAs an SM (<= 64 registers)
constexpr int kWarps = kThreads / 32;
constexpr int kSentinelCtas = 128;   // CTAs that copy the sentinel blocks
constexpr size_t kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int n_blocks, block;
  int nx, ny, nz, nty, ntz, n_tiles, tile_x, tile_y, tile_z, margin;
  float qm_dt, c_x, c_y, c_z;
};

// Shared memory of a launch: the E window (3 floats a cell) and the rho
// window.
size_t smem_bytes(int wx, int wy, int wz) {
  return sizeof(float) * 4 * ((size_t)wx * wy * wz);
}

__device__ __forceinline__ float floor_mod(float x, float n) {
  if (x >= 0.0f && x < n) return x;
  if (x >= n && x < 2.0f * n) return x - n;  // exact (Sterbenz)
  if (x < 0.0f && x > -n) return x + n;      // fmodf(x, n) is x here
  float r = fmodf(x, n);
  if (r != 0.0f && r < 0.0f) r += n;
  return r;
}

// i mod n for i in [-n, 2n) (every window cell: the origin is >= -margin,
// and a window ends before 2n)
__device__ __forceinline__ int wrap_near(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The first block b in [0, n_blocks] whose first row's tile id is >=
// target (blocks sorted by tile id).  Every thread calls it; each round
// probes kThreads evenly spaced blocks, two rounds at the main path.
__device__ int block_lower_bound(const int* __restrict__ tile_id, int block,
                                 int n_blocks, int target) {
  int lo = 0, hi = n_blocks;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const int n = hi - lo;
    const int stride = (n + kThreads - 1) / kThreads;
    const int i = (int)threadIdx.x * stride;
    const bool below =
        i < n && tile_id[(int64_t)(lo + i) * block] < target;
    const int c = __syncthreads_count(below);
    if (c == 0) break;  // the block at lo is already >= target
    // probes 0 .. c - 1 are below target, probe c (if any) is not
    hi = min(lo + c * stride, hi);
    lo = lo + (c - 1) * stride + 1;
  }
  return lo;
}

// Sums d[] over the lanes of `peers` (this lane's group from
// __match_any_sync): a tree in which, each round, every lane of even rank
// adds the next live lane above it and the odd ranks drop out.  The group's
// lowest lane ends with the sums.  Every lane of the warp calls it.
__device__ __forceinline__ void sum_peers(unsigned peers, int lane,
                                          float (&d)[8]) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & ~((2u << lane) - 1u);  // the peers above this lane
  while (__any_sync(kFull, rest != 0u)) {
    const int src = (__ffs(rest) - 1) & 31;
    float t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = __shfl_sync(kFull, d[k], src);
    if (rest != 0u && (rank & 1) == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] += t[k];
    }
    rest &= __ballot_sync(kFull, (rank & 1) == 0);
    rank >>= 1;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
es3d_substep_kernel(const float* __restrict__ e_grid,
                    const float* __restrict__ pos,
                    const float* __restrict__ vel,
                    const float* __restrict__ wts,
                    const int* __restrict__ tile_id,
                    float* __restrict__ pos_out, float* __restrict__ vel_out,
                    float* __restrict__ rho,
                    unsigned char* __restrict__ in_win, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int wx = p.tile_x + 2 * p.margin + 1;
  const int wy = p.tile_y + 2 * p.margin + 1;
  const int wz = p.tile_z + 2 * p.margin + 1;
  const int wn = wx * wy * wz;
  // [E window (wx, wy, wz, 3)] [rho (wx, wy, wz)]
  float* e_s = smem;
  float* rho_s = smem + 3 * wn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_rows = (int64_t)p.n_blocks * p.block;

  const int t = blockIdx.x;
  if (t >= p.n_tiles) {  // the sentinel blocks come back as given
    const int b_sent = block_lower_bound(tile_id, p.block, p.n_blocks,
                                         p.n_tiles);
    const int64_t first = (int64_t)b_sent * p.block;
    const int64_t step = (int64_t)kSentinelCtas * kThreads;
    const int64_t me = (int64_t)(t - p.n_tiles) * kThreads + threadIdx.x;
    for (int64_t f = 3 * first + me; f < 3 * n_rows; f += step) {
      pos_out[f] = pos[f];
      vel_out[f] = vel[f];
    }
    for (int64_t row = first + me; row < n_rows; row += step) in_win[row] = 0;
    return;
  }
  const int b_lo = block_lower_bound(tile_id, p.block, p.n_blocks, t);
  const int b_hi = block_lower_bound(tile_id, p.block, p.n_blocks, t + 1);
  if (b_lo == b_hi) return;  // an empty tile

  // the tile index unrolls z fastest
  const int oz = (t % p.ntz) * p.tile_z - p.margin;
  const int oy = ((t / p.ntz) % p.nty) * p.tile_y - p.margin;
  const int ox = (t / (p.ntz * p.nty)) * p.tile_x - p.margin;
  // the E window at the wrapped grid index of each window cell: a warp
  // copies a window row (i, j), its lanes the row's 3 * wz floats
  for (int r = warp; r < wx * wy; r += kWarps) {
    const int i = r / wy, j = r - i * wy;
    const float* src = e_grid + ((size_t)wrap_near(ox + i, nx) * ny
                                 + wrap_near(oy + j, ny)) * nz * 3;
    float* dst = e_s + (size_t)r * wz * 3;
    for (int f = lane; f < 3 * wz; f += 32) {
      const int l = f / 3;
      cp_async4(dst + f, src + wrap_near(oz + l, nz) * 3 + (f - 3 * l));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int k = threadIdx.x; k < wn; k += kThreads) rho_s[k] = 0.0f;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const float nx_f = (float)nx, ny_f = (float)ny, nz_f = (float)nz;
  const float wx1 = (float)(wx - 1), wy1 = (float)(wy - 1),
              wz1 = (float)(wz - 1);
  const float ox_f = (float)ox, oy_f = (float)oy, oz_f = (float)oz;
  const int sx = wy * wz;
  // this warp's chunks of 32 rows: a contiguous eighth of the tile
  const int64_t row_begin = (int64_t)b_lo * p.block;
  const int64_t row_end = (int64_t)b_hi * p.block;
  const int64_t n_chunks = (row_end - row_begin + 31) / 32;
  const int64_t warp_end =
      row_begin + 32 * (n_chunks * (warp + 1) / kWarps);
  float cur[7], nxt[7];  // position, velocity, weight of this lane's row
  int64_t row = row_begin + 32 * (n_chunks * warp / kWarps) + lane;
  if (row < row_end) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      cur[a] = pos[3 * row + a];
      cur[3 + a] = vel[3 * row + a];
    }
    cur[6] = wts[row];
  }

  for (; row - lane < warp_end; row += 32) {
    const int64_t next = row + 32;
    if (next - lane < warp_end && next < row_end) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        nxt[a] = pos[3 * next + a];
        nxt[3 + a] = vel[3 * next + a];
      }
      nxt[6] = wts[next];
    }
    const bool active = row < row_end;
    const float px = cur[0], py = cur[1], pz = cur[2];
    const float vx = cur[3], vy = cur[4], vz = cur[5];
    const float w = active ? cur[6] : 0.0f;
    const bool valid = w != 0.0f;
    const float lx = floor_mod(px - ox_f, nx_f);
    const float ly = floor_mod(py - oy_f, ny_f);
    const float lz = floor_mod(pz - oz_f, nz_f);
    bool inw = active && lx < wx1 && ly < wy1 && lz < wz1;
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
        const int c0 = ((int)fi * wy + (int)fj) * wz + (int)fk;
        // the corners [x][y][z], z fastest
        const int off[8] = {0, 1, wz, wz + 1, sx, sx + 1, sx + wz,
                            sx + wz + 1};
        float3 q[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float* e = e_s + 3 * (c0 + off[a]);
          q[a] = make_float3(e[0], e[1], e[2]);  // the corner reads
        }
        const float e0x = c00 * q[0].x + c01 * q[1].x + c10 * q[2].x
                        + c11 * q[3].x;
        const float e0y = c00 * q[0].y + c01 * q[1].y + c10 * q[2].y
                        + c11 * q[3].y;
        const float e0z = c00 * q[0].z + c01 * q[1].z + c10 * q[2].z
                        + c11 * q[3].z;
        const float e1x = c00 * q[4].x + c01 * q[5].x + c10 * q[6].x
                        + c11 * q[7].x;
        const float e1y = c00 * q[4].y + c01 * q[5].y + c10 * q[6].y
                        + c11 * q[7].y;
        const float e1z = c00 * q[4].z + c01 * q[5].z + c10 * q[6].z
                        + c11 * q[7].z;
        ex = ax0 * e0x + ax1 * e1x;
        ey = ax0 * e0y + ax1 * e1y;
        ez = ax0 * e0z + ax1 * e1z;
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

    // the deposit: the 8 corner values of each charged row, summed over the
    // warp's rows of the same cell, added by the group's lowest lane
    const bool dep = inw && valid;
    if (__any_sync(kFull, dep)) {
      float d[8];
      int cell = -1 - lane;  // uncharged rows: groups of one
      if (dep) {
        const float fi = floorf(nlx), fj = floorf(nly), fk = floorf(nlz);
        const float bx0 = 1.0f - (nlx - fi), bx1 = 1.0f - ((fi + 1.0f) - nlx);
        const float by0 = 1.0f - (nly - fj), by1 = 1.0f - ((fj + 1.0f) - nly);
        const float bz0 = 1.0f - (nlz - fk), bz1 = 1.0f - ((fk + 1.0f) - nlz);
        const float d00 = (by0 * bz0) * w, d01 = (by0 * bz1) * w;
        const float d10 = (by1 * bz0) * w, d11 = (by1 * bz1) * w;
        d[0] = bx0 * d00; d[1] = bx0 * d01; d[2] = bx0 * d10;
        d[3] = bx0 * d11; d[4] = bx1 * d00; d[5] = bx1 * d01;
        d[6] = bx1 * d10; d[7] = bx1 * d11;
        cell = ((int)fi * wy + (int)fj) * wz + (int)fk;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] = 0.0f;
      }
      const unsigned peers = __match_any_sync(kFull, cell);
      sum_peers(peers, lane, d);
      if (dep && lane == __ffs(peers) - 1) {
        float* c0 = rho_s + cell;
        float* c1 = c0 + sx;
        atomicAdd(c0, d[0]);
        atomicAdd(c0 + 1, d[1]);
        atomicAdd(c0 + wz, d[2]);
        atomicAdd(c0 + wz + 1, d[3]);
        atomicAdd(c1, d[4]);
        atomicAdd(c1 + 1, d[5]);
        atomicAdd(c1 + wz, d[6]);
        atomicAdd(c1 + wz + 1, d[7]);
      }
    }

    if (active) {
      pos_out[3 * row] = floor_mod((inw ? nlx : lx) + ox_f, nx_f);
      pos_out[3 * row + 1] = floor_mod((inw ? nly : ly) + oy_f, ny_f);
      pos_out[3 * row + 2] = floor_mod((inw ? nlz : lz) + oz_f, nz_f);
      vel_out[3 * row] = inw ? nvx : vx;
      vel_out[3 * row + 1] = inw ? nvy : vy;
      vel_out[3 * row + 2] = inw ? nvz : vz;
      in_win[row] = inw ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) cur[k] = nxt[k];
  }

  // rho, once a tile: the window's nonzero cells onto the periodic grid
  __syncthreads();
  for (int k = threadIdx.x; k < wn; k += kThreads) {
    const float val = rho_s[k];
    if (val != 0.0f) {
      const int i = k / sx, rem = k - i * sx;
      const int j = rem / wz, l = rem - j * wz;
      atomicAdd(&rho[((size_t)wrap_near(ox + i, nx) * ny
                      + wrap_near(oy + j, ny)) * nz + wrap_near(oz + l, nz)],
                val);
    }
  }
}

}  // namespace

// Shared memory (bytes) a launch with this window takes.
extern "C" long long es3d_substep_smem(int wx, int wy, int wz) {
  return (long long)smem_bytes(wx, wy, wz);
}

// Launches the substep on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, and a synchronize does not report it).
// Device pointers: e_grid (nx, ny, nz, 3) f32, pos/vel/pos_out/vel_out
// (n_rows, 3) f32, wts (n_rows,) f32, tile_id (n_rows,) int32 with the
// blocks sorted by tile id, rho (nx, ny, nz) f32 zeroed, in_win (n_rows,)
// bytes.  n_rows is a multiple of block.
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
  const size_t smem = smem_bytes(tile_x + 2 * margin + 1,
                                 tile_y + 2 * margin + 1,
                                 tile_z + 2 * margin + 1);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        es3d_substep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  es3d_substep_kernel<<<n_tiles + kSentinelCtas, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const float*)e_grid, (const float*)pos, (const float*)vel,
      (const float*)wts, (const int*)tile_id, (float*)pos_out,
      (float*)vel_out, (float*)rho, (unsigned char*)in_win, p);
  return (int)cudaGetLastError();
}

extern "C" const char* es3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
