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
// Design.  Read through L1, a row's 8 corner cells are 24 float2 loads in
// which the lanes of a warp sit on different cells, so each warp-wide load
// touches up to 32 L1 lines; so the corner reads come from shared memory:
//
// * One CTA owns one whole tile.  It finds the tile's blocks (sorted by tile
//   id, as the layout and its repair keep them) by a parallel search over
//   the blocks' first tile ids inside the kernel: no extra launch, no host
//   read.  Trailing CTAs copy the sentinel blocks.
// * It stages the tile's (wx, wy, wz, 6) field window (52.7 KB at tile 8^3,
//   margin 2) into shared memory with 8-byte cp.async copies at the wrapped
//   grid index of every window cell (the window wraps at the periodic edge),
//   while it zeroes its (wx, wy, wz, 3) current window (26.4 KB).  Two CTAs
//   share an SM, so one CTA's fill overlaps the other's rows; the fill is
//   paid once a tile (~7,800 rows at the main path), and J is flushed once a
//   tile onto the periodic grid with global atomics (nonzero values only).
//   A window whose fields do not fit beside J reads its corners through L1
//   as before (kStaged false).
// * A row whose l0 and l1 share a cell on every axis (all rows but ~3% at
//   0.01 cells a step) deposits with a fixed, unrolled 2 x 2 x 2 stencil:
//   12 known nonzero values, predicated.  Any other charged row is queued in
//   its warp's shared-memory queue, and a warp drains 32 queued rows at once
//   through the general span loop (nodes floor(min(l0, l1)) ..
//   floor(max(l0, l1)) + 1 of each axis), so one slow lane no longer holds
//   its warp in the loop.  Each value's arithmetic is the plain version's;
//   only the order of the shared and global atomic sums changes.
//
// What bounds it now: the deposit.  A float add to shared memory is a
// compare-and-swap loop on this card (ATOMS.CAST.SPIN in the SASS); the
// 12 adds a row take about half the kernel's time (examples/kernel_pair.py
// --ablate switches the deposit off).  In variant timings an integer add in
// its place, which is native, was much faster, and a hand-written batch of
// 12 concurrent CAS operations slower than the hardware's loop.
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

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;           // queued rows a warp (6 floats each)
constexpr int kSentinelCtas = 128;   // CTAs that copy the sentinel blocks
constexpr size_t kSmemLimit = 232448;

struct Params {
  int n_blocks, block;
  int nx, ny, nz, nty, ntz, n_tiles, tile_x, tile_y, tile_z, margin;
  int relativistic;
  float h, dt, inv_dx, inv_dy, inv_dz, coef_x, coef_y, coef_z, inv_c2, charge;
};

// Shared memory of a launch: the staged field window (6 floats a cell),
// the current window (3 a cell) and the warps' queues.
size_t smem_bytes(int wx, int wy, int wz, bool staged) {
  const size_t wn = (size_t)wx * wy * wz;
  return sizeof(float) * ((staged ? 9 : 3) * wn + kWarps * 6 * kQueue);
}

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

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
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

// Esirkepov for the motion l0 -> l1 over the window nodes it touches
__device__ void deposit_span(float* j_s, float l0x, float l0y, float l0z,
                             float l1x, float l1y, float l1z, float qcx,
                             float qcy, float qcz, int wx, int wy, int wz) {
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

// The same deposit for a row whose l0 and l1 share the cell (ci, cj, ck) on
// every axis: nodes c and c + 1 of each axis, where the cumulative tent of
// node c + 1 is exactly 0 (both clips are 1), so jx lives on the x node ci,
// jy on the y node cj and jz on the z node ck: 12 values.
__device__ __forceinline__ void deposit_cell(float* j_s, float l0x, float l0y,
                                             float l0z, float l1x, float l1y,
                                             float l1z, int ci, int cj, int ck,
                                             float qcx, float qcy, float qcz,
                                             int wy, int wz) {
  float s0x[2], dsx[2], p1x[2], p2x[2], s0y[2], dsy[2], m1y[2], m2y[2];
  float s0z[2], dsz[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float nx_ = (float)(ci + a), ny_ = (float)(cj + a),
                nz_ = (float)(ck + a);
    s0x[a] = tent(l0x, nx_);
    dsx[a] = tent(l1x, nx_) - s0x[a];
    p1x[a] = s0x[a] + 0.5f * dsx[a];
    p2x[a] = 0.5f * s0x[a] + dsx[a] / 3.0f;
    s0y[a] = tent(l0y, ny_);
    dsy[a] = tent(l1y, ny_) - s0y[a];
    m1y[a] = s0y[a] + 0.5f * dsy[a];
    m2y[a] = 0.5f * s0y[a] + dsy[a] / 3.0f;
    s0z[a] = tent(l0z, nz_);
    dsz[a] = tent(l1z, nz_) - s0z[a];
  }
  const float kxq = qcx * cum_tent(l0x, l1x, (float)ci);
  const float kyq = qcy * cum_tent(l0y, l1y, (float)cj);
  const float kzq = qcz * cum_tent(l0z, l1z, (float)ck);
  const int sy = wz * 3, sx = wy * wz * 3;
  float val[12];
  int off[12];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int n = 2 * a + b;
      // jx at (ci, cj + a, ck + b)
      val[n] = kxq * (m1y[a] * s0z[b] + m2y[a] * dsz[b]);
      off[n] = a * sy + b * 3;
      // jy at (ci + a, cj, ck + b)
      val[4 + n] = p1x[a] * (kyq * s0z[b]) + p2x[a] * (kyq * dsz[b]);
      off[4 + n] = a * sx + b * 3 + 1;
      // jz at (ci + a, cj + b, ck)
      val[8 + n] = p1x[a] * (kzq * s0y[b]) + p2x[a] * (kzq * dsy[b]);
      off[8 + n] = a * sx + b * sy + 2;
    }
  }
  float* c0 = j_s + ((ci * wy + cj) * wz + ck) * 3;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    if (val[i] != 0.0f) atomicAdd(c0 + off[i], val[i]);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
em3d_substep_kernel(const float* __restrict__ table,
                    const float* __restrict__ pos,
                    const float* __restrict__ vel,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ tile_id,
                    float* __restrict__ pos_out, float* __restrict__ vel_out,
                    float* __restrict__ j_grid,
                    unsigned char* __restrict__ in_win, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int wx = p.tile_x + 2 * p.margin + 1;
  const int wy = p.tile_y + 2 * p.margin + 1;
  const int wz = p.tile_z + 2 * p.margin + 1;
  const int wn = wx * wy * wz;
  const int wn3 = wn * 3;
  // [field window (wx, wy, wz, 6) when staged] [J (wx, wy, wz, 3)] [queues]
  float* f_s = smem;
  float* j_s = smem + (kStaged ? 6 * wn : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wq = j_s + wn3 + warp * 6 * kQueue;  // this warp's queue, by column
  const int64_t n_rows = (int64_t)p.n_blocks * p.block;

  const int t = blockIdx.x;
  if (t >= p.n_tiles) {  // the sentinel blocks come back as given
    const int b_sent = block_lower_bound(tile_id, p.block, p.n_blocks,
                                         p.n_tiles);
    for (int64_t row = (int64_t)b_sent * p.block
                       + (int64_t)(t - p.n_tiles) * kThreads + threadIdx.x;
         row < n_rows; row += (int64_t)kSentinelCtas * kThreads) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        pos_out[row * 3 + a] = pos[row * 3 + a];
        vel_out[row * 3 + a] = vel[row * 3 + a];
      }
      in_win[row] = 0;
    }
    return;
  }
  const int b_lo = block_lower_bound(tile_id, p.block, p.n_blocks, t);
  const int b_hi = block_lower_bound(tile_id, p.block, p.n_blocks, t + 1);
  if (b_lo == b_hi) return;  // an empty tile

  // the tile index unrolls z fastest
  const int oz = (t % p.ntz) * p.tile_z - p.margin;
  const int oy = ((t / p.ntz) % p.nty) * p.tile_y - p.margin;
  const int ox = (t / (p.ntz * p.nty)) * p.tile_x - p.margin;
  if constexpr (kStaged) {
    // the field window at the wrapped grid index of each window cell
    for (int c = threadIdx.x; c < wn; c += kThreads) {
      const int i = c / (wy * wz), rem = c - i * (wy * wz);
      const int j = rem / wz, l = rem - j * wz;
      const float* src = table + ((size_t)(wrap(ox + i, nx) * ny
                                           + wrap(oy + j, ny)) * nz
                                  + wrap(oz + l, nz)) * 6;
      cp_async8(f_s + c * 6, src);
      cp_async8(f_s + c * 6 + 2, src + 2);
      cp_async8(f_s + c * 6 + 4, src + 4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = threadIdx.x; k < wn3; k += kThreads) j_s[k] = 0.0f;
  if constexpr (kStaged) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const float nx_f = (float)nx, ny_f = (float)ny, nz_f = (float)nz;
  const float wx1 = (float)(wx - 1), wy1 = (float)(wy - 1),
              wz1 = (float)(wz - 1);
  const float ox_f = (float)ox, oy_f = (float)oy, oz_f = (float)oz;
  const float h = p.h;
  const float q = p.charge;
  const float qcx = q * p.coef_x, qcy = q * p.coef_y, qcz = q * p.coef_z;
  const int64_t row_end = (int64_t)b_hi * p.block;
  int n_queued = 0;  // this warp's queued rows (the same in every lane)

  for (int64_t base = (int64_t)b_lo * p.block; base < row_end;
       base += kThreads) {
    const int64_t row = base + threadIdx.x;
    bool queue = false;
    float l0x = 0.0f, l0y = 0.0f, l0z = 0.0f;
    float l1x = 0.0f, l1y = 0.0f, l1z = 0.0f;
    if (row < row_end) {
      const float px = pos[row * 3], py = pos[row * 3 + 1],
                  pz = pos[row * 3 + 2];
      const float vx = vel[row * 3], vy = vel[row * 3 + 1],
                  vz = vel[row * 3 + 2];
      l0x = floor_mod(px - ox_f, nx_f);
      l0y = floor_mod(py - oy_f, ny_f);
      l0z = floor_mod(pz - oz_f, nz_f);
      bool inw = l0x < wx1 && l0y < wy1 && l0z < wz1;
      l1x = l0x; l1y = l0y; l1z = l0z;
      float nvx = vx, nvy = vy, nvz = vz;
      float fi = 0.0f, fj = 0.0f, fk = 0.0f;

      if (inw) {
        // 6-channel CIC gather: the (y, z) pair first, then x
        fi = floorf(l0x); fj = floorf(l0y); fk = floorf(l0z);
        const float ax0 = 1.0f - (l0x - fi), ax1 = 1.0f - ((fi + 1.0f) - l0x);
        const float ay0 = 1.0f - (l0y - fj), ay1 = 1.0f - ((fj + 1.0f) - l0y);
        const float az0 = 1.0f - (l0z - fk), az1 = 1.0f - ((fk + 1.0f) - l0z);
        const float c00 = ay0 * az0, c01 = ay0 * az1;
        const float c10 = ay1 * az0, c11 = ay1 * az1;
        // the 8 corner cells: [x][y][z]
        const float* q8[2][2][2];
        if constexpr (kStaged) {
          const float* c0 =
              f_s + (((int)fi * wy + (int)fj) * wz + (int)fk) * 6;
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int bb = 0; bb < 2; ++bb)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                q8[a][bb][c] = c0 + ((a * wy + bb) * wz + c) * 6;
        } else {
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
                q8[a][bb][c] =
                    table + ((size_t)(gi[a] * ny + gj[bb]) * nz + gk[c]) * 6;
        }
        float eb[6];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float2 v[2][2][2];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int bb = 0; bb < 2; ++bb)
#pragma unroll
              for (int d = 0; d < 2; ++d) {
                const float2* src =
                    reinterpret_cast<const float2*>(q8[a][bb][d]) + c;
                if constexpr (kStaged) {
                  v[a][bb][d] = *src;
                } else {
                  v[a][bb][d] = __ldg(src);
                }
              }
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
        if (floorf(l1x) == fi && floorf(l1y) == fj && floorf(l1z) == fk) {
          deposit_cell(j_s, l0x, l0y, l0z, l1x, l1y, l1z, (int)fi, (int)fj,
                       (int)fk, qcx, qcy, qcz, wy, wz);
        } else {
          queue = true;
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

    // rows that leave their cell wait in the warp's queue; 32 of them
    // are deposited together
    const unsigned mask = __ballot_sync(0xffffffffu, queue);
    if (queue) {
      const int slot = n_queued + __popc(mask & ((1u << lane) - 1u));
      wq[slot] = l0x;
      wq[kQueue + slot] = l0y;
      wq[2 * kQueue + slot] = l0z;
      wq[3 * kQueue + slot] = l1x;
      wq[4 * kQueue + slot] = l1y;
      wq[5 * kQueue + slot] = l1z;
    }
    n_queued += __popc(mask);
    __syncwarp();
    if (n_queued >= 32) {
      const int e = n_queued - 32 + lane;
      deposit_span(j_s, wq[e], wq[kQueue + e], wq[2 * kQueue + e],
                   wq[3 * kQueue + e], wq[4 * kQueue + e], wq[5 * kQueue + e],
                   qcx, qcy, qcz, wx, wy, wz);
      n_queued -= 32;
      __syncwarp();
    }
  }
  if (lane < n_queued) {
    deposit_span(j_s, wq[lane], wq[kQueue + lane], wq[2 * kQueue + lane],
                 wq[3 * kQueue + lane], wq[4 * kQueue + lane],
                 wq[5 * kQueue + lane], qcx, qcy, qcz, wx, wy, wz);
  }

  __syncthreads();
  flush_window(j_s, j_grid, wn3, wy, wz, ox, oy, oz, nx, ny, nz);
}

template <bool kStaged>
int launch(const void* table, const void* pos, const void* vel,
           const void* valid, const void* tile_id, void* pos_out,
           void* vel_out, void* j_grid, void* in_win, const Params& p,
           size_t smem, cudaStream_t stream) {
  auto kernel = em3d_substep_kernel<kStaged>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<p.n_tiles + kSentinelCtas, kThreads, smem, stream>>>(
      (const float*)table, (const float*)pos, (const float*)vel,
      (const unsigned char*)valid, (const int*)tile_id, (float*)pos_out,
      (float*)vel_out, (float*)j_grid, (unsigned char*)in_win, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) a launch with this window takes: the staged form
// where its field window fits beside J, else the form that reads the
// corners through L1.
extern "C" long long em3d_substep_smem(int wx, int wy, int wz) {
  const size_t staged = smem_bytes(wx, wy, wz, true);
  return (long long)(staged <= kSmemLimit ? staged
                                          : smem_bytes(wx, wy, wz, false));
}

// Launches the substep on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, and a synchronize does not report it).
// Device pointers: table (nx, ny, nz, 6) f32, pos/pos_out and vel/vel_out
// (n_rows, 3) f32, valid and in_win (n_rows,) bytes, tile_id (n_rows,) int32
// with the blocks sorted by tile id, j_grid (nx, ny, nz, 3) f32 zeroed.
// n_rows is a multiple of block.
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
  const int wx = tile_x + 2 * margin + 1, wy = tile_y + 2 * margin + 1,
            wz = tile_z + 2 * margin + 1;
  const size_t staged = smem_bytes(wx, wy, wz, true);
  cudaStream_t st = (cudaStream_t)stream;
  if (staged <= kSmemLimit) {
    return launch<true>(table, pos, vel, valid, tile_id, pos_out, vel_out,
                        j_grid, in_win, p, staged, st);
  }
  const size_t plain = smem_bytes(wx, wy, wz, false);
  if (plain > kSmemLimit) return (int)cudaErrorInvalidValue;
  return launch<false>(table, pos, vel, valid, tile_id, pos_out, vel_out,
                       j_grid, in_win, p, plain, st);
}

extern "C" const char* em3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
