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
// model re-pushes it exactly (spill patch).  An invalid row carries no
// charge but is pushed like any other.  Rows of blocks carrying the
// sentinel tile id (n_tiles) come back exactly as given, in_win = 0.
//
// Design (the tile-owned form of em3d_substep.cu and es3d_substep.cu):
//
// * One CTA owns one whole tile.  It finds the tile's blocks (sorted by
//   tile id, as the layout and its repair keep them) by a parallel search
//   over the blocks' first tile ids inside the kernel: no extra launch, no
//   host read.  Trailing CTAs copy the sentinel blocks.  The CTA
//   accumulates the tile's current in a shared (wr, wz, 3) J window and
//   flushes it once, at its end, onto the periodic grid with global
//   atomics (nonzero values only).  (The older form walked 4 blocks a CTA
//   and flushed every tile ~10 times, ~0.8 global atomics a row; k CTAs a
//   tile, or a cluster of them summing their windows through distributed
//   shared memory, were slower at both EM rungs.)  Of 256 and 512 threads
//   a CTA the launch takes the fewer that keeps the most threads resident
//   on an SM: 512 at tile 32 / margin 6, 256 at tile 16 / margin 7.
// * The tile's (wr, wz, 6) field window (48.6 KB at tile 32, margin 6) is
//   staged once a CTA with 8-byte cp.async copies at the wrapped grid index
//   of every window cell, while J is zeroed; the corner reads then come
//   from shared memory (through L1, the lanes of a warp sit in different
//   cells and a warp-wide load touched up to 32 lines).  A window whose
//   fields do not fit beside J reads its corners through L1 (kStaged
//   false).
// * Each warp walks its own contiguous share of the CTA's rows, 32 at a
//   time, and loads the next 32 rows while it works on the current ones.
// * The deposit.  A float add to shared memory is a compare-and-swap loop
//   on Hopper (ATOMS.CAST.SPIN).  A row whose l0 and l1 share a cell on
//   both axes (all but ~2% at 0.01 cells a step) has 8 known nonzero
//   values, in closed form.  The lanes are grouped by that cell
//   (__match_any_sync), each group's 8 values are summed by a tree of
//   shuffles and its lowest lane alone makes the 8 shared adds.  The EM 2D
//   fused shell orders each tile's rows by cell, so a warp's 32 rows lie
//   mostly in one or two cells; on rows in no order the groups are single
//   lanes.  Any other charged row waits in its warp's shared queue,
//   and the warp drains 32 queued rows at once through the general span
//   loop (nodes floor(min(l0, l1)) .. floor(max(l0, l1)) + 1 of each
//   axis), so one slow lane does not hold its warp in the loop.
//
// Arithmetic.  Built with -fmad=false; IEEE division and square root; every
// value keeps the operation order of the plain PyTorch version
// (ops/fused_em.py), so positions, velocities and in_win match it bit for
// bit; J differs by the order of its sums and, for in-cell rows, by the
// rounding of the closed form (within 1e-5 of max|J|).  floor_mod reproduces
// torch.remainder/jnp.mod, including mod(-tiny, n) == n; inside (-n, 2n) it
// takes the one subtraction or addition that fmodf's result comes to
// (exact there), and fmodf outside.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory.  Each row reads
// position, velocity and valid (21 B) and writes position, velocity and
// in_win (21 B): 42 B a row, about 0.13 ms a launch at 10.26 M rows with
// the table read and J written once, against ~300 f32 operations a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueue = 64;           // queued rows a warp (5 floats each)
constexpr int kSentinelCtas = 128;   // CTAs that copy the sentinel blocks
constexpr size_t kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int n_blocks, block, nr, nz, ntz, n_tiles, tile_r, tile_z, margin;
  int relativistic;
  float h, dt, inv_dx, inv_dz, coef_x, coef_z, inv_vol, inv_c2, charge;
};

// Shared memory of a launch: the staged field window (6 floats a cell),
// the current window (3 a cell) and the warps' queues.
size_t smem_bytes(int wr, int wz, int threads, bool staged) {
  const size_t wn = (size_t)wr * wz;
  return sizeof(float) * ((staged ? 9 : 3) * wn
                          + (size_t)(threads / 32) * 5 * kQueue);
}

// A launch's shared memory with `threads` a CTA: staged where the field
// window fits beside J, else the form that reads the corners through L1.
size_t form_smem(int wr, int wz, int threads) {
  const size_t staged = smem_bytes(wr, wz, threads, true);
  return staged <= kSmemLimit ? staged : smem_bytes(wr, wz, threads, false);
}

// The threads a CTA: of 256 and 512, the fewer that keeps the most
// threads resident on an SM (64 registers a thread: 1024 at most).
int cta_threads(int wr, int wz) {
  int threads = 256, resident = 0;
  for (int t = 256; t <= 512; t *= 2) {
    int ctas = (int)(kSmemLimit / form_smem(wr, wz, t));
    if (ctas > 1024 / t) ctas = 1024 / t;
    if (ctas * t > resident) {
      threads = t;
      resident = ctas * t;
    }
  }
  return threads;
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

// a corner's (E|B pair) from the staged window or, unstaged, through L1
template <bool kStaged>
__device__ __forceinline__ float2 corner(const float2* q) {
  if constexpr (kStaged) {
    return *q;
  } else {
    return __ldg(q);
  }
}

// The first block b in [0, n_blocks] whose first row's tile id is >=
// target (blocks sorted by tile id).  Every thread calls it; each round
// probes kThreads evenly spaced blocks, two rounds at the main path.
template <int kThreads>
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

// Esirkepov for the motion l0 -> l1 over the window nodes it touches
__device__ void deposit_span(float* j_s, float l0r, float l0z, float l1r,
                             float l1z, float qcx, float qcz, float qvz,
                             int wr, int wz) {
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

// The same deposit for a row whose l0 and l1 share the window cell (ci, cj),
// in closed form on the exact fractions x = l_r - ci, z = l_z - cj: the
// tents of nodes ci and ci + 1 are 1 - x and x, the cumulative tent of node
// ci is x0 - x1 and that of ci + 1 is 0 (both clips are 1); the same for z.
// So Jx lives on node ci, Jy on node cj and Jz on all four: d = Jx (ci, cj),
// (ci, cj + 1); Jy (ci, cj), (ci + 1, cj); Jz (ci, cj), (ci, cj + 1),
// (ci + 1, cj), (ci + 1, cj + 1).  The span loop's values up to rounding
// (~40 operations instead of ~150 with two divisions).
__device__ __forceinline__ void cell_values(float l0r, float l0z, float l1r,
                                            float l1z, float ci, float cj,
                                            float qcx, float qcz, float qvz,
                                            float (&d)[8]) {
  const float x0 = l0r - ci, x1 = l1r - ci, z0 = l0z - cj, z1 = l1z - cj;
  const float dx = x1 - x0, dz = z1 - z0;
  // S0 + dS/2 of the r nodes (1 - xm, xm) and of the z nodes (1 - zm, zm)
  const float xm = 0.5f * (x0 + x1), zm = 0.5f * (z0 + z1);
  // S0/2 + dS/3 of the r nodes: (0.5 - t, t)
  const float t = 0.5f * x0 + dx * (1.0f / 3.0f);
  const float ax = -qcx * dx, by_ = -qcz * dz;
  const float q0 = qvz * (1.0f - xm), q1 = qvz * xm;
  const float r0 = qvz * (0.5f - t) * dz, r1 = qvz * t * dz;
  d[0] = ax * (1.0f - zm);
  d[1] = ax * zm;
  d[2] = (1.0f - xm) * by_;
  d[3] = xm * by_;
  d[4] = q0 * (1.0f - z0) - r0;
  d[5] = q0 * z0 + r0;
  d[6] = q1 * (1.0f - z0) - r1;
  d[7] = q1 * z0 + r1;
}

// adds window value k of the (wr, wz, 3) window at (otr, otz) onto the
// periodic J grid
__device__ __forceinline__ void add_to_grid(float* __restrict__ j_grid,
                                            int k, float val, int wz,
                                            int otr, int otz, int nr,
                                            int nz) {
  const int cell = k / 3, c = k - cell * 3;
  const int i = cell / wz, j = cell - i * wz;
  atomicAdd(&j_grid[(wrap_near(otr + i, nr) * nz + wrap_near(otz + j, nz))
                    * 3 + c], val);
}

template <int kThreads, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
em2d_substep_kernel(const float2* __restrict__ table,
                    const float2* __restrict__ pos,
                    const float* __restrict__ vel,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ tile_id,
                    float2* __restrict__ pos_out,
                    float* __restrict__ vel_out,
                    float* __restrict__ j_grid,
                    unsigned char* __restrict__ in_win, const Params p) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const int nr = p.nr, nz = p.nz;
  const int wr = p.tile_r + 2 * p.margin + 1;
  const int wz = p.tile_z + 2 * p.margin + 1;
  const int wn = wr * wz, wn3 = 3 * wn;
  // [field window (wr, wz, 3) float2 when staged] [J (wr, wz, 3)] [queues]
  float2* f_s = reinterpret_cast<float2*>(smem);
  float* j_s = smem + (kStaged ? 6 * wn : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wq = j_s + wn3 + warp * 5 * kQueue;  // this warp's queue, by column
  const int64_t n_rows = (int64_t)p.n_blocks * p.block;

  const int t = blockIdx.x;
  if (t >= p.n_tiles) {  // the sentinel blocks come back as given
    const int b_sent = block_lower_bound<kThreads>(tile_id, p.block,
                                                   p.n_blocks, p.n_tiles);
    for (int64_t row = (int64_t)b_sent * p.block
                       + (int64_t)(t - p.n_tiles) * kThreads + threadIdx.x;
         row < n_rows; row += (int64_t)kSentinelCtas * kThreads) {
      pos_out[row] = pos[row];
      vel_out[3 * row] = vel[3 * row];
      vel_out[3 * row + 1] = vel[3 * row + 1];
      vel_out[3 * row + 2] = vel[3 * row + 2];
      in_win[row] = 0;
    }
    return;
  }
  const int b_lo = block_lower_bound<kThreads>(tile_id, p.block, p.n_blocks,
                                               t);
  const int b_hi = block_lower_bound<kThreads>(tile_id, p.block, p.n_blocks,
                                               t + 1);
  if (b_lo == b_hi) return;  // an empty tile

  const int otr = (t / p.ntz) * p.tile_r - p.margin;
  const int otz = (t % p.ntz) * p.tile_z - p.margin;
  if constexpr (kStaged) {
    // the field window at the wrapped grid index of each window cell
    for (int c = threadIdx.x; c < wn; c += kThreads) {
      const int i = c / wz, j = c - i * wz;
      const float2* src = table + ((size_t)wrap_near(otr + i, nr) * nz
                                   + wrap_near(otz + j, nz)) * 3;
      cp_async8(f_s + 3 * c, src);
      cp_async8(f_s + 3 * c + 1, src + 1);
      cp_async8(f_s + 3 * c + 2, src + 2);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = threadIdx.x; k < wn3; k += kThreads) j_s[k] = 0.0f;
  if constexpr (kStaged) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const float nr_f = (float)nr, nz_f = (float)nz;
  const float wr1 = (float)(wr - 1), wz1 = (float)(wz - 1);
  const float otr_f = (float)otr, otz_f = (float)otz;
  const float h = p.h;
  const float q = p.charge;
  const float qcx = q * p.coef_x, qcz = q * p.coef_z;
  // this warp's contiguous share of the tile's chunks of 32 rows
  const int64_t tile_begin = (int64_t)b_lo * p.block;
  const int64_t tile_end = (int64_t)b_hi * p.block;
  const int64_t n_chunks = (tile_end - tile_begin + 31) / 32;
  const int64_t warp_end = tile_begin + 32 * (n_chunks * (warp + 1) / kWarps);
  int64_t row = tile_begin + 32 * (n_chunks * warp / kWarps) + lane;
  // position (2), velocity (3) and valid (0 or 1) of this lane's row, and
  // of its row 32 on
  float cur[6], nxt[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cur[k] = nxt[k] = 0.0f;
  if (row - lane < warp_end && row < tile_end) {
    const float2 x = pos[row];
    cur[0] = x.x;
    cur[1] = x.y;
    cur[2] = vel[3 * row];
    cur[3] = vel[3 * row + 1];
    cur[4] = vel[3 * row + 2];
    cur[5] = valid[row] ? 1.0f : 0.0f;
  }
  int n_queued = 0;  // this warp's queued rows (the same in every lane)

  for (; row - lane < warp_end; row += 32) {
    const int64_t next = row + 32;
    if (next - lane < warp_end && next < tile_end) {
      const float2 x = pos[next];
      nxt[0] = x.x;
      nxt[1] = x.y;
      nxt[2] = vel[3 * next];
      nxt[3] = vel[3 * next + 1];
      nxt[4] = vel[3 * next + 2];
      nxt[5] = valid[next] ? 1.0f : 0.0f;
    }
    const bool active = row < tile_end;
    const float vx = cur[2], vy = cur[3], vz = cur[4];
    const float l0r = floor_mod(cur[0] - otr_f, nr_f);
    const float l0z = floor_mod(cur[1] - otz_f, nz_f);
    bool inw = active && l0r < wr1 && l0z < wz1;
    float l1r = l0r, l1z = l0z, nvx = vx, nvy = vy, nvz = vz, cvz = 0.0f;
    const float fi = floorf(l0r), fj = floorf(l0z);

    if (inw) {
      // 6-channel CIC gather, r first and then z
      const float ar0 = 1.0f - (l0r - fi);
      const float ar1 = 1.0f - ((fi + 1.0f) - l0r);
      const float az0 = 1.0f - (l0z - fj);
      const float az1 = 1.0f - ((fj + 1.0f) - l0z);
      const float2 *c00, *c10, *c01, *c11;
      if constexpr (kStaged) {
        c00 = f_s + ((int)fi * wz + (int)fj) * 3;
        c10 = c00 + 3 * wz;
        c01 = c00 + 3;
        c11 = c10 + 3;
      } else {
        const int gi = wrap_near(otr + (int)fi, nr);
        const int gj = wrap_near(otz + (int)fj, nz);
        const int gi1 = gi + 1 == nr ? 0 : gi + 1;
        const int gj1 = gj + 1 == nz ? 0 : gj + 1;
        c00 = table + (gi * nz + gj) * 3;
        c10 = table + (gi1 * nz + gj) * 3;
        c01 = table + (gi * nz + gj1) * 3;
        c11 = table + (gi1 * nz + gj1) * 3;
      }
      float eb[6];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2 w00 = corner<kStaged>(c00 + c);
        const float2 w10 = corner<kStaged>(c10 + c);
        const float2 w01 = corner<kStaged>(c01 + c);
        const float2 w11 = corner<kStaged>(c11 + c);
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

    const bool dep = inw && cur[5] != 0.0f;
    const float qvz = q * cvz * p.inv_vol;
    const bool in_cell = dep && floorf(l1r) == fi && floorf(l1z) == fj;
    // the in-cell rows: 8 values each, summed over the warp's rows of one
    // cell, added by the group's lowest lane
    if (__any_sync(kFull, in_cell)) {
      float d[8];
      int key = -1 - lane;  // the other rows: groups of one
      if (in_cell) {
        cell_values(l0r, l0z, l1r, l1z, fi, fj, qcx, qcz, qvz, d);
        key = (int)fi * wz + (int)fj;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] = 0.0f;
      }
      const unsigned peers = __match_any_sync(kFull, key);
      sum_peers(peers, lane, d);
      if (in_cell && lane == __ffs(peers) - 1) {
        float* c0 = j_s + key * 3;
        float* c1 = c0 + 3 * wz;
        atomicAdd(c0, d[0]);
        atomicAdd(c0 + 3, d[1]);
        atomicAdd(c0 + 1, d[2]);
        atomicAdd(c1 + 1, d[3]);
        atomicAdd(c0 + 2, d[4]);
        atomicAdd(c0 + 5, d[5]);
        atomicAdd(c1 + 2, d[6]);
        atomicAdd(c1 + 5, d[7]);
      }
    }

    if (active) {
      pos_out[row] = make_float2(floor_mod((inw ? l1r : l0r) + otr_f, nr_f),
                                 floor_mod((inw ? l1z : l0z) + otz_f, nz_f));
      vel_out[3 * row] = inw ? nvx : vx;
      vel_out[3 * row + 1] = inw ? nvy : vy;
      vel_out[3 * row + 2] = inw ? nvz : vz;
      in_win[row] = inw ? 1 : 0;
    }

    // the other charged rows wait in the warp's queue; 32 of them are
    // deposited together
    const bool queue = dep && !in_cell;
    const unsigned mask = __ballot_sync(kFull, queue);
    if (queue) {
      const int slot = n_queued + __popc(mask & ((1u << lane) - 1u));
      wq[slot] = l0r;
      wq[kQueue + slot] = l0z;
      wq[2 * kQueue + slot] = l1r;
      wq[3 * kQueue + slot] = l1z;
      wq[4 * kQueue + slot] = qvz;
    }
    n_queued += __popc(mask);
    __syncwarp();
    if (n_queued >= 32) {
      const int e = n_queued - 32 + lane;
      deposit_span(j_s, wq[e], wq[kQueue + e], wq[2 * kQueue + e],
                   wq[3 * kQueue + e], qcx, qcz, wq[4 * kQueue + e], wr, wz);
      n_queued -= 32;
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) cur[k] = nxt[k];
  }
  if (lane < n_queued) {
    deposit_span(j_s, wq[lane], wq[kQueue + lane], wq[2 * kQueue + lane],
                 wq[3 * kQueue + lane], qcx, qcz, wq[4 * kQueue + lane], wr,
                 wz);
  }

  // J, once a tile: the window's nonzero values onto the periodic grid
  __syncthreads();
  for (int k = threadIdx.x; k < wn3; k += kThreads) {
    const float val = j_s[k];
    if (val != 0.0f) add_to_grid(j_grid, k, val, wz, otr, otz, nr, nz);
  }
}

template <int kThreads, bool kStaged>
int launch(const void* table, const void* pos, const void* vel,
           const void* valid, const void* tile_id, void* pos_out,
           void* vel_out, void* j_grid, void* in_win, const Params& p,
           size_t smem, cudaStream_t stream) {
  auto kernel = em2d_substep_kernel<kThreads, kStaged>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<p.n_tiles + kSentinelCtas, kThreads, smem, stream>>>(
      (const float2*)table, (const float2*)pos, (const float*)vel,
      (const unsigned char*)valid, (const int*)tile_id, (float2*)pos_out,
      (float*)vel_out, (float*)j_grid, (unsigned char*)in_win, p);
  return (int)cudaGetLastError();
}

template <int kThreads>
int launch_form(const void* table, const void* pos, const void* vel,
                const void* valid, const void* tile_id, void* pos_out,
                void* vel_out, void* j_grid, void* in_win, const Params& p,
                cudaStream_t stream) {
  const int wr = p.tile_r + 2 * p.margin + 1;
  const int wz = p.tile_z + 2 * p.margin + 1;
  const size_t smem = form_smem(wr, wz, kThreads);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem == smem_bytes(wr, wz, kThreads, true)) {
    return launch<kThreads, true>(table, pos, vel, valid, tile_id, pos_out,
                                  vel_out, j_grid, in_win, p, smem, stream);
  }
  return launch<kThreads, false>(table, pos, vel, valid, tile_id, pos_out,
                                 vel_out, j_grid, in_win, p, smem, stream);
}

}  // namespace

// Shared memory (bytes) a launch with this window takes, or -1 where
// neither form fits in the shared memory a block can use.
extern "C" long long em2d_substep_smem(int wr, int wz) {
  const size_t smem = form_smem(wr, wz, cta_threads(wr, wz));
  return smem > kSmemLimit ? -1 : (long long)smem;
}

// Launches the substep on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, and a synchronize does not report
// it).  Device pointers: table (nr, nz, 6) f32, pos/pos_out (n_rows, 2)
// f32, vel/vel_out (n_rows, 3) f32, valid and in_win (n_rows,) bytes,
// tile_id (n_rows,) int32 with the blocks sorted by tile id, j_grid
// (nr, nz, 3) f32 zeroed.  n_rows is a multiple of block.
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
  cudaStream_t st = (cudaStream_t)stream;
  if (cta_threads(tile_r + 2 * margin + 1, tile_z + 2 * margin + 1) == 256) {
    return launch_form<256>(table, pos, vel, valid, tile_id, pos_out,
                            vel_out, j_grid, in_win, p, st);
  }
  return launch_form<512>(table, pos, vel, valid, tile_id, pos_out, vel_out,
                          j_grid, in_win, p, st);
}

extern "C" const char* em2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
