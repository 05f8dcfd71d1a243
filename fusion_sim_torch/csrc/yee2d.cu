// The 2D3V Yee leapfrog (B half step, E full step with J, B half step) in
// one launch, Hopper.
//
// Replaces: no TPU kernel.  The reference's yee_update
// (fusion_sim_tpu/models/electromagnetic.py, ops/fdtd.py) is rolls and
// differences that XLA fuses; the port's plain version
// (ops/yee2d.yee_update_2d_plain: ops/fdtd.advance_b_half, advance_e_full,
// advance_b_half on curl_e_2d / curl_b_2d) runs them on the card as 54
// device operations a step (12 roll, 18 sub, 13 div, 3 neg, 3 stack, 4 mul,
// 1 add), each a launch from Python over a 1 MB component grid at 512^2.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  E, B and J are read once and E
// and B written once, 3 f32 a cell each: 60 B a cell, 15.7 MB or 0.0047 ms
// at 512^2 (port_bench/rooflines/yee_update.py).  The arithmetic, 57 f32
// operations a cell, would take 5% of that time at the card's f32 rate.
//
// Design.  The grid has no third axis to march along, so a CTA owns a tile
// of kTileX grid rows (axis 0) by kTileY cells (axis 1, contiguous) and
// computes it in one pass.  Nothing but E and B goes back to device memory:
// the half-step B (bh) and the new E (en) live in shared memory only.  With
// d/dz = 0 the 2D3V curls reach one neighbour along each axis of the plane:
//
//   B_new at (x, y) needs en at (x, y), (x+1, y), (x, y+1);
//   en at (x, y) needs bh at (x, y), (x-1, y), (x, y-1);
//   bh at (x, y) needs E at (x, y), (x+1, y), (x, y+1).
//
// So E is staged over rows x0-1 .. x0+kTileX+1 and cells y0-1 ..
// y0+kTileY+1 (1 low, 2 high), B over one row and one cell fewer at the far
// side (bh is computed in place there), and J over the tile and one more
// row and cell at the far side (en is computed in place there).  Every CTA
// whose tile borders a halo recomputes it; the halo rows are read once per
// tile that borders them (mostly from L2).  The copies are cp.async.
// Shared rows are padded so that the tile's cells sit on 16-byte
// boundaries: they move as 16-byte words, in and out, where Y is a multiple
// of 4 and the grids are 16-byte aligned, and the halo cells as floats;
// else every float alone.  The periodic wrap is index arithmetic: a table
// of each staged row's and cell's grid index, so a grid of any size, ragged
// or smaller than the halo, is read right; stores are masked to the grid.
// At 512^2: 64 x 8 tiles, 512 CTAs of 24.3 KB, resident in one wave.
//
// Rounding: -fmad=false and the plain version's operation order, term for
// term: ((f[i+1] - f[i]) * inv_d), the negation of curl_e_2d's and
// curl_b_2d's y terms, b - h * curl and e + dt * (c2 * curl_b - j *
// inv_eps0), with the scalars formed as PyTorch's CUDA elementwise kernels
// form them from a Python float: h = f32(0.5 dt), dt, c2 = f32(c c), and a
// division by a Python scalar as a product with its f32 reciprocal, inv_d =
// 1 / f32(d), inv_eps0 = 1 / f32(eps0).  So the kernel equals the plain
// version on the card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 8;   // grid rows (axis 0) a tile
constexpr int kTileY = 64;  // cells of a row (axis 1) a tile
static_assert(kTileY % 4 == 0, "the tile's cells move as 16-byte words");

// A region of the grid in shared memory: kRows grid rows of kLeft + kTileY
// + kRight cells (3 floats each) from cell y0 - kLeft.  Each row starts at
// a multiple of 4 floats and kPad floats of padding put its cell y0 at a
// multiple of 4 too, so the tile's cells move as 16-byte words.
template <int kRows_, int kLeft_, int kRight_>
struct Region {
  static constexpr int kRows = kRows_, kLeft = kLeft_, kRight = kRight_;
  static constexpr int kCells = kLeft + kTileY + kRight;
  static constexpr int kPad = (4 - 3 * kLeft % 4) % 4;
  static constexpr int kStride = (kPad + 3 * kCells + 3) / 4 * 4;
  static constexpr int kFloats = kRows * kStride;
  // the float offset of cell q (q = 0 at y0 - kLeft) of row r
  __device__ static constexpr int at(int r, int q) {
    return r * kStride + kPad + 3 * q;
  }
};
// E at x0-1 .. x0+kTileX+1, y0-1 .. y0+kTileY+1; the half-step B one row
// and one cell fewer at the far side; the new E from x0 and y0, one more
// row and cell than the tile
using RegionE = Region<kTileX + 3, 1, 2>;
using RegionB = Region<kTileX + 2, 1, 1>;
using RegionN = Region<kTileX + 1, 0, 1>;
constexpr size_t kSharedBytes =
    (RegionE::kFloats + RegionB::kFloats + RegionN::kFloats +
     RegionE::kRows + RegionE::kCells) * 4;
static_assert(kSharedBytes <= 48 * 1024, "no opt-in to more shared memory");

struct Coef {
  float h, dt, c2, inv_eps0, inv_dx, inv_dy;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Region R of one grid into dst: row r from grid row xtab[r + r0] (times
// Y), cell q from grid column ytab[q + q0].  With vec (the tile's cells
// whole in the grid, Y a multiple of 4, the grids 16-byte aligned) the
// tile's cells come as 16-byte words and the halo cells as floats; else
// every float alone.
template <class R>
__device__ __forceinline__ void load_region(float* dst, const float* grid,
                                            const int* xtab, const int* ytab,
                                            int r0, int q0, int y0,
                                            bool vec) {
  if (vec) {
    constexpr int kVec = 3 * kTileY / 4;
    constexpr int kItems = kVec + 3 * (R::kLeft + R::kRight);
    for (int t = threadIdx.x; t < R::kRows * kItems; t += kThreads) {
      const int r = t / kItems;
      const int u = t - r * kItems;
      const float* src = grid + xtab[r + r0] * 3;
      if (u < kVec) {
        cp_async16(dst + R::at(r, R::kLeft) + 4 * u, src + y0 * 3 + 4 * u);
      } else {
        const int h = u - kVec;
        const int hc = h / 3;
        const int q = hc < R::kLeft ? hc : kTileY + hc;
        cp_async4(dst + R::at(r, q) + h - 3 * hc,
                  src + ytab[q + q0] * 3 + h - 3 * hc);
      }
    }
    return;
  }
  constexpr int kRow = 3 * R::kCells;
  for (int t = threadIdx.x; t < R::kRows * kRow; t += kThreads) {
    const int r = t / kRow;
    const int i = t - r * kRow;
    const int q = i / 3;
    cp_async4(dst + R::at(r, 0) + i,
              grid + (xtab[r + r0] + ytab[q + q0]) * 3 + i - 3 * q);
  }
}

// Rows r < rows and cells q < cols of the tile in region R, from its row
// r1 and cell kLeft, to the grid at (x0 + r, y0 + q).
template <class R>
__device__ __forceinline__ void store_region(float* grid, const float* src,
                                             int r1, int rows, int cols,
                                             int x0, int y0, int Y,
                                             bool vec) {
  if (vec) {
    constexpr int kVec = 3 * kTileY / 4;
    for (int t = threadIdx.x; t < rows * kVec; t += kThreads) {
      const int r = t / kVec;
      const int u = t - r * kVec;
      *reinterpret_cast<float4*>(grid + ((x0 + r) * Y + y0) * 3 + 4 * u) =
          *reinterpret_cast<const float4*>(src + R::at(r + r1, R::kLeft) +
                                           4 * u);
    }
    return;
  }
  const int row = 3 * cols;
  for (int t = threadIdx.x; t < rows * row; t += kThreads) {
    const int r = t / row;
    const int i = t - r * row;
    grid[((x0 + r) * Y + y0) * 3 + i] = src[R::at(r + r1, R::kLeft) + i];
  }
}

// curl_e_2d's terms at a staged cell p of a region with row stride
// `stride`: its neighbours at x+1 and y+1.
__device__ __forceinline__ void curl_e(const float* p, int stride,
                                       const Coef& k, float& cx, float& cy,
                                       float& cz) {
  const float* px = p + stride;
  const float* py = p + 3;
  cx = (py[2] - p[2]) * k.inv_dy;
  cy = -((px[2] - p[2]) * k.inv_dx);
  cz = ((px[1] - p[1]) * k.inv_dx) - ((py[0] - p[0]) * k.inv_dy);
}

// bh = b - h curl E over region B, in place (it holds B).
__device__ __forceinline__ void half_b(float* bh, const float* e,
                                       const Coef& k) {
  for (int c = threadIdx.x; c < RegionB::kRows * RegionB::kCells;
       c += kThreads) {
    const int r = c / RegionB::kCells;
    const int q = c - r * RegionB::kCells;
    float cx, cy, cz;
    curl_e(e + RegionE::at(r, q), RegionE::kStride, k, cx, cy, cz);
    float* o = bh + RegionB::at(r, q);
    o[0] = o[0] - k.h * cx;
    o[1] = o[1] - k.h * cy;
    o[2] = o[2] - k.h * cz;
  }
}

// en = e + dt (c2 curl bh - j inv_eps0) over region N, in place (it holds
// J).  curl_b_2d's terms: bh's neighbours at x-1 and y-1.
__device__ __forceinline__ void full_e(float* en, const float* bh,
                                       const float* e, const Coef& k) {
  for (int c = threadIdx.x; c < RegionN::kRows * RegionN::kCells;
       c += kThreads) {
    const int r = c / RegionN::kCells;
    const int q = c - r * RegionN::kCells;
    const float* p = bh + RegionB::at(r + 1, q + 1);
    const float* px = p - RegionB::kStride;
    const float* py = p - 3;
    const float cx = (p[2] - py[2]) * k.inv_dy;
    const float cy = -((p[2] - px[2]) * k.inv_dx);
    const float cz = ((p[1] - px[1]) * k.inv_dx) - ((p[0] - py[0]) * k.inv_dy);
    const float* pe = e + RegionE::at(r + 1, q + 1);
    float* o = en + RegionN::at(r, q);
    o[0] = pe[0] + k.dt * ((k.c2 * cx) - (o[0] * k.inv_eps0));
    o[1] = pe[1] + k.dt * ((k.c2 * cy) - (o[1] * k.inv_eps0));
    o[2] = pe[2] + k.dt * ((k.c2 * cz) - (o[2] * k.inv_eps0));
  }
}

// B_new = bh - h curl en over the tile, in place in region B.
__device__ __forceinline__ void new_b(float* bh, const float* en,
                                      const Coef& k) {
  for (int c = threadIdx.x; c < kTileX * kTileY; c += kThreads) {
    const int r = c / kTileY;
    const int q = c - r * kTileY;
    float cx, cy, cz;
    curl_e(en + RegionN::at(r, q), RegionN::kStride, k, cx, cy, cz);
    float* o = bh + RegionB::at(r + 1, q + 1);
    o[0] = o[0] - k.h * cx;
    o[1] = o[1] - k.h * cy;
    o[2] = o[2] - k.h * cz;
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// blockIdx.x: the (x, y) tile, y fastest.
__global__ void __launch_bounds__(kThreads)
    yee2d_kernel(const float* __restrict__ e, const float* __restrict__ b,
                 const float* __restrict__ j, float* __restrict__ e_out,
                 float* __restrict__ b_out, int X, int Y, int tiles_y,
                 int aligned, Coef k) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                     // E
  float* bs = es + RegionE::kFloats;    // bh (B loaded into it)
  float* ns = bs + RegionB::kFloats;    // en (J loaded into it)
  int* xtab = reinterpret_cast<int*>(ns + RegionN::kFloats);
  int* ytab = xtab + RegionE::kRows;

  const int tx = blockIdx.x / tiles_y;
  const int x0 = tx * kTileX;
  const int y0 = (blockIdx.x - tx * tiles_y) * kTileY;
  const int rows = min(kTileX, X - x0), cols = min(kTileY, Y - y0);
  const bool vec = aligned && cols == kTileY;

  for (int i = threadIdx.x; i < RegionE::kRows + RegionE::kCells;
       i += kThreads) {
    if (i < RegionE::kRows)
      xtab[i] = wrap(x0 - 1 + i, X) * Y;
    else
      ytab[i - RegionE::kRows] = wrap(y0 - 1 + i - RegionE::kRows, Y);
  }
  __syncthreads();
  load_region<RegionE>(es, e, xtab, ytab, 0, 0, y0, vec);
  load_region<RegionB>(bs, b, xtab, ytab, 0, 0, y0, vec);
  load_region<RegionN>(ns, j, xtab, ytab, 1, 1, y0, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  half_b(bs, es, k);
  __syncthreads();
  full_e(ns, bs, es, k);
  __syncthreads();
  store_region<RegionN>(e_out, ns, 0, rows, cols, x0, y0, Y, vec);
  new_b(bs, ns, k);
  __syncthreads();
  store_region<RegionB>(b_out, bs, 1, rows, cols, x0, y0, Y, vec);
}

}  // namespace

extern "C" {

// E, B and J: (X, Y, 3) float32, contiguous, on the current device; e_out
// and b_out the same, distinct from the inputs.  Returns a cudaError_t (0
// on success).
int yee2d_update(const float* e, const float* b, const float* j,
                 float* e_out, float* b_out, int X, int Y, double dt,
                 double dx, double dy, double c, double eps0, void* stream) {
  if (X < 1 || Y < 1) return static_cast<int>(cudaErrorInvalidValue);
  Coef k;
  k.h = static_cast<float>(0.5 * dt);
  k.dt = static_cast<float>(dt);
  k.c2 = static_cast<float>(c * c);
  k.inv_eps0 = 1.0f / static_cast<float>(eps0);
  k.inv_dx = 1.0f / static_cast<float>(dx);
  k.inv_dy = 1.0f / static_cast<float>(dy);
  const int tiles_y = (Y + kTileY - 1) / kTileY;
  const long long tiles =
      static_cast<long long>((X + kTileX - 1) / kTileX) * tiles_y;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte words where Y keeps every row 16-byte aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(e) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(j) |
                        reinterpret_cast<uintptr_t>(e_out) |
                        reinterpret_cast<uintptr_t>(b_out);
  const int aligned = Y % 4 == 0 && any % 16 == 0;
  yee2d_kernel<<<static_cast<unsigned>(tiles), kThreads, kSharedBytes,
                 static_cast<cudaStream_t>(stream)>>>(
      e, b, j, e_out, b_out, X, Y, tiles_y, aligned, k);
  return static_cast<int>(cudaGetLastError());
}

const char* yee2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
