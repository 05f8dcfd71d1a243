// The 3D Yee leapfrog (B half step, E full step with J, B half step) in one
// launch, Hopper.
//
// Replaces: no TPU kernel.  The reference's yee_update
// (fusion_sim_tpu/models/electromagnetic.py, ops/fdtd.py) is rolls and
// differences that XLA fuses; the port's plain version
// (ops/yee3d.yee_update_3d_plain: ops/fdtd.advance_b_half, advance_e_full,
// advance_b_half) runs them on the card as 93 device operations a step, each
// a pass over one or two 8 MB component grids of a 128^3 grid.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  E, B and J are read once and E
// and B written once, 3 f32 a cell each: 60 B a cell, 125.8 MB or 0.0376 ms
// at 128^3 (port_bench/rooflines/yee_update.py).  The arithmetic, 54 f32
// operations a cell, would take 4.5% of that time at the card's f32 rate.
//
// Design.  Nothing but E and B goes back to device memory: the half-step B
// (bh) and the new E (en) live in shared memory only.  A CTA owns a tile of
// kTileY grid rows by kTileZ cells of the (y, z) plane over a run of x planes
// and marches along x, one plane an iteration, keeping a ring of three
// planes of each of E, bh and en.  Each plane of a ring covers the tile and
// the halo it needs, recomputed by every CTA whose tile borders it:
//
//   B_new at x needs en at x, x+1 (and at y+1, z+1 in its plane);
//   en at x needs bh at x, x-1 (and at y-1, z-1);
//   bh at x needs E at x, x+1 (and at y+1, z+1).
//
// So the E plane holds rows y0-1 .. y0+kTileY+1 and cells z0-1 ..
// z0+kTileZ+1, bh one row and one cell fewer at the far side, en the tile
// and one more row and cell at the far side.  A run of R output planes
// computes bh on R+2 planes and en on R+1, and reads E on R+3, B on R+2 and
// J on R+1: the planes a run shares with its neighbour are read twice, the
// halo rows of a plane once per tile that borders them (mostly from L2).
// The runs are as long as fills the card's resident CTAs once (at 128^3:
// 32 tiles x 8 runs of 16 planes, 2 CTAs an SM).  Copies from the grids are
// cp.async: B lands in the bh plane and J in the en plane, each updated in
// place (a thread reads and writes only its own cell there); the next
// iteration's E, B and J planes are in flight while a plane is computed.
// Shared rows are padded so that the tile's cells sit on 16-byte
// boundaries: they move as 16-byte words, in and out, where Z is a multiple
// of 4 and the grids are 16-byte aligned, and the halo cells as floats.
// The periodic wrap is index arithmetic: a table of each halo row's and
// column's grid index, so a grid of any size, ragged or smaller than the
// halo, is read right; stores are masked to the grid.
//
// Measured on an H100 80GB HBM3 (700 W) at 128^3, median of 20 launches:
// 0.0683 ms, 55% of the bound; the plain version 1.248 ms.  A first form
// that moved every float alone took 0.0965 ms: 16-byte words cut the
// copies' instructions about fourfold.  Of the
// tiles tried, 8 x 64 and 4 x 128 cells were best; 3 CTAs an SM (80
// registers) or 4 x 64 tiles were 7-28% slower: more, shorter runs read
// more shared planes twice.
//
// Rounding: -fmad=false and the plain version's operation order, term for
// term: ((f[i+1] - f[i]) * inv_d) - (...) in curl_e_3d's order, curl_b_3d
// likewise, b - h * curl and e + dt * (c2 * curl_b - j * inv_eps0), with the
// scalars formed as PyTorch's CUDA elementwise kernels form them from a
// Python float: h = f32(0.5 dt), dt, c2 = f32(c c), and a division by a
// Python scalar as a product with its f32 reciprocal, inv_d = 1 / f32(d),
// inv_eps0 = 1 / f32(eps0).  So the kernel equals the plain version on the
// card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;   // CTAs an SM, for the register budget
constexpr int kTileY = 8;
constexpr int kTileZ = 64;
static_assert(kTileZ % 4 == 0, "the tile's cells move as 16-byte words");

// A region of one x plane in shared memory: kRows grid rows of kLeft +
// kTileZ + kRight cells (3 floats each) from cell z0 - kLeft.  Each row
// starts at a multiple of 4 floats and kPad floats of padding put its cell
// z0 at a multiple of 4 too, so the tile's cells move as 16-byte words.
template <int kRows_, int kLeft_, int kRight_>
struct Region {
  static constexpr int kRows = kRows_, kLeft = kLeft_, kRight = kRight_;
  static constexpr int kCells = kLeft + kTileZ + kRight;
  static constexpr int kPad = (4 - 3 * kLeft % 4) % 4;
  static constexpr int kStride = (kPad + 3 * kCells + 3) / 4 * 4;
  static constexpr int kFloats = kRows * kStride;
  // the float offset of cell q (q = 0 at z0 - kLeft) of row r
  __device__ static constexpr int at(int r, int q) {
    return r * kStride + kPad + 3 * q;
  }
};
// E at y0-1 .. y0+kTileY+1, z0-1 .. z0+kTileZ+1; the half-step B one row
// and one cell fewer at the far side; the new E from y0 and z0, one more
// row and cell than the tile
using RegionE = Region<kTileY + 3, 1, 2>;
using RegionB = Region<kTileY + 2, 1, 1>;
using RegionN = Region<kTileY + 1, 0, 1>;
constexpr size_t kSharedBytes =
    (3 * (RegionE::kFloats + RegionB::kFloats + RegionN::kFloats) +
     RegionE::kRows + RegionE::kCells) * 4;

struct Coef {
  float h, dt, c2, inv_eps0, inv_dx, inv_dy, inv_dz;
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

// Region R of one grid plane into dst: row r from grid row ytab[r + r0]
// (times Z), cell q from grid column ztab[q + q0].  With vec (the tile's
// cells whole in the grid, Z a multiple of 4, the grids 16-byte aligned)
// the tile's cells come as 16-byte words and the halo cells as floats;
// else every float alone.
template <class R>
__device__ __forceinline__ void load_region(float* dst, const float* plane,
                                            const int* ytab, const int* ztab,
                                            int r0, int q0, int z0,
                                            bool vec) {
  if (vec) {
    constexpr int kVec = 3 * kTileZ / 4;
    constexpr int kItems = kVec + 3 * (R::kLeft + R::kRight);
    for (int t = threadIdx.x; t < R::kRows * kItems; t += kThreads) {
      const int r = t / kItems;
      const int u = t - r * kItems;
      const float* src = plane + ytab[r + r0] * 3;
      if (u < kVec) {
        cp_async16(dst + R::at(r, R::kLeft) + 4 * u, src + z0 * 3 + 4 * u);
      } else {
        const int h = u - kVec;
        const int hc = h / 3;
        const int q = hc < R::kLeft ? hc : kTileZ + hc;
        cp_async4(dst + R::at(r, q) + h - 3 * hc,
                  src + ztab[q + q0] * 3 + h - 3 * hc);
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
              plane + (ytab[r + r0] + ztab[q + q0]) * 3 + i - 3 * q);
  }
}

// Rows r < rows and cells q < cols of the tile in region R, from its row
// r1 and cell kLeft, to the grid plane at (y0 + r, z0 + q).
template <class R>
__device__ __forceinline__ void store_region(float* plane, const float* src,
                                             int r1, int rows, int cols,
                                             int y0, int z0, int Z,
                                             bool vec) {
  if (vec) {
    constexpr int kVec = 3 * kTileZ / 4;
    for (int t = threadIdx.x; t < rows * kVec; t += kThreads) {
      const int r = t / kVec;
      const int u = t - r * kVec;
      *reinterpret_cast<float4*>(plane + ((y0 + r) * Z + z0) * 3 + 4 * u) =
          *reinterpret_cast<const float4*>(src + R::at(r + r1, R::kLeft) +
                                           4 * u);
    }
    return;
  }
  for (int r = 0; r < rows; ++r) {
    float* d = plane + ((y0 + r) * Z + z0) * 3;
    const float* s = src + R::at(r + r1, R::kLeft);
    for (int i = threadIdx.x; i < cols * 3; i += kThreads) d[i] = s[i];
  }
}

// bh = b - h curl E over region B, in place (it holds B); e0 and e1 are the
// E planes at x and x+1.  curl_e_3d's terms.
__device__ __forceinline__ void half_b(float* bh, const float* e0,
                                       const float* e1, const Coef& k) {
  for (int c = threadIdx.x; c < RegionB::kRows * RegionB::kCells;
       c += kThreads) {
    const int r = c / RegionB::kCells;
    const int q = c - r * RegionB::kCells;
    const int i = RegionE::at(r, q);
    const float* p = e0 + i;
    const float* py = p + RegionE::kStride;
    const float* pz = p + 3;
    const float* px = e1 + i;
    const float ex = p[0], ey = p[1], ez = p[2];
    const float cx = ((py[2] - ez) * k.inv_dy) - ((pz[1] - ey) * k.inv_dz);
    const float cy = ((pz[0] - ex) * k.inv_dz) - ((px[2] - ez) * k.inv_dx);
    const float cz = ((px[1] - ey) * k.inv_dx) - ((py[0] - ex) * k.inv_dy);
    float* o = bh + RegionB::at(r, q);
    o[0] = o[0] - k.h * cx;
    o[1] = o[1] - k.h * cy;
    o[2] = o[2] - k.h * cz;
  }
}

// en = e + dt (c2 curl bh - j inv_eps0) over region N, in place (it holds
// J); bh0 and bhm are the bh planes at x and x-1, e0 the E plane at x.
// curl_b_3d's terms.
__device__ __forceinline__ void full_e(float* en, const float* bh0,
                                       const float* bhm, const float* e0,
                                       const Coef& k) {
  for (int c = threadIdx.x; c < RegionN::kRows * RegionN::kCells;
       c += kThreads) {
    const int r = c / RegionN::kCells;
    const int q = c - r * RegionN::kCells;
    const int i = RegionB::at(r + 1, q + 1);
    const float* p = bh0 + i;
    const float* py = p - RegionB::kStride;
    const float* pz = p - 3;
    const float* px = bhm + i;
    const float bx = p[0], by = p[1], bz = p[2];
    const float cx = ((bz - py[2]) * k.inv_dy) - ((by - pz[1]) * k.inv_dz);
    const float cy = ((bx - pz[0]) * k.inv_dz) - ((bz - px[2]) * k.inv_dx);
    const float cz = ((by - px[1]) * k.inv_dx) - ((bx - py[0]) * k.inv_dy);
    const float* pe = e0 + RegionE::at(r + 1, q + 1);
    float* o = en + RegionN::at(r, q);
    o[0] = pe[0] + k.dt * ((k.c2 * cx) - (o[0] * k.inv_eps0));
    o[1] = pe[1] + k.dt * ((k.c2 * cy) - (o[1] * k.inv_eps0));
    o[2] = pe[2] + k.dt * ((k.c2 * cz) - (o[2] * k.inv_eps0));
  }
}

// B_new = bh - h curl en over the tile, in place in the bh plane at x; n0
// and n1 are the en planes at x and x+1.  curl_e_3d's terms.
__device__ __forceinline__ void new_b(float* bh, const float* n0,
                                      const float* n1, const Coef& k) {
  for (int c = threadIdx.x; c < kTileY * kTileZ; c += kThreads) {
    const int r = c / kTileZ;
    const int q = c - r * kTileZ;
    const int i = RegionN::at(r, q);
    const float* p = n0 + i;
    const float* py = p + RegionN::kStride;
    const float* pz = p + 3;
    const float* px = n1 + i;
    const float ex = p[0], ey = p[1], ez = p[2];
    const float cx = ((py[2] - ez) * k.inv_dy) - ((pz[1] - ey) * k.inv_dz);
    const float cy = ((pz[0] - ex) * k.inv_dz) - ((px[2] - ez) * k.inv_dx);
    const float cz = ((px[1] - ey) * k.inv_dx) - ((py[0] - ex) * k.inv_dy);
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

// blockIdx.x: the (y, z) tile, z fastest; blockIdx.y: the run of x planes.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    yee3d_kernel(const float* __restrict__ e, const float* __restrict__ b,
                 const float* __restrict__ j, float* __restrict__ e_out,
                 float* __restrict__ b_out, int X, int Y, int Z, int run_len,
                 int tiles_z, int aligned, Coef k) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kE = RegionE::kFloats, kB = RegionB::kFloats,
                kN = RegionN::kFloats;
  float* es = smem;        // 3 E planes
  float* bs = es + 3 * kE; // 3 bh planes (B loaded into them)
  float* ns = bs + 3 * kB; // 3 en planes (J loaded into them)
  int* ytab = reinterpret_cast<int*>(ns + 3 * kN);
  int* ztab = ytab + RegionE::kRows;

  const int ty = blockIdx.x / tiles_z;
  const int y0 = ty * kTileY;
  const int z0 = (blockIdx.x - ty * tiles_z) * kTileZ;
  const int x0 = blockIdx.y * run_len;
  const int last = x0 + min(run_len, X - x0);  // bh and en, not stored
  const int first = x0 - 1;                    // bh only
  const int rows = min(kTileY, Y - y0), cols = min(kTileZ, Z - z0);
  const bool vec = aligned && cols == kTileZ;
  const long long plane = static_cast<long long>(Y) * Z * 3;

  for (int i = threadIdx.x; i < RegionE::kRows + RegionE::kCells;
       i += kThreads) {
    if (i < RegionE::kRows)
      ytab[i] = wrap(y0 - 1 + i, Y) * Z;
    else
      ztab[i - RegionE::kRows] = wrap(z0 - 1 + i - RegionE::kRows, Z);
  }
  __syncthreads();
  auto at = [&](auto* g, int x) { return g + wrap(x, X) * plane; };

  load_region<RegionE>(es, at(e, first), ytab, ztab, 0, 0, z0, vec);
  load_region<RegionE>(es + kE, at(e, x0), ytab, ztab, 0, 0, z0, vec);
  load_region<RegionB>(bs, at(b, first), ytab, ztab, 0, 0, z0, vec);
  cp_async_commit();

  // iteration it works on plane s = first + it; its planes sit in slot
  // it % 3 of each ring
  for (int it = 0, s = first; s <= last; ++it, ++s) {
    const int k0 = it % 3, k1 = (it + 1) % 3, k2 = (it + 2) % 3;
    cp_async_wait_all();
    __syncthreads();
    // the next planes, into the slots that iteration it - 1 finished with
    if (s + 1 <= last) {
      load_region<RegionE>(es + k2 * kE, at(e, s + 2), ytab, ztab, 0, 0, z0,
                           vec);
      load_region<RegionB>(bs + k1 * kB, at(b, s + 1), ytab, ztab, 0, 0, z0,
                           vec);
      if (s + 1 >= x0)
        load_region<RegionN>(ns + k1 * kN, at(j, s + 1), ytab, ztab, 1, 1,
                             z0, vec);
    }
    cp_async_commit();
    half_b(bs + k0 * kB, es + k0 * kE, es + k1 * kE, k);
    __syncthreads();
    if (s >= x0)
      full_e(ns + k0 * kN, bs + k0 * kB, bs + k2 * kB, es + k0 * kE, k);
    __syncthreads();
    if (s > x0) new_b(bs + k2 * kB, ns + k2 * kN, ns + k0 * kN, k);
    __syncthreads();
    if (s >= x0 && s < last)
      store_region<RegionN>(at(e_out, s), ns + k0 * kN, 0, rows, cols,
                            y0, z0, Z, vec);
    if (s > x0)
      store_region<RegionB>(at(b_out, s - 1), bs + k2 * kB, 1, rows,
                            cols, y0, z0, Z, vec);
  }
}

struct Launch {
  int sms = 0, per_sm = 0;
};

Launch launch_shape(int device) {
  static Launch cache[64];
  if (device < 0 || device >= 64) return Launch{};
  Launch& l = cache[device];
  if (l.sms == 0) {
    cudaFuncSetAttribute(yee3d_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSharedBytes));
    int sms = 0, per = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, yee3d_kernel,
                                                  kThreads, kSharedBytes);
    l.sms = sms;
    l.per_sm = per;
  }
  return l;
}

}  // namespace

extern "C" {

// E, B and J: (X, Y, Z, 3) float32, contiguous, on the current device;
// e_out and b_out the same, distinct from the inputs.  Returns a
// cudaError_t (0 on success).
int yee3d_update(const float* e, const float* b, const float* j,
                 float* e_out, float* b_out, int X, int Y, int Z, double dt,
                 double dx, double dy, double dz, double c, double eps0,
                 void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Launch l = launch_shape(device);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l.sms <= 0 || l.per_sm <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Coef k;
  k.h = static_cast<float>(0.5 * dt);
  k.dt = static_cast<float>(dt);
  k.c2 = static_cast<float>(c * c);
  k.inv_eps0 = 1.0f / static_cast<float>(eps0);
  k.inv_dx = 1.0f / static_cast<float>(dx);
  k.inv_dy = 1.0f / static_cast<float>(dy);
  k.inv_dz = 1.0f / static_cast<float>(dz);
  const int tiles_z = (Z + kTileZ - 1) / kTileZ;
  const long long tiles =
      static_cast<long long>((Y + kTileY - 1) / kTileY) * tiles_z;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // runs of x planes: as many as fill the card's resident CTAs once
  long long runs = static_cast<long long>(l.sms) * l.per_sm / tiles;
  runs = runs < 1 ? 1 : (runs > X ? X : runs);
  const int run_len = static_cast<int>((X + runs - 1) / runs);
  runs = (X + run_len - 1) / run_len;
  if (runs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte words where Z keeps every row and plane 16-byte aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(e) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(j) |
                        reinterpret_cast<uintptr_t>(e_out) |
                        reinterpret_cast<uintptr_t>(b_out);
  const int aligned = Z % 4 == 0 && any % 16 == 0;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(runs));
  yee3d_kernel<<<grid, kThreads, kSharedBytes,
                 static_cast<cudaStream_t>(stream)>>>(
      e, b, j, e_out, b_out, X, Y, Z, run_len, tiles_z, aligned, k);
  return static_cast<int>(cudaGetLastError());
}

const char* yee3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
