// Contraction-depth experiment (kernel X1) on Hopper's tensor cores.
//
// Replaces: examples/mxu_experiment.py : make_bench (its Pallas kernel at
//           :40, called through pl.pallas_call at :70), a microbenchmark of
//           the TPU's matrix unit.
//
// Computes, for s < S and j < p,
//   o[s, 0, j] = sum_g colsum(A_g . B_g)[j],
// with B_g = B[s, g] (k, p) and A_g = A[s, g] (m, k) for order lhs_k_lanes,
// or A_g = A[s, g]^T with A[s, g] (k, m) for order lhs_k_sublanes (the
// contraction runs over A's first axis).  f32 in, f32 out (S, 1, p).
//
// Precision.  The TPU's 'default' is one bf16 pass of the matrix unit:
// here A and B are rounded to bf16 (round to nearest even) as their
// fragments are loaded, and each product is one mma.sync.m16n8k16 bf16 ->
// f32.  The TPU's 'highest' is f32-accurate in several passes: here 3xTF32,
// each value split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
// (split_tf32), and three mma.sync.m16n8k8 TF32 -> f32 products a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi into the same f32 accumulator (a_lo.b_lo, ~2^-22
// relative, is dropped).
//
// Depth is the experiment's variable.  k is zero-padded to the
// instruction's depth: kp = 16 * ceil(k / 16) for bf16, 8 * ceil(k / 8)
// for TF32 (k = 24 runs 32 deep in bf16, 24 in TF32).  m is zero-padded to
// 16 rows (m16) and the last p chunk to 128 columns.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 495 TF32 = 165 for
// 3xTF32): memory.  B alone is S G k p 4 bytes, 5.12 GB at the defaults
// (S 305, G 32, p 1024, k 128): 1.5 ms, against 0.25 ms of bf16 and 1.5 ms
// of 3xTF32 flops (2 S G m k p).  The kernel is a streaming read of B, so
// its design is an asynchronous load pipeline:
//
// * One CTA of 8 warps owns one s and a chunk of 256 columns of p, and
//   walks the stages (g, k0) for every g and every 16-deep slice of the
//   padded depth: A_g[:, k0:k0+16] and B_g[k0:k0+16, p0:p0+256], ~26 KB of
//   f32 a stage.  A ring of 3 stages (~78 KB) keeps two stages in flight
//   while the tensor cores run the oldest; two CTAs share an SM, ~100 KB of
//   loads in flight an SM against the ~25 KB Little's law asks at 3.35
//   TB/s.  (In variant timings on an H100, 256 columns and 3 stages were
//   faster in bf16 than 128 columns with 4 or 6 stages and than 32-deep
//   stages: the wider chunk halves A's re-reads and fragment loads per
//   column.)
// * Copies are 16-byte cp.async.cg (L2 only), issued by every thread into
//   the padded layout, one commit group a stage (cp.async.wait_group
//   kStages - 2, then one barrier a stage).  Chosen over TMA because the
//   padded strides give every fragment load 32 distinct banks without a
//   swizzle, and cp.async's src-size 0 zero-fills the rows beyond k (the
//   depth padding) and the columns beyond p (the ragged edge) just as
//   TMA's out-of-bounds fill would.  A TMA multicast of A to the p / 256
//   CTAs of an s is not used: A is 1/p of B's bytes a column and its
//   re-reads hit L2 (the CTAs of one s are launched together).
// * The staged values stay f32; warps convert at fragment load (bf16 pairs
//   with cvt.rn.bf16x2, or the TF32 hi/lo split in integer operations,
//   which timed faster than the cvt.rna.tf32.f32 instruction and than a
//   truncating split) and
//   run mma.sync.  Warp w takes 64 columns (w % 4) and the m16 row tiles of
//   parity w / 4, and accumulates every stage and every one of its row
//   tiles into one 16 x 64 register accumulator: the column sums are
//   linear, so summing row tiles in the accumulator is the same sum, and
//   every one of the m x k x p multiply-adds still runs on the tensor
//   cores.  In each 32-column group of a warp, column 8 t + j of n-tile t
//   sits at 4 j + t, so one 16-byte load of a row of B gives the fragments
//   of four n-tiles.
// * At the end each thread adds its two accumulator rows, warp shuffles add
//   the eight row groups, the two row-tile parities meet in shared memory,
//   and each output is stored once.  No atomics: the output is
//   deterministic.
//
// Padded strides (f32 words; a warp's fragment loads hit 32 banks):
// B rows 256 + 4 (bf16: rows 2t, 2t + 1, ...) or 256 + 8 (TF32: rows t,
// t + 4); A lhs_k_lanes rows 16 + 8 (bf16, 8-byte pairs) or 16 + 4 (TF32);
// A lhs_k_sublanes rows m16 + 4 (bf16) or m16 + 8 (TF32).  Elements are
// indexed with 64-bit offsets (B passes 2^31 elements' bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kPC = 256;       // columns of p a CTA owns
constexpr int kKC = 16;        // depth of a stage (a multiple of 16)
constexpr int kStages = 3;     // stages in the ring
constexpr int kWarpCols = kPC / 4;  // columns a warp owns (4 x 2 warps)
constexpr int kNT = kWarpCols / 8;  // its n8 tiles

struct Shape {
  int S, G, m, k, p, kp, m16, n_chunks;
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// cvt.rna.tf32.f32 for finite x in two integer operations: half a TF32
// ulp added to the magnitude, the low 13 bits cleared (ties away from 0)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One stage of the ring, in f32 words: A then B, each row 16-byte aligned.
// A: lhs_k_lanes (m16, kKC + pad) or lhs_k_sublanes (kKC, m16 + pad);
// B: (kKC, kPC + pad).
template <bool kBf16, bool kSublanes>
struct Layout {
  static constexpr int kBStride = kPC + (kBf16 ? 4 : 8);
  __host__ __device__ static int a_stride(const Shape& sh) {
    return kSublanes ? sh.m16 + (kBf16 ? 4 : 8) : kKC + (kBf16 ? 8 : 4);
  }
  __host__ __device__ static int a_words(const Shape& sh) {
    return (kSublanes ? kKC : sh.m16) * a_stride(sh);
  }
  __host__ __device__ static int stage_words(const Shape& sh) {
    return a_words(sh) + kKC * kBStride;
  }
  __host__ __device__ static size_t bytes(const Shape& sh) {
    return sizeof(float) * (size_t)kStages * stage_words(sh);
  }
};

// Issues the copies of stage `it` (g = it / nkc, k0 = 16 (it % nkc)) into
// ring slot `slot`.
template <bool kBf16, bool kSublanes>
__device__ __forceinline__ void issue_stage(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            float* slot, const Shape& sh,
                                            int s, int p0, int it, int nkc) {
  using L = Layout<kBf16, kSublanes>;
  const int g = it / nkc, k0 = (it - g * nkc) * kKC;
  const size_t sg = (size_t)s * sh.G + g;
  const int sa = L::a_stride(sh);
  float* As = slot;
  float* Bs = slot + L::a_words(sh);
  if constexpr (kSublanes) {
    // rows k0 .. k0 + kKC - 1 of A[s, g] (k, m): m floats each
    const int per_row = sh.m / 4;
    const float* ag = a + sg * (size_t)sh.k * sh.m;
    for (int v = threadIdx.x; v < kKC * per_row; v += kThreads) {
      const int r = v / per_row, c4 = (v - r * per_row) * 4;
      const bool in = k0 + r < sh.k;
      cp_async16(As + r * sa + c4,
                 in ? ag + (size_t)(k0 + r) * sh.m + c4 : a, in ? 16 : 0);
    }
  } else {
    // columns k0 .. k0 + kKC - 1 of A[s, g] (m, k)
    const float* ag = a + sg * (size_t)sh.m * sh.k;
    for (int v = threadIdx.x; v < sh.m * (kKC / 4); v += kThreads) {
      const int r = v / (kKC / 4), c4 = (v % (kKC / 4)) * 4;
      const bool in = k0 + c4 < sh.k;
      cp_async16(As + r * sa + c4,
                 in ? ag + (size_t)r * sh.k + k0 + c4 : a, in ? 16 : 0);
    }
  }
  // rows k0 .. k0 + kKC - 1, columns p0 .. p0 + kPC - 1 of B[s, g] (k, p)
  const float* bg = b + sg * (size_t)sh.k * sh.p + p0;
  for (int v = threadIdx.x; v < kKC * (kPC / 4); v += kThreads) {
    const int r = v / (kPC / 4), c4 = (v % (kPC / 4)) * 4;
    const bool in = k0 + r < sh.k && p0 + c4 < sh.p;
    cp_async16(Bs + r * L::kBStride + c4,
               in ? bg + (size_t)(k0 + r) * sh.p + c4 : b, in ? 16 : 0);
  }
}

template <bool kBf16, bool kSublanes>
__global__ void __launch_bounds__(kThreads)
contraction_depth_kernel(const float* __restrict__ a,
                         const float* __restrict__ b, float* __restrict__ o,
                         Shape sh) {
  using L = Layout<kBf16, kSublanes>;
  constexpr int kBS = L::kBStride;
  extern __shared__ __align__(16) float ring[];
  __shared__ float red[2][kPC];
  const int sa = L::a_stride(sh);
  const int stage_words = L::stage_words(sh);

  const int s = blockIdx.x / sh.n_chunks;
  const int p0 = (blockIdx.x % sh.n_chunks) * kPC;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int warp_n = warp & 3, warp_m = warp >> 2;

  // zero the ring once: the row padding of A (m .. m16) is never copied
  // and must multiply as zeros; everything else is rewritten every stage
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int n16 = (int)(L::bytes(sh) / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int nkc = (sh.kp + kKC - 1) / kKC;  // stages a g
  const int n_stages = sh.G * nkc;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_stages) {
      issue_stage<kBf16, kSublanes>(a, b, ring + i * stage_words, sh, s, p0,
                                    i, nkc);
    }
    cp_async_commit();
  }

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;

  const int m_tiles = sh.m16 / 16;
  // this lane's permuted columns: 4 of each 32-column group of the warp
  const int bcol = warp_n * kWarpCols + grp * 4;
  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<kStages - 2>();  // stage `it` has landed (this thread's)
    __syncthreads();               // ... everyone's; slot it - 1 is free
    {
      const int nxt = it + kStages - 1;
      if (nxt < n_stages) {
        issue_stage<kBf16, kSublanes>(a, b,
                                      ring + (nxt % kStages) * stage_words,
                                      sh, s, p0, nxt, nkc);
      }
      cp_async_commit();
    }
    const float* As = ring + (it % kStages) * stage_words;
    const float* Bs = As + L::a_words(sh);
    // the instruction depths of this stage that lie inside kp
    const int k_stage = min(kKC, sh.kp - (it % nkc) * kKC);

    if constexpr (kBf16) {
      for (int k0 = 0; k0 < k_stage; k0 += 16) {
        uint32_t bfr[kNT][2];
#pragma unroll
        for (int h = 0; h < kNT / 4; ++h) {
          const float* bp = Bs + bcol + 32 * h;
          const float4 r0 =
              *reinterpret_cast<const float4*>(bp + (k0 + 2 * tig) * kBS);
          const float4 r1 =
              *reinterpret_cast<const float4*>(bp + (k0 + 2 * tig + 1) * kBS);
          const float4 r8 =
              *reinterpret_cast<const float4*>(bp + (k0 + 2 * tig + 8) * kBS);
          const float4 r9 =
              *reinterpret_cast<const float4*>(bp + (k0 + 2 * tig + 9) * kBS);
          const int n = 4 * h;
          bfr[n][0] = bf16x2(r0.x, r1.x); bfr[n][1] = bf16x2(r8.x, r9.x);
          bfr[n + 1][0] = bf16x2(r0.y, r1.y);
          bfr[n + 1][1] = bf16x2(r8.y, r9.y);
          bfr[n + 2][0] = bf16x2(r0.z, r1.z);
          bfr[n + 2][1] = bf16x2(r8.z, r9.z);
          bfr[n + 3][0] = bf16x2(r0.w, r1.w);
          bfr[n + 3][1] = bf16x2(r8.w, r9.w);
        }
        for (int mt = warp_m; mt < m_tiles; mt += 2) {
          const int r0 = mt * 16 + grp, r1 = r0 + 8;
          const int c0 = k0 + 2 * tig, c1 = c0 + 8;
          uint32_t af[4];
          if constexpr (kSublanes) {
            af[0] = bf16x2(As[c0 * sa + r0], As[(c0 + 1) * sa + r0]);
            af[1] = bf16x2(As[c0 * sa + r1], As[(c0 + 1) * sa + r1]);
            af[2] = bf16x2(As[c1 * sa + r0], As[(c1 + 1) * sa + r0]);
            af[3] = bf16x2(As[c1 * sa + r1], As[(c1 + 1) * sa + r1]);
          } else {
            const float2 x0 =
                *reinterpret_cast<const float2*>(As + r0 * sa + c0);
            const float2 x1 =
                *reinterpret_cast<const float2*>(As + r1 * sa + c0);
            const float2 x2 =
                *reinterpret_cast<const float2*>(As + r0 * sa + c1);
            const float2 x3 =
                *reinterpret_cast<const float2*>(As + r1 * sa + c1);
            af[0] = bf16x2(x0.x, x0.y);
            af[1] = bf16x2(x1.x, x1.y);
            af[2] = bf16x2(x2.x, x2.y);
            af[3] = bf16x2(x3.x, x3.y);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[nt], af, bfr[nt]);
        }
      }
    } else {
      for (int k0 = 0; k0 < k_stage; k0 += 8) {
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int h = 0; h < kNT / 4; ++h) {
          const float* bp = Bs + bcol + 32 * h;
          const float4 x0 =
              *reinterpret_cast<const float4*>(bp + (k0 + tig) * kBS);
          const float4 x4 =
              *reinterpret_cast<const float4*>(bp + (k0 + tig + 4) * kBS);
          const float v0[4] = {x0.x, x0.y, x0.z, x0.w};
          const float v4[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split_tf32(v0[j], bh[4 * h + j][0], bl[4 * h + j][0]);
            split_tf32(v4[j], bh[4 * h + j][1], bl[4 * h + j][1]);
          }
        }
        for (int mt = warp_m; mt < m_tiles; mt += 2) {
          const int r0 = mt * 16 + grp, r1 = r0 + 8;
          const int c0 = k0 + tig, c1 = c0 + 4;
          float av[4];
          if constexpr (kSublanes) {
            av[0] = As[c0 * sa + r0]; av[1] = As[c0 * sa + r1];
            av[2] = As[c1 * sa + r0]; av[3] = As[c1 * sa + r1];
          } else {
            av[0] = As[r0 * sa + c0]; av[1] = As[r1 * sa + c0];
            av[2] = As[r0 * sa + c1]; av[3] = As[r1 * sa + c1];
          }
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            mma_tf32(acc[nt], al, bh[nt]);
            mma_tf32(acc[nt], ah, bl[nt]);
            mma_tf32(acc[nt], ah, bh[nt]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // column sums: a thread's two rows, then the eight row groups of a warp
  // (lanes that share tig), then the two row-tile parities in shared
  // memory.  Logical column 8 j + 2 tig + e of a 32-column group sits at
  // 4 (2 tig + e) + j.
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float v0 = acc[nt][0] + acc[nt][2];
    float v1 = acc[nt][1] + acc[nt][3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, off);
      v1 += __shfl_xor_sync(0xffffffffu, v1, off);
    }
    if (grp == 0) {
      const int col = warp_n * kWarpCols + 32 * (nt / 4) + 8 * tig + nt % 4;
      red[warp_m][col] = v0;
      red[warp_m][col + 4] = v1;
    }
  }
  __syncthreads();
  for (int c = tid; c < kPC; c += kThreads) {
    if (p0 + c < sh.p) o[(size_t)s * sh.p + p0 + c] = red[0][c] + red[1][c];
  }
}

template <bool kBf16, bool kSublanes>
int launch(const float* a, const float* b, float* o, const Shape& sh,
           cudaStream_t stream) {
  auto kernel = contraction_depth_kernel<kBf16, kSublanes>;
  const size_t smem = Layout<kBf16, kSublanes>::bytes(sh);
  if (smem + sizeof(float) * 2 * kPC > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = sh.S * sh.n_chunks;
  kernel<<<grid, kThreads, smem, stream>>>(a, b, o, sh);
  return (int)cudaGetLastError();
}

Shape make_shape(int S, int G, int m, int k, int p, int bf16) {
  Shape sh;
  sh.S = S; sh.G = G; sh.m = m; sh.k = k; sh.p = p;
  const int depth = bf16 ? 16 : 8;
  sh.kp = (k + depth - 1) / depth * depth;
  sh.m16 = (m + 15) / 16 * 16;
  sh.n_chunks = (p + kPC - 1) / kPC;
  return sh;
}

}  // namespace

// Shared memory a launch needs (bytes), so the wrapper can refuse a shape
// before it launches.
extern "C" long long contraction_depth_smem(int m, int k, int bf16,
                                            int sublanes) {
  const Shape sh = make_shape(1, 1, m, k, kPC, bf16);
  size_t bytes;
  if (bf16) {
    bytes = sublanes ? Layout<true, true>::bytes(sh)
                     : Layout<true, false>::bytes(sh);
  } else {
    bytes = sublanes ? Layout<false, true>::bytes(sh)
                     : Layout<false, false>::bytes(sh);
  }
  return (long long)(bytes + sizeof(float) * 2 * kPC);
}

extern "C" int contraction_depth(const void* a, const void* b, void* o, int S,
                                 int G, int m, int k, int p, int bf16,
                                 int sublanes, void* stream) {
  if (S == 0 || p == 0) return 0;
  const Shape sh = make_shape(S, G, m, k, p, bf16);
  const float* fa = (const float*)a;
  const float* fb = (const float*)b;
  float* fo = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    return sublanes ? launch<true, true>(fa, fb, fo, sh, st)
                    : launch<true, false>(fa, fb, fo, sh, st);
  }
  return sublanes ? launch<false, true>(fa, fb, fo, sh, st)
                  : launch<false, false>(fa, fb, fo, sh, st);
}

extern "C" const char* contraction_depth_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
