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
// here A and B are rounded to bf16 (round to nearest even) as they are
// staged, and each product is one mma.sync.m16n8k16 bf16 -> f32.  The TPU's
// 'highest' is f32-accurate in several passes: here 3xTF32, each value
// split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and three
// mma.sync.m16n8k8 TF32 -> f32 products a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// into the same f32 accumulator (a_lo.b_lo, ~2^-22 relative, is dropped).
//
// Depth is the experiment's variable.  k is zero-padded in shared memory
// to the instruction's depth: kp = 16 * ceil(k / 16) for bf16, 8 * ceil(k /
// 8) for TF32 (k = 24 runs 32 deep in bf16, 24 in TF32).  m is zero-padded
// to 16 rows (m16) and the last p chunk to 128 columns.  The padding is
// written once, when the CTA clears its shared memory; staging never
// touches it, so every product beyond (m, k, p) multiplies zeros.
//
// Design (simple first; wgmma and TMA are later work).  One CTA of 8 warps
// owns one s and a chunk of 128 columns of p.  It loops over g: stages A_g
// in its own order (rows of k for sublanes) and the (k, 128) slice of B_g
// into shared memory with float4 loads, then runs the full m16 x kp x 128
// product with mma.sync.  Warp w takes columns 32 (w % 4) .. +32 (four n8
// tiles) and the m16 row tiles of parity w / 4, and accumulates every g and
// every one of its row tiles into one 16 x 32 register accumulator: the
// column sums are linear, so summing row tiles in the accumulator is the
// same sum, and every one of the m x k x p multiply-adds still runs on the
// tensor cores.  At the end each thread adds its two accumulator rows,
// warp shuffles add the eight row groups, the two row-tile parities meet in
// shared memory, and each output is stored once.  No atomics: the output is
// deterministic.  Fragments are loaded from shared memory with scalar
// (16- or 32-bit) loads; the lhs_k_sublanes order reads A transposed (two
// 16-bit loads for a bf16 pair, one 32-bit load per TF32 value), which is
// the operand-order question of the experiment.  Row strides are padded so
// that the fragment loads of a warp hit 32 distinct banks.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 495 TF32 = 165 for
// 3xTF32): memory.  B alone is S G k p 4 bytes, 5.12 GB at the defaults
// (S 305, G 32, p 1024, k 128): 1.5 ms, against 0.25 ms of bf16 and 1.5 ms
// of 3xTF32 flops (2 S G m k p).  A is re-read by each of the p / 128
// column chunks of an s (from L2 in practice).  Elements are indexed with
// 64-bit offsets (B passes 2^31 elements' bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kPC = 128;       // columns of p a CTA owns
constexpr int kBStride = kPC + 8;

struct Shape {
  int S, G, m, k, p, kp, m16, n_chunks;
};

__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
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

// Shared-memory layout (elements of type T: uint16_t bf16 bits or float).
// A: lhs_k_lanes as (m16, a_stride) with a_stride = kp + 8 (bf16) or kp + 4
// (f32); lhs_k_sublanes as (kp, m16 + 8).  B: (kp, kBStride).
template <bool kBf16, bool kSublanes>
struct Layout {
  __host__ __device__ static int a_stride(const Shape& sh) {
    return kSublanes ? sh.m16 + 8 : sh.kp + (kBf16 ? 8 : 4);
  }
  __host__ __device__ static int a_elems(const Shape& sh) {
    return (kSublanes ? sh.kp : sh.m16) * a_stride(sh);
  }
  __host__ __device__ static size_t bytes(const Shape& sh) {
    const size_t elem = kBf16 ? 2 : 4;
    return elem * ((size_t)a_elems(sh) + (size_t)sh.kp * kBStride);
  }
};

template <bool kBf16, bool kSublanes>
__global__ void __launch_bounds__(kThreads)
contraction_depth_kernel(const float* __restrict__ a,
                         const float* __restrict__ b, float* __restrict__ o,
                         Shape sh) {
  using T = typename std::conditional<kBf16, uint16_t, float>::type;
  using L = Layout<kBf16, kSublanes>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][kPC];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + L::a_elems(sh);
  const int sa = L::a_stride(sh);

  const int s = blockIdx.x / sh.n_chunks;
  const int p0 = (blockIdx.x % sh.n_chunks) * kPC;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int warp_n = warp & 3, warp_m = warp >> 2;

  // zero once: the depth, row and column padding stays zero for every g
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = (int)(L::bytes(sh) / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }

  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;

  const int mk = sh.m * sh.k;
  const int m_tiles = sh.m16 / 16;
  for (int g = 0; g < sh.G; ++g) {
    __syncthreads();  // the previous g's fragments are read (and the zeroing)
    const size_t sg = (size_t)s * sh.G + g;
    // stage A_g (m * k contiguous floats, its own order)
    const float4* a4 = reinterpret_cast<const float4*>(a + sg * (size_t)mk);
    for (int v = tid; v < mk / 4; v += kThreads) {
      const float4 x = __ldg(a4 + v);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * v + j;
        const int inner = kSublanes ? sh.m : sh.k;
        const int row = e / inner, col = e - row * inner;
        if constexpr (kBf16) {
          As[row * sa + col] = to_bf16(xs[j]);
        } else {
          As[row * sa + col] = xs[j];
        }
      }
    }
    // stage the (k, kPC) slice of B_g
    const float* bg = b + sg * (size_t)sh.k * sh.p + p0;
    for (int v = tid; v < sh.k * (kPC / 4); v += kThreads) {
      const int row = v / (kPC / 4), c4 = (v % (kPC / 4)) * 4;
      if (p0 + c4 < sh.p) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(
            bg + (size_t)row * sh.p + c4));
        T* dst = Bs + row * kBStride + c4;
        if constexpr (kBf16) {
          dst[0] = to_bf16(x.x); dst[1] = to_bf16(x.y);
          dst[2] = to_bf16(x.z); dst[3] = to_bf16(x.w);
        } else {
          dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
        }
      }
    }
    __syncthreads();

    // the m16 x kp x kPC product on the tensor cores, kp in instruction
    // depths (16 bf16, 8 TF32)
    constexpr int kDepth = kBf16 ? 16 : 8;
    for (int k0 = 0; k0 < sh.kp; k0 += kDepth) {
      uint32_t bf[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = warp_n * 32 + nt * 8 + grp;
        if constexpr (kBf16) {
          const int r0 = k0 + 2 * tig;
          bf[nt][0] = pack(Bs[r0 * kBStride + n], Bs[(r0 + 1) * kBStride + n]);
          bf[nt][1] = pack(Bs[(r0 + 8) * kBStride + n],
                           Bs[(r0 + 9) * kBStride + n]);
        } else {
          split_tf32(Bs[(k0 + tig) * kBStride + n], bf[nt][0], bl[nt][0]);
          split_tf32(Bs[(k0 + tig + 4) * kBStride + n], bf[nt][1], bl[nt][1]);
        }
      }
      for (int mt = warp_m; mt < m_tiles; mt += 2) {
        const int r0 = mt * 16 + grp, r1 = r0 + 8;
        if constexpr (kBf16) {
          uint32_t af[4];
          const int c0 = k0 + 2 * tig, c1 = c0 + 8;
          if constexpr (kSublanes) {
            af[0] = pack(As[c0 * sa + r0], As[(c0 + 1) * sa + r0]);
            af[1] = pack(As[c0 * sa + r1], As[(c0 + 1) * sa + r1]);
            af[2] = pack(As[c1 * sa + r0], As[(c1 + 1) * sa + r0]);
            af[3] = pack(As[c1 * sa + r1], As[(c1 + 1) * sa + r1]);
          } else {
            af[0] = *reinterpret_cast<const uint32_t*>(As + r0 * sa + c0);
            af[1] = *reinterpret_cast<const uint32_t*>(As + r1 * sa + c0);
            af[2] = *reinterpret_cast<const uint32_t*>(As + r0 * sa + c1);
            af[3] = *reinterpret_cast<const uint32_t*>(As + r1 * sa + c1);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], af, bf[nt]);
        } else {
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
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t bh2[2] = {bf[nt][0], bf[nt][1]};
            const uint32_t bl2[2] = {bl[nt][0], bl[nt][1]};
            mma_tf32(acc[nt], al, bh2);
            mma_tf32(acc[nt], ah, bl2);
            mma_tf32(acc[nt], ah, bh2);
          }
        }
      }
    }
  }

  // column sums: a thread's two rows, then the eight row groups of a warp
  // (lanes that share tig), then the two row-tile parities in shared memory
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float v0 = acc[nt][0] + acc[nt][2];
    float v1 = acc[nt][1] + acc[nt][3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, off);
      v1 += __shfl_xor_sync(0xffffffffu, v1, off);
    }
    if (grp == 0) {
      const int col = warp_n * 32 + nt * 8 + 2 * tig;
      red[warp_m][col] = v0;
      red[warp_m][col + 1] = v1;
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

}  // namespace

// Shared memory a launch needs (bytes), so the wrapper can refuse a shape
// before it launches.
extern "C" long long contraction_depth_smem(int m, int k, int bf16,
                                            int sublanes) {
  Shape sh{};
  const int depth = bf16 ? 16 : 8;
  sh.kp = (k + depth - 1) / depth * depth;
  sh.m16 = (m + 15) / 16 * 16;
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
  Shape sh;
  sh.S = S; sh.G = G; sh.m = m; sh.k = k; sh.p = p;
  const int depth = bf16 ? 16 : 8;
  sh.kp = (k + depth - 1) / depth * depth;
  sh.m16 = (m + 15) / 16 * 16;
  sh.n_chunks = (p + kPC - 1) / kPC;
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
