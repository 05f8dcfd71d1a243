// Stable bucket resort of the tile-sorted layout, Hopper.
//
// Replaces: no TPU kernel.  The reference builds the layout with lax.sort
// (fusion_sim_tpu/ops/sorted_deposit.py : build_padded_layout); the port's
// plain version (ops/sorted_deposit.build_padded_layout_plain) is a stable
// torch.sort of the key 2 * tile + is_filler over the rows and the filler
// slots, then a gather and a zeroing where a column.  The key takes only
// n_tiles + 1 values (the last for invalid rows), so a stable counting sort
// is the whole job, and this kernel is that counting sort:
//
//   count    one CTA a chunk of consecutive rows: each row's tile (floor,
//            clamp into the grid, z fastest; n_tiles for an invalid row),
//            counted per key in shared memory with one atomic per warp and
//            key (__match_any_sync), and the chunk's nonzero counts stored
//            in column chunk + 1 of a zeroed key-major (n_keys, chunks + 1)
//            matrix.  Past kSharedKeys keys the counts go to the matrix
//            with global atomics.
//   (scan)   the wrapper scans the matrix along the chunks (torch's
//            cumsum_), so column c holds each key's rows in the chunks
//            before c, and works out each key's segment start from the
//            totals, the filler pads and the reserve/spread arithmetic.
//   scatter  one CTA a chunk again, 256 rows at a time in row order: each
//            row's key anew from its position (which it moves anyway), its
//            rank among the same key in the warp (__match_any_sync), the
//            same key's rows in the lower warps (the warps' key lists in
//            shared memory), and the chunk's running count of the key,
//            kept in its scan cell; the row goes whole to segment start +
//            that rank: position and payloads as 4-byte words, tile_id,
//            valid.
//   fill     a thread a filler slot: its tile by binary search over the
//            cumulative pads, zeros, the tile, valid false.
//
// So within a tile the real rows keep their row order and the fillers follow
// them, and the trailing region holds the invalid rows in row order, then
// the surplus fillers: the stable sort's order, row for row, and the same
// bits (rows are copied as words, never as floats).
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The resort has to read a 3D
// EM row once (position and velocity, 12 B each, and 1 B of valid) and
// write it once (29 B with tile_id and valid): 54 B a row, 22.8 GB or
// 6.8 ms for the 422 M rows of the 420M cell, plus the fillers (29 B each)
// and the count matrix (at most 2 B a row, written, scanned and read
// once).  This two-pass design reads position and valid once more in the
// count (13 B): its floor is 67 B a row, 8.5 ms.  The plain version reads
// and writes each row about 35 times (~630 B).  Extra device memory besides the outputs: the
// matrix alone (no key array: scatter recomputes the key from the position).
//
// What the design does about it, from timings on an H100 80GB HBM3 at 420M
// (chip_smoke.py phase 8b's inputs; 16.0 ms in all: count 2.3, scatter
// 13.3, the scan 0.17).  Rows move whole, once each way.  The key is found
// with f32 compares, one f32-to-int conversion and a shift an axis (for a
// tile of a power of two): the int64 conversion and division of tile_ids
// cost 2.3 ms more.  The scatter loads the next batch's rows before it
// ranks this one.  An identity copy of the same rows with no ranking takes
// 11 ms (2.1 TB/s read and written), so the ranking costs ~2.3 ms.  Tried
// and left out, for no gain: staging the loads in shared memory with
// cp.async, ballots in place of __match_any_sync, and writing a warp's rows
// of one key through shared memory as consecutive words (1.4 ms slower).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCountRows = 4;       // rows a thread per count step
constexpr int kMaxWords = 16;       // 4-byte words of a row, at most
constexpr int kSharedKeys = 12288;  // 48 KB of shared counts

struct Geometry {
  int dims;
  int tile[3];
  int nt[3];
  int n_tiles;
};

// Word i of a row: src[i] + row * src_stride[i] goes to
// dst[i] + out * dst_stride[i] (bytes).  Column 0 is the position, so words 0..dims-1 are its axes.
struct Columns {
  const char* src[kMaxWords];
  long long src_stride[kMaxWords];
  char* dst[kMaxWords];
  int dst_stride[kMaxWords];
  int n_words;
};

__device__ __forceinline__ uint32_t load_word(const Columns& c, int i,
                                              long long row) {
  return __ldg(reinterpret_cast<const unsigned int*>(
      c.src[i] + row * c.src_stride[i]));
}

// tile_ids / tile_ids_3d: floor(x) as int64, floor-divided by the tile and
// clamped into [0, nt - 1]
__device__ __forceinline__ int axis_tile(float x, int tile, int nt) {
  if (!(x >= 0.0f)) return 0;
  if (x >= (float)(tile * nt)) return nt - 1;
  const int b = (int)x;
  return (tile & (tile - 1)) == 0 ? b >> (__ffs(tile) - 1) : b / tile;
}

__device__ __forceinline__ int tile_key(const uint32_t* v,
                                        const Geometry& g) {
  int key = axis_tile(__uint_as_float(v[0]), g.tile[0], g.nt[0]);
  key = key * g.nt[1] + axis_tile(__uint_as_float(v[1]), g.tile[1], g.nt[1]);
  if (g.dims == 3) {
    key = key * g.nt[2] +
          axis_tile(__uint_as_float(v[2]), g.tile[2], g.nt[2]);
  }
  return key;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    count_kernel(Columns cols, Geometry g,
                 const unsigned char* __restrict__ valid, int* counts,
                 long long n_rows, long long chunk_rows, int n_chunks) {
  extern __shared__ int hist[];
  const int n_keys = g.n_tiles + 1;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t stride = (size_t)n_chunks + 1;
  if (kShared) {
    for (int k = threadIdx.x; k < n_keys; k += kThreads) hist[k] = 0;
    __syncthreads();
  }
  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min(r0 + chunk_rows, n_rows);
  for (long long b0 = r0; b0 < r1; b0 += (long long)kThreads * kCountRows) {
    int key[kCountRows];
#pragma unroll
    for (int k = 0; k < kCountRows; ++k) {
      const long long row = b0 + k * kThreads + threadIdx.x;
      key[k] = -1;
      if (row < r1) {
        uint32_t v[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (a < g.dims) v[a] = load_word(cols, a, row);
        }
        key[k] = (valid != nullptr && !valid[row]) ? g.n_tiles
                                                   : tile_key(v, g);
      }
    }
#pragma unroll
    for (int k = 0; k < kCountRows; ++k) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[k]);
      if (key[k] >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(kShared ? &hist[key[k]]
                          : &counts[(size_t)key[k] * stride + chunk + 1],
                  __popc(peers));
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_keys; k += kThreads) {
      if (hist[k]) counts[(size_t)k * stride + chunk + 1] = hist[k];
    }
  }
}

// kW: words held a row (at least cols.n_words); the next batch's loads are
// issued before this batch is ranked, so they overlap its syncs
template <int kW>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(Columns cols, Geometry g,
                   const unsigned char* __restrict__ valid, int* scan,
                   const int* __restrict__ seg_start,
                   int* __restrict__ tile_id,
                   unsigned char* __restrict__ valid_out, long long n_rows,
                   long long chunk_rows, int n_chunks) {
  __shared__ int s_key[kWarps][32];
  __shared__ int s_cnt[kWarps][32];
  __shared__ int s_n[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int chunk = blockIdx.x;
  const size_t stride = (size_t)n_chunks + 1;
  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min(r0 + chunk_rows, n_rows);
  uint32_t v[kW], next[kW];
  bool ok, next_ok = true;
  if (r0 + threadIdx.x < r1) {
    const long long row = r0 + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      if (i < cols.n_words) next[i] = load_word(cols, i, row);
    }
    next_ok = valid == nullptr || valid[row];
  }
  for (long long b0 = r0; b0 < r1; b0 += kThreads) {
    const long long row = b0 + threadIdx.x;
    const bool live = row < r1;
#pragma unroll
    for (int i = 0; i < kW; ++i) v[i] = next[i];
    ok = next_ok;
    if (row + kThreads < r1) {
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        if (i < cols.n_words) next[i] = load_word(cols, i, row + kThreads);
      }
      next_ok = valid == nullptr || valid[row + kThreads];
    }
    const int key = !live ? -1 : ok ? tile_key(v, g) : g.n_tiles;
    // rank in the warp; the warp's keys and counts for the other warps
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    const bool lead = live && lane == leader;
    const unsigned leads = __ballot_sync(0xffffffffu, lead);
    if (lead) {
      const int slot = __popc(leads & below);
      s_key[warp][slot] = key;
      s_cnt[warp][slot] = __popc(peers);
    }
    if (lane == 0) s_n[warp] = __popc(leads);
    __syncthreads();
    // the key's rows in the lower warps, and whether a higher warp has it
    int start = 0, placed = 0, before = 0;
    bool last = true;
    int* cell = nullptr;
    if (lead) {
      for (int u = 0; u < kWarps; ++u) {
        if (u == warp) continue;
        const int nu = s_n[u];
        for (int s = 0; s < nu; ++s) {
          if (s_key[u][s] == key) {
            if (u < warp) {
              before += s_cnt[u][s];
            } else {
              last = false;
            }
          }
        }
      }
      cell = scan + (size_t)key * stride + chunk;
      placed = *cell;  // the key's rows placed before this batch
      start = __ldg(seg_start + key) + placed + before;
    }
    start = __shfl_sync(0xffffffffu, start, leader);
    __syncthreads();  // every read of a scan cell precedes its update
    if (lead && last) *cell = placed + before + __popc(peers);
    if (live) {
      const long long out = (long long)start + __popc(peers & below);
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        if (i < cols.n_words) {
          *reinterpret_cast<uint32_t*>(cols.dst[i] +
                                       out * cols.dst_stride[i]) = v[i];
        }
      }
      tile_id[out] = key;
      if (valid_out != nullptr) valid_out[out] = key < g.n_tiles;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fill_kernel(Columns cols, const int* __restrict__ pad_end,
                const int* __restrict__ fill_base, int n_keys,
                long long total_pad, int* __restrict__ tile_id,
                unsigned char* __restrict__ valid_out) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= total_pad) return;
  // the bucket whose pad range holds j: the first with pad_end > j
  int lo = 0, hi = n_keys - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(pad_end + mid) > j) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const long long out = (long long)__ldg(fill_base + lo) + j;
#pragma unroll
  for (int i = 0; i < kMaxWords; ++i) {
    if (i < cols.n_words) {
      *reinterpret_cast<uint32_t*>(cols.dst[i] + out * cols.dst_stride[i]) =
          0u;
    }
  }
  tile_id[out] = lo;
  if (valid_out != nullptr) valid_out[out] = 0;
}

// Columns from the wrapper's table (src may be null: the fill writes only);
// false where they do not fit: a row not of whole 4-byte words at 4-byte
// aligned addresses, or more than kMaxWords words a row.
bool make_columns(Columns* c, int n_cols, const long long* src,
                  const long long* src_stride, const long long* dst,
                  const long long* row_bytes) {
  memset(c, 0, sizeof(*c));
  for (int k = 0; k < n_cols; ++k) {
    const long long rb = row_bytes[k];
    const bool aligned = rb % 4 == 0 && dst[k] % 4 == 0 &&
                         (src == nullptr ||
                          (src[k] % 4 == 0 && src_stride[k] % 4 == 0));
    if (!aligned || c->n_words + rb / 4 > kMaxWords) return false;
    for (long long w = 0; w < rb / 4; ++w) {
      const int i = c->n_words++;
      c->src[i] = src ? (const char*)(src[k] + 4 * w) : nullptr;
      c->src_stride[i] = src ? src_stride[k] : 0;
      c->dst[i] = (char*)(dst[k] + 4 * w);
      c->dst_stride[i] = (int)rb;
    }
  }
  return true;
}

Geometry make_geometry(int dims, const int* geom) {
  Geometry g;
  g.dims = dims;
  g.n_tiles = 1;
  for (int a = 0; a < 3; ++a) {
    g.tile[a] = a < dims ? geom[a] : 1;
    g.nt[a] = a < dims ? geom[3 + a] : 1;
    g.n_tiles *= g.nt[a];
  }
  return g;
}

constexpr int kColumnsDoNotFit = -1;

}  // namespace

// The three launches of one layout, on `stream`, in this order; each returns
// cudaGetLastError() after its launch, or -1 where the columns do not fit.
// Table of n_cols columns (column 0 the position, float32 (n_rows, >= dims)):
// src / dst device addresses, src_stride the input's row stride and
// row_bytes the output's row (bytes; the output is contiguous).  geom:
// tile[3], nt[3] (the first `dims` used).  valid: (n_rows,) bytes or null.
// counts: (n_tiles + 1, n_chunks + 1) int32, zeroed; chunk c of chunk_rows
// rows (the last may be short) counts into column c + 1.
extern "C" int tile_bucket_count(int n_cols, const long long* src,
                                 const long long* src_stride,
                                 const long long* dst,
                                 const long long* row_bytes, const void* valid,
                                 int dims, const int* geom, void* counts,
                                 long long n_rows, long long chunk_rows,
                                 int n_chunks, void* stream) {
  Columns cols;
  if (!make_columns(&cols, n_cols, src, src_stride, dst, row_bytes)) {
    return kColumnsDoNotFit;
  }
  const Geometry g = make_geometry(dims, geom);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_keys = g.n_tiles + 1;
  if (n_keys <= kSharedKeys) {
    count_kernel<true><<<n_chunks, kThreads, n_keys * sizeof(int), st>>>(
        cols, g, (const unsigned char*)valid, (int*)counts, n_rows,
        chunk_rows, n_chunks);
  } else {
    count_kernel<false><<<n_chunks, kThreads, 0, st>>>(
        cols, g, (const unsigned char*)valid, (int*)counts, n_rows,
        chunk_rows, n_chunks);
  }
  return (int)cudaGetLastError();
}

// scan: the counts after the scan along the chunks (consumed: each chunk's
// cells end as its running counts); seg_start: (n_tiles + 1,) int32, each
// key's first output row.  valid_out may be null.
extern "C" int tile_bucket_scatter(int n_cols, const long long* src,
                                   const long long* src_stride,
                                   const long long* dst,
                                   const long long* row_bytes,
                                   const void* valid, int dims,
                                   const int* geom, void* scan,
                                   const void* seg_start, void* tile_id,
                                   void* valid_out, long long n_rows,
                                   long long chunk_rows, int n_chunks,
                                   void* stream) {
  Columns cols;
  if (!make_columns(&cols, n_cols, src, src_stride, dst, row_bytes)) {
    return kColumnsDoNotFit;
  }
  const Geometry g = make_geometry(dims, geom);
  auto kernel = cols.n_words <= 4   ? scatter_kernel<4>
                : cols.n_words <= 8 ? scatter_kernel<8>
                                    : scatter_kernel<kMaxWords>;
  kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      cols, g, (const unsigned char*)valid, (int*)scan,
      (const int*)seg_start, (int*)tile_id, (unsigned char*)valid_out,
      n_rows, chunk_rows, n_chunks);
  return (int)cudaGetLastError();
}

// pad_end: (n_keys,) int32, the cumulative filler slots (the last key's are
// the surplus, pad_end[n_keys - 1] = total_pad); fill_base: (n_keys,) int32,
// a key's first filler row minus its first slot.
extern "C" int tile_bucket_fill(int n_cols, const long long* dst,
                                const long long* row_bytes,
                                const void* pad_end, const void* fill_base,
                                int n_keys, long long total_pad,
                                void* tile_id, void* valid_out,
                                void* stream) {
  Columns cols;
  if (!make_columns(&cols, n_cols, nullptr, nullptr, dst, row_bytes)) {
    return kColumnsDoNotFit;
  }
  if (total_pad == 0) return 0;
  const long long blocks = (total_pad - 1) / kThreads + 1;
  fill_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cols, (const int*)pad_end, (const int*)fill_base, n_keys, total_pad,
      (int*)tile_id, (unsigned char*)valid_out);
  return (int)cudaGetLastError();
}

// The 4-byte words a row may hold over the position and the payloads.
extern "C" int tile_bucket_max_words() { return kMaxWords; }

extern "C" const char* tile_bucket_error_string(int err) {
  if (err == kColumnsDoNotFit) {
    return "the columns do not fit: rows of whole 4-byte words at 4-byte "
           "aligned addresses, tile_bucket_max_words() words a row at most";
  }
  return cudaGetErrorString((cudaError_t)err);
}
