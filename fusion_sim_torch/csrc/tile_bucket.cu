// Stable bucket resort of the tile-sorted layout, Hopper; rows by tile or,
// with the cell pass, by cell inside each tile.
//
// Replaces: no TPU kernel.  The reference builds the layout with lax.sort
// (fusion_sim_tpu/ops/sorted_deposit.py : build_padded_layout); the port's
// plain version (ops/sorted_deposit.build_padded_layout_plain) is a stable
// torch.sort of the key 2 * tile + is_filler over the rows and the filler
// slots (by cell: 2 * (tile * cells + cell) + is_filler, a filler taking
// its tile's last cell), then a gather and a zeroing where a column.  The
// tile key takes only n_tiles + 1 values (the last for invalid rows), so a
// stable counting sort is the whole job, and this kernel is that counting
// sort:
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
// Rows by cell add a fourth launch, the cell pass, which replaces no Pallas
// kernel either (the reference's sort is lax.sort).  The plain key by cell
// orders as the key by tile does and only adds a stable order by cell among
// a tile's real rows (a filler's odd key still follows every real row), so
// a stable reordering of each tile's real rows [seg_start, seg_start +
// count) by cell, applied to the layout by tile, gives the layout by cell.
// The scatter then writes the position and payload words into a second
// buffer set (scratch: one buffer, the outputs' words, freed after the
// pass; tile_id and valid go straight to the outputs, since they are
// constant across a tile's real rows), the fill writes the fillers straight
// to the outputs, and
//
//   cells    a cluster of C CTAs of 512 threads a tile (C = 1 where a tile
//            of the mean size fits one CTA's shared memory; ES 3D's ~7,300
//            rows of 24 B do, 2D3V's ~39,000 of 20 B take C = 6): each
//            warp counts its run of the tile's consecutive rows a cell (the
//            cell recomputed from the position as tile_cell_keys gives it:
//            floor, clamp into [0, n - 1] an axis, less the tile's origin,
//            last axis fastest; __match_any_sync, one add per key) into its
//            column of a (cells, warps) matrix in shared memory; the CTAs of
//            a cluster exchange their sums a cell (distributed shared
//            memory); the scan, cell-major, gives each (cell, warp) its
//            first output row; each warp then ranks its rows in row order
//            (__match_any_sync and its running counts) and puts each
//            row's words in the stage of the CTA whose span of the tile's
//            output holds it, and each CTA writes its span out in order,
//            each column's words as they lie.  A tile too large for its
//            cluster's stages writes each row to its place.  The invalid
//            rows, one segment after the tiles, are copied as they lie by
//            further CTAs.
//
// Nothing is read back to the host.
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
// By cell the pass reads and writes each real row's position and payload
// words once more (48 B a row at ES 3D's 30M: 1.44 GB, 0.43 ms over R1's
// 0.737 ms floor, ~1.17 ms a layout; ~0.27 ms at 2D3V's 10M) and reads
// the position a third time for its count (12 B, 0.11 ms at 30M); the
// scratch is one more set of row words (0.77 GB at 30M), below the stable
// sort's keys, order and copies.  One pass by (tile, cell) would skip the
// scratch, but its count matrix has 2.1 M keys at 30M 3D, which leaves the
// count's chunking (at most N / (2 n_keys) chunks) 7 chunks for 30 M rows.
//
// What the cell pass's design does about it, from timings on an H100 80GB
// HBM3 (chip_smoke.py phase 8b's ES 3D and 2D3V states, the pass alone
// from a profiler).  R1's ranking with every row written straight to its
// place took 2.83 ms at 30M: the rows of a tile land all over its ~175 KB
// of output for the CTA's whole life, and a run of ablations put the cost
// in those writes (3.46 ms as built, 0.85 with the same loads and ranking
// but rows stored in input order, 0.57 with no stores; 8 ms where the rows
// lie at random).  So each tile's output is staged in shared memory and
// written in order: 1.1-1.3 ms at 30M.  A warp's own run and column of
// counts leave the ranking without a CTA-wide barrier a batch; a row of
// warps + 1 entries a cell keeps the scan's and the leaders' shared
// accesses off each other's banks (-0.07 ms).  2D3V's tiles outgrow one
// CTA's shared memory; staged over a cluster, its pass fell from 0.74 ms
// (each row to its place) to 0.43-0.49.  Tried and left out: CTAs of 1024
// threads (their counts crowd out the stage), windows of a tile each
// reading the whole tile, and 8 or 32 rows a lane in the count (no gain or
// slower), and a path of its own for a cluster of one CTA (plain shared
// stores, the scan over the count matrix in place): 1.274 against 1.283 ms
// for the pass at 30M, 0.7%, where the whole layout's timings spread by 10%
// (3.04-3.36 ms).  What is left: the count (0.53 ms at 30M, a warp at a
// time through __match_any_sync with one CTA an SM) and the ranking
// (0.43 ms).
//
// What R1's design does about its bound, from timings on an H100 80GB HBM3
// at 420M (chip_smoke.py phase 8b's inputs; 16.0 ms in all: count 2.3,
// scatter 13.3, the scan 0.17).  Rows move whole, once each way.  The key
// is found with f32 compares, one f32-to-int conversion and a shift an axis
// (for a tile of a power of two): the int64 conversion and division of
// tile_ids cost 2.3 ms more.  The scatter loads the next batch's rows before
// it ranks this one.  An identity copy of the same rows with no ranking
// takes 11 ms (2.1 TB/s read and written), so the ranking costs ~2.3 ms.
// Tried and left out, for no gain: staging the loads in shared memory with
// cp.async, ballots in place of __match_any_sync, and writing a warp's rows
// of one key through shared memory as consecutive words (1.4 ms slower).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCountRows = 4;       // rows a thread per count step
constexpr int kCellRows = 16;       // rows a lane per step of the cell count
constexpr int kMaxWords = 16;       // 4-byte words of a row, at most
constexpr int kSharedKeys = 12288;  // 48 KB of shared counts
constexpr int kMaxCellCounts = 32768;  // the cell pass: 128 KB of counts

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

// The cell pass's stage: each output column's rows in a block of its own,
// as the column lies in memory.  Word i of a row goes to word pre[i] *
// stage_rows + row * wpr[i] + k[i]; column c of the outputs starts at dst[c]
// and holds cwpr[c] words a row, its block at cpre[c] * stage_rows.
struct Stage {
  int pre[kMaxWords], wpr[kMaxWords], k[kMaxWords];
  char* dst[kMaxWords];
  int cwpr[kMaxWords], cpre[kMaxWords];
  int n_cols;
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

// The base cell on one axis of extent n: floor, clamped into [0, n - 1]
// (tile_cell_keys' int32 floor and clamp)
__device__ __forceinline__ int axis_base(float x, int n) {
  if (!(x >= 0.0f)) return 0;
  if (x >= (float)n) return n - 1;
  return (int)x;
}

// The flat index of a row's base cell inside its tile, last axis fastest
__device__ __forceinline__ int cell_key(const uint32_t* v,
                                        const Geometry& g) {
  int cell = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a < g.dims) {
      const int t = g.tile[a];
      const int b = axis_base(__uint_as_float(v[a]), t * g.nt[a]);
      cell = cell * t + ((t & (t - 1)) == 0 ? b & (t - 1) : b % t);
    }
  }
  return cell;
}

// Exclusive scan, in place, of a[0, cells) by a CTA of kT threads, each a
// span of consecutive cells; returns after a barrier.
template <int kT>
__device__ void scan_cells(int* a, int cells, int* s_sum) {
  constexpr int kWs = kT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (cells + kT - 1) / kT;
  const int lo = min((int)threadIdx.x * per, cells);
  const int hi = min(lo + per, cells);
  int sum = 0;
  for (int c = lo; c < hi; ++c) sum += a[c];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWs ? s_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWs) s_sum[lane] = w;
  }
  __syncthreads();
  int start = x - sum + (warp > 0 ? s_sum[warp - 1] : 0);
  for (int c = lo; c < hi; ++c) {
    const int n = a[c];
    a[c] = start;
    start += n;
  }
  __syncthreads();
}

// The cell pass.  A cluster of C CTAs takes a tile t < n_tiles and
// reorders its real rows stably by cell, from the scratch (cols.src) to the
// outputs (cols.dst); the clusters past n_tiles copy the trailing
// segment's invalid rows as they lie.  counts: each key's real rows at
// counts[key * counts_stride].  Warp w of CTA q ranks run q * kT / 32 + w
// of C * kT / 32 runs of consecutive rows of the tile and owns column w of
// its CTA's (cells, warps) count matrix in shared memory (a row of
// kT / 32 + 1 entries a cell).  The CTAs add
// up their counts a cell and read each other's sums (distributed shared
// memory), so that, scanned, entry (c, w) of CTA q is where its warp w's
// next row of cell c goes.  Where a tile holds at most C * stage_rows rows,
// CTA q stages the q-th of C equal spans of its output in its shared
// memory, each row sent to the CTA whose span holds it, and writes the span
// out in order, each column's words as they lie; a larger tile (or any,
// where stage_rows is 0) goes row by row to its place.
template <int kT, int kW>
__global__ void __launch_bounds__(kT)
    cells_kernel(Columns cols, Stage st, Geometry g,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ counts, long long counts_stride,
                 int cells, int stage_rows, int copy_ctas) {
  constexpr int kWs = kT / 32;
  constexpr int kRow = kWs + 1;  // a cell's row of the count matrix
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  extern __shared__ uint32_t smem[];
  int* run = reinterpret_cast<int*>(smem);  // [cells][kRow]
  int* sum = run + cells * kRow;            // [cells]: this CTA's rows
  int* start = sum + cells;                 // [cells]: each cell's start
  int* before = start + cells;              // and the lower CTAs' rows
  uint32_t* stage = reinterpret_cast<uint32_t*>(before + cells);
  __shared__ int s_sum[kWs];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int nw = cols.n_words;
  const int tile_ctas = g.n_tiles * n_ctas;
  if ((int)blockIdx.x >= tile_ctas) {
    const long long r0 = __ldg(seg_start + g.n_tiles);
    const long long cnt =
        __ldg(counts + (size_t)g.n_tiles * counts_stride);
    for (long long r = (long long)(blockIdx.x - tile_ctas) * kT +
                       threadIdx.x;
         r < cnt; r += (long long)copy_ctas * kT) {
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        if (i < nw) {
          *reinterpret_cast<uint32_t*>(cols.dst[i] +
                                       (r0 + r) * cols.dst_stride[i]) =
              load_word(cols, i, r0 + r);
        }
      }
    }
    return;
  }
  const int t = blockIdx.x / n_ctas;
  const long long r0 = __ldg(seg_start + t);
  const int cnt = __ldg(counts + (size_t)t * counts_stride);
  if (cnt == 0) return;  // the whole cluster, before any exchange
  const int span_out = (cnt + n_ctas - 1) / n_ctas;
  const bool staged = span_out <= stage_rows;
  const int runs = n_ctas * kWs;
  const int span = (cnt + runs - 1) / runs;
  const int w0 = min((q * kWs + warp) * span, cnt);
  const int w1 = min(w0 + span, cnt);
  const int n_run = cells * kRow;
  for (int k = threadIdx.x; k < n_run; k += kT) run[k] = 0;
  __syncthreads();
  // each warp's count of its rows a cell (a key's leader alone adds)
  for (int b0 = w0; b0 < w1; b0 += 32 * kCellRows) {
    uint32_t p[kCellRows][3];
#pragma unroll
    for (int k = 0; k < kCellRows; ++k) {
      const int r = b0 + k * 32 + lane;
      if (r < w1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (a < g.dims) p[k][a] = load_word(cols, a, r0 + r);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCellRows; ++k) {
      const int key = b0 + k * 32 + lane < w1 ? cell_key(p[k], g) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && lane == __ffs(peers) - 1) {
        run[key * kRow + warp] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += kT) {
    int x = 0;
    for (int w = 0; w < kWs; ++w) x += run[c * kRow + w];
    sum[c] = x;
  }
  cluster.sync();
  for (int c = threadIdx.x; c < cells; c += kT) {
    int all = 0, lower = 0;
    for (int u = 0; u < n_ctas; ++u) {
      const int x = cluster.map_shared_rank(sum, u)[c];
      all += x;
      if (u < q) lower += x;
    }
    start[c] = all;
    before[c] = lower;
  }
  __syncthreads();
  scan_cells<kT>(start, cells, s_sum);
  for (int c = threadIdx.x; c < cells; c += kT) {
    int e = start[c] + before[c];
    for (int w = 0; w < kWs; ++w) {
      const int x = run[c * kRow + w];
      run[c * kRow + w] = e;
      e += x;
    }
  }
  __syncthreads();
  // each warp's rows in row order, 32 at a time, the next 32 loaded ahead
  uint32_t v[kW], next[kW];
  if (w0 + lane < w1) {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      if (i < nw) next[i] = load_word(cols, i, r0 + w0 + lane);
    }
  }
  for (int b0 = w0; b0 < w1; b0 += 32) {
    const int r = b0 + lane;
    const bool live = r < w1;
#pragma unroll
    for (int i = 0; i < kW; ++i) v[i] = next[i];
    if (r + 32 < w1) {
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        if (i < nw) next[i] = load_word(cols, i, r0 + r + 32);
      }
    }
    const int key = live ? cell_key(v, g) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    const bool lead = live && lane == leader;
    int at = lead ? run[key * kRow + warp] : 0;
    at = __shfl_sync(0xffffffffu, at, leader);
    if (lead) run[key * kRow + warp] = at + __popc(peers);
    __syncwarp();
    if (live) {
      const int out = at + __popc(peers & below);
      if (staged) {
        const int owner = out / span_out;
        const int j = out - owner * span_out;
        uint32_t* to = cluster.map_shared_rank(stage, owner);
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          if (i < nw) {
            to[st.pre[i] * stage_rows + j * st.wpr[i] + st.k[i]] = v[i];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          if (i < nw) {
            *reinterpret_cast<uint32_t*>(
                cols.dst[i] + (r0 + out) * cols.dst_stride[i]) = v[i];
          }
        }
      }
    }
  }
  // every row staged, and every read of the other CTAs' sums done, before
  // a CTA writes its span out or exits
  cluster.sync();
  if (staged) {
    const int j0 = min(q * span_out, cnt);
    const int n_out = min(span_out, cnt - j0);
    for (int c = 0; c < st.n_cols; ++c) {
      const int wpr = st.cwpr[c];
      const uint32_t* from = stage + st.cpre[c] * stage_rows;
      uint32_t* to =
          reinterpret_cast<uint32_t*>(st.dst[c]) + (r0 + j0) * wpr;
      for (int f = threadIdx.x; f < n_out * wpr; f += kT) to[f] = from[f];
    }
  }
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
constexpr int kBadCellPass = -2;
constexpr int kClusterDoesNotFit = -3;

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

// The cell pass, after the fill: src the scratch the scatter wrote (the
// outputs' shapes), dst the outputs; seg_start as for the scatter; counts:
// (n_tiles + 1) int32 real rows a key, at counts[key * counts_stride];
// n_rows: N; copy_ctas CTAs (at least) copy the trailing segment.  CTAs of
// 512 threads, one an SM: the stage takes the shared memory the count
// matrix leaves, and a tile the fewest CTAs, up to 8, whose stages hold a
// tile of the mean size (N / n_tiles rows) with a sixteenth to spare; where
// no such cluster fits, the rows go to their places one by one, and where
// the cluster cannot be placed the pass returns kClusterDoesNotFit.
extern "C" int tile_bucket_cells(int n_cols, const long long* src,
                                 const long long* dst,
                                 const long long* row_bytes, int dims,
                                 const int* geom, const void* seg_start,
                                 const void* counts, long long counts_stride,
                                 long long n_rows, int copy_ctas,
                                 void* stream) {
  Columns cols;
  if (!make_columns(&cols, n_cols, src, row_bytes, dst, row_bytes)) {
    return kColumnsDoNotFit;
  }
  const Geometry g = make_geometry(dims, geom);
  Stage st;
  memset(&st, 0, sizeof(st));
  st.n_cols = n_cols;
  for (int c = 0, i = 0; c < n_cols; ++c) {
    st.dst[c] = (char*)dst[c];
    st.cwpr[c] = (int)(row_bytes[c] / 4);
    st.cpre[c] = c == 0 ? 0 : st.cpre[c - 1] + st.cwpr[c - 1];
    for (int k = 0; k < st.cwpr[c]; ++k, ++i) {
      st.pre[i] = st.cpre[c];
      st.wpr[i] = st.cwpr[c];
      st.k[i] = k;
    }
  }
  constexpr int kT = 512;
  const int cells = g.tile[0] * g.tile[1] * g.tile[2];
  if (copy_ctas < 1 || cells * kT / 32 > kMaxCellCounts) return kBadCellPass;
  using Kernel = void (*)(Columns, Stage, Geometry, const int*, const int*,
                          long long, int, int, int);
  const Kernel kernel = cols.n_words <= 4   ? cells_kernel<kT, 4>
                        : cols.n_words <= 8 ? cells_kernel<kT, 8>
                                            : cells_kernel<kT, kMaxWords>;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return (int)err;
  // the count matrix (a row of kT / 32 + 1 a cell) and three arrays a
  // cell; 1 KB for the static shared memory and the runtime's own
  const int count_bytes = cells * (kT / 32 + 4) * 4;
  const int stage_rows = (optin - count_bytes - 1024) / (4 * cols.n_words);
  const long long mean = g.n_tiles > 0 ? n_rows / g.n_tiles : 0;
  const long long need = mean + mean / 16;
  const bool staged = stage_rows > 0 && need <= 8LL * stage_rows;
  const int n_ctas =
      staged ? (int)max(1LL, (need + stage_rows - 1) / stage_rows) : 1;
  const int smem = count_bytes + (staged ? stage_rows * 4 * cols.n_words : 0);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].val.clusterDim.x = n_ctas;
  cfg.gridDim = dim3(g.n_tiles * n_ctas +
                     (copy_ctas + n_ctas - 1) / n_ctas * n_ctas);
  if (n_ctas > 1) {
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit == 0) return kClusterDoesNotFit;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, cols, st, g, (const int*)seg_start,
                           (const int*)counts, counts_stride, cells,
                           staged ? stage_rows : 0,
                           (int)cfg.gridDim.x - g.n_tiles * n_ctas);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The entries of the cell pass's (cells, warps) count matrix, at most: a
// tile's cells times the CTA's warps (16).
extern "C" int tile_bucket_max_cell_counts() { return kMaxCellCounts; }

// The 4-byte words a row may hold over the position and the payloads.
extern "C" int tile_bucket_max_words() { return kMaxWords; }

extern "C" const char* tile_bucket_error_string(int err) {
  if (err == kColumnsDoNotFit) {
    return "the columns do not fit: rows of whole 4-byte words at 4-byte "
           "aligned addresses, tile_bucket_max_words() words a row at most";
  }
  if (err == kBadCellPass) {
    return "the cell pass takes at least one copy CTA and at most "
           "tile_bucket_max_cell_counts() / 16 cells a tile";
  }
  if (err == kClusterDoesNotFit) {
    return "the cell pass's cluster of CTAs, each with its stage of the "
           "tile, cannot be placed on this device";
  }
  return cudaGetErrorString((cudaError_t)err);
}
