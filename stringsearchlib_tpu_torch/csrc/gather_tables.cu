// Kernel K6, two entries.
//
// gather_tables_launch: the filled gather of up to four 1-D tables at the
// same indices: out_k[e] = table_k[idx[e]] where 0 <= idx[e] < T, else
// fill_k, for the (B, C) index matrix idx (int32 or int64) and 4-byte
// tables (int32 or float32, moved as raw words).  One pass.
//
// It replaces the TPU kernel of tools/experimental/vgather.py
// (_gather_kernel :41, _gather_call :65, pallas_call :74, gather_tables
// :90).  That kernel walked the table in VMEM-sized tiles over a sequential
// grid and served every index from the resident tile, because the TPU
// lowers a 1-D dynamic gather element by element; it never lowered on
// Mosaic.  On an H100 the gather is native: every element's word is one
// read through the read-only path.
//
// What bounds it on an H100: bytes.  Each element moves its index (4 or 8
// bytes, read once), one 4-byte word of each table and one 4-byte word
// written per table.  The least the card reads of a table is each distinct
// 32-byte sector the indices touch, once.
//
// The one pass: one thread takes 16 bytes of indices (four int32 or two
// int64) with one vector load, issues all its table reads before its
// stores, and writes each table's output as one vector where the outputs
// are 16-byte aligned.  No shared memory: nothing is reused across threads.
// Where the tables fit the L2 (50 MB on an H100) a sector that several
// indices share is read from device memory about once.  Where they do not,
// random indices read a 32-byte sector from device memory for every
// element, about five times the distinct sectors at 256 x 65,536 indices
// into 37.6M words.  So a block takes a chunk of one row, the row fastest
// in the grid: the blocks in flight hold the same few column chunks of
// every row, and where each row is sorted (as the postings expansion's
// indices are, run by run) they read one narrow slice of the tables, which
// the L2 keeps while the rows' chunks ask for it.  (Serving the indices
// range by range in passes that keep each range's slice in the L2, whatever
// their order, was measured and did not beat this order: PERF.md.)
//
// It allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// expand_postings_launch: the postings expansion, the same TPU kernel at the
// indices the reference computes in stringsearchlib_tpu/search/overlap.py
// :36-50 (and search/candidates.py:1496-1512): out[b, c] is the c-th
// posting of row b's present gram slots, their runs gram_terms[ptr[s] :
// ptr[s+1]] laid end to end in slot order, and fill past the row's mass.
//
// What bounds it: bytes - each row's slots and two ptr words per present
// slot, the sectors of the posting runs, the (B, s_cap) output.  The
// expansion is a segmented copy, so nothing else needs to reach device
// memory: no index matrix is built or read (the eager CSR expand built a
// dozen (B, s_cap) int64 tensors in ~25 launches, then this gather read
// 8-byte indices to fetch 4-byte words).  One launch.  A block serves one
// row: it scans the row's run lengths in chunks of 256 slots (int64, with
// the offset carried from chunk to chunk, so any Qmax), keeping each run's
// end and its source offset in shared memory, and strides over the row's
// tiles of 1,024 lanes, scanning again only when a tile needs another
// chunk than the one held.  The grid is eight waves of the blocks the card
// keeps resident, spread over the rows, so a short row gets a block per
// tile and a long one many tiles per block: fixed 1,024-lane tiles won at
// the routes' shapes and 8,192-lane ones at the dense path's, and this grid
// matches the first and beats the second (expand_ab.py; one, two and four
// waves were slower at the dense shape, sixteen the same).
// In a tile, each thread binary-searches the run of its first lane
// (searchsorted, side right) and walks forward over its four, so a warp
// reads each run's words contiguously and each sector once.  Stores are
// 16-byte vectors where s_cap % 4 == 0; lanes past the row's mass, padding
// rows (all slots -1) included, keep the fill.  Offsets into out and
// gram_terms are 64-bit; a source outside [0, P) and a slot outside [0, G)
// read as the fill and an absent slot.  It allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTables = 4;

struct Tables {
  const uint32_t* src[kMaxTables];
  uint32_t* dst[kMaxTables];
  uint32_t fill[kMaxTables];
};

// One block per chunk of kThreads * V indices of one row of the (rows,
// cols) index matrix, the row fastest: the blocks in flight hold the same
// few column chunks of every row, so where the rows are sorted they read
// one narrow slice of the tables, which the L2 keeps while it is served
// (rows 1: the chunks in order, which the wrapper asks for where a row is
// narrower than a chunk).  cols % V == 0 where rows > 1, so every thread's
// V indices are one aligned vector.  vec: every dst is 16-byte aligned.
template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_tables_kernel(const I* __restrict__ idx, Tables tb, long long rows,
                     long long cols, long long t_len, int n_tables, bool vec) {
  constexpr int V = 16 / sizeof(I);
  const long long row = (long long)blockIdx.x % rows;
  const long long col = (long long)blockIdx.x / rows * (kThreads * V) + threadIdx.x * V;
  if (col >= cols) return;
  const long long e0 = row * cols + col;
  const long long v = e0 / V;
  const bool full = col + V <= cols;
  union {
    uint4 raw;
    I ix[V];
  } u;
  if (full) {
    u.raw = __ldg(reinterpret_cast<const uint4*>(idx) + v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) u.ix[k] = col + k < cols ? idx[e0 + k] : (I)-1;
  }
#pragma unroll
  for (int t = 0; t < kMaxTables; ++t) {
    if (t >= n_tables) break;
    const uint32_t* src = tb.src[t];
    const uint32_t fill = tb.fill[t];
    uint32_t r[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long i = (long long)u.ix[k];
      r[k] = (i >= 0 && i < t_len) ? __ldg(src + i) : fill;
    }
    uint32_t* dst = tb.dst[t];
    if (full && vec) {
      if constexpr (V == 4) {
        reinterpret_cast<uint4*>(dst)[v] = make_uint4(r[0], r[1], r[2], r[3]);
      } else {
        reinterpret_cast<uint2*>(dst)[v] = make_uint2(r[0], r[1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (col + k < cols) dst[e0 + k] = r[k];
      }
    }
  }
}

Tables make_tables(const void* t0, const void* t1, const void* t2, const void* t3,
                   void* o0, void* o1, void* o2, void* o3, uint32_t f0,
                   uint32_t f1, uint32_t f2, uint32_t f3) {
  Tables tb;
  tb.src[0] = static_cast<const uint32_t*>(t0);
  tb.src[1] = static_cast<const uint32_t*>(t1);
  tb.src[2] = static_cast<const uint32_t*>(t2);
  tb.src[3] = static_cast<const uint32_t*>(t3);
  tb.dst[0] = static_cast<uint32_t*>(o0);
  tb.dst[1] = static_cast<uint32_t*>(o1);
  tb.dst[2] = static_cast<uint32_t*>(o2);
  tb.dst[3] = static_cast<uint32_t*>(o3);
  tb.fill[0] = f0;
  tb.fill[1] = f1;
  tb.fill[2] = f2;
  tb.fill[3] = f3;
  return tb;
}

bool aligned16(const Tables& tb, int n_tables) {
  for (int t = 0; t < n_tables; ++t) {
    if (reinterpret_cast<uintptr_t>(tb.dst[t]) % 16) return false;
  }
  return true;
}

}  // namespace

// idx (rows, cols) int32 (index_bytes 4) or int64 (8), 16-byte aligned,
// total = rows * cols, cols % (16 / index_bytes) == 0 where rows > 1 (pass
// rows 1, cols total for the chunks in order); tables t0..t3 (t_len,)
// 4-byte words, outputs o0..o3 (total,) 4-byte words (16-byte vector
// stores where all are 16-byte aligned), fills f0..f3 as raw words; the
// first n_tables (1..4) are used.  One pass.
extern "C" int gather_tables_launch(const void* idx, const void* t0,
                                    const void* t1, const void* t2,
                                    const void* t3, void* o0, void* o1,
                                    void* o2, void* o3, uint32_t f0,
                                    uint32_t f1, uint32_t f2, uint32_t f3,
                                    long long total, long long t_len,
                                    int n_tables, int index_bytes,
                                    long long rows, long long cols, void* stream) {
  if (total <= 0) return 0;
  const long long per_thread = 16 / (index_bytes == 4 ? 4 : 8);
  if (n_tables < 1 || n_tables > kMaxTables || (index_bytes != 4 && index_bytes != 8) ||
      rows < 1 || rows * cols != total || (rows > 1 && cols % per_thread)) {
    return (int)cudaErrorInvalidValue;
  }
  const Tables tb = make_tables(t0, t1, t2, t3, o0, o1, o2, o3, f0, f1, f2, f3);
  const bool vec = aligned16(tb, n_tables);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long chunk = kThreads * per_thread;
  const long long nblk = rows * ((cols + chunk - 1) / chunk);
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (index_bytes == 4) {
    gather_tables_kernel<int32_t><<<(unsigned)nblk, kThreads, 0, st>>>(
        static_cast<const int32_t*>(idx), tb, rows, cols, t_len, n_tables, vec);
  } else {
    gather_tables_kernel<long long><<<(unsigned)nblk, kThreads, 0, st>>>(
        static_cast<const long long*>(idx), tb, rows, cols, t_len, n_tables, vec);
  }
  return (int)cudaGetLastError();
}

namespace {

constexpr int kExpandThreads = 256;  // one slot per thread in a scan chunk
constexpr int kExpandTile = kExpandThreads * 4;  // lanes per tile, 4 a thread
constexpr int kExpandWaves = 8;  // the grid: waves of resident blocks

__global__ void __launch_bounds__(kExpandThreads)
expand_postings_kernel(const int* __restrict__ ptr,
                       const uint32_t* __restrict__ terms,
                       const int* __restrict__ slots,
                       uint32_t* __restrict__ out, long long n_grams,
                       long long n_post, int b, int qmax, long long s_cap,
                       uint32_t fill, bool vec) {
  __shared__ long long ends[kExpandThreads];  // scanned run ends
  __shared__ long long off[kExpandThreads];   // source = off[r] + lane
  __shared__ long long warp_sum[kExpandThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (s_cap + kExpandTile - 1) / kExpandTile;
  for (int row = blockIdx.y; row < b; row += gridDim.y) {
    const int* rs = slots + (long long)row * qmax;
    uint32_t* orow = out + (long long)row * s_cap;
    int scanned = -1;  // the first slot of the chunk held in shared memory
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long lo = tile * kExpandTile;
      const long long hi = min(lo + (long long)kExpandTile, s_cap);
      const long long g = lo + tid * 4;  // this thread's four lanes
      uint32_t v[4] = {fill, fill, fill, fill};
      long long carry = 0;  // the postings of the slots before the chunk
      for (int q0 = 0; q0 < qmax && carry < hi; q0 += kExpandThreads) {
        if (q0 != scanned) {  // block-uniform: scan the chunk's run lengths
          __syncthreads();    // every thread is done with the last chunk
          const int j = q0 + tid;
          const int s = j < qmax ? __ldg(rs + j) : -1;
          long long len = 0, p0 = 0;
          if (s >= 0 && s < n_grams) {
            p0 = __ldg(ptr + s);
            len = (long long)__ldg(ptr + s + 1) - p0;
          }
          long long x = len;  // inclusive scan: warps, then the warps' sums
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const long long y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
          }
          if (lane == 31) warp_sum[warp] = x;
          __syncthreads();
          long long end = carry + x;
          for (int w = 0; w < warp; ++w) end += warp_sum[w];
          ends[tid] = end;
          off[tid] = p0 - (end - len);
          __syncthreads();
          scanned = q0;
        }
        const long long a = max(lo, carry);
        const long long e = min(hi, ends[kExpandThreads - 1]);
        if (g + 4 > a && g < e) {
          const long long c0 = max(g, a);
          int r = 0, r_hi = kExpandThreads - 1;  // first run ending past c0
          while (r < r_hi) {
            const int m = (r + r_hi) >> 1;
            if (ends[m] > c0) r_hi = m; else r = m + 1;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const long long c = g + k;
            if (c < a || c >= e) continue;
            while (ends[r] <= c) ++r;
            const long long src = off[r] + c;
            v[k] = (src >= 0 && src < n_post) ? __ldg(terms + src) : fill;
          }
        }
        carry = ends[kExpandThreads - 1];
      }
      if (vec && g + 4 <= hi) {
        *reinterpret_cast<uint4*>(orow + g) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (g + k < hi) orow[g + k] = v[k];
        }
      }
    }
  }
}

// blocks of expand_postings_kernel the card keeps resident, per device
// (computed at the device's first launch)
int resident_blocks() {
  static int cached[64];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_postings_kernel,
                                                      kExpandThreads, 0);
  }
  if (e != cudaSuccess) return -(int)e;
  const int n = max(1, per_sm) * max(1, sms);
  if (dev < 64) cached[dev] = n;
  return n;
}

}  // namespace

// gram_ptr (G+1,) int32 (not decreasing), gram_terms (P,) int32 words,
// slots (b, qmax) int32 (-1: absent), out (b, s_cap) int32, 16-byte
// aligned; fill as a raw word.  Grid: (blocks striding over a row's lane
// tiles, rows looping past 65,535), kExpandWaves waves of resident blocks.
extern "C" int expand_postings_launch(const void* gram_ptr,
                                      const void* gram_terms,
                                      const void* slots, void* out,
                                      long long n_grams, long long n_post,
                                      int b, int qmax, long long s_cap,
                                      uint32_t fill, void* stream) {
  if (b <= 0 || s_cap <= 0) return 0;
  if (qmax < 0) return (int)cudaErrorInvalidValue;
  const int resident = resident_blocks();
  if (resident < 0) return -resident;
  const int rows = b < 65535 ? b : 65535;
  const long long tiles = (s_cap + kExpandTile - 1) / kExpandTile;
  const long long per_row = max(1LL, (long long)kExpandWaves * resident / rows);
  const dim3 grid((unsigned)min(tiles, per_row), (unsigned)rows);
  expand_postings_kernel<<<grid, kExpandThreads, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gram_ptr),
      static_cast<const uint32_t*>(gram_terms), static_cast<const int*>(slots),
      static_cast<uint32_t*>(out), n_grams, n_post, b, qmax, s_cap, fill,
      s_cap % 4 == 0);
  return (int)cudaGetLastError();
}
