// Filled gather of up to four 1-D tables at the same indices:
// out_k[e] = table_k[idx[e]] where 0 <= idx[e] < T, else fill_k, for the
// (B, C) index matrix idx (int32 or int64) and 4-byte tables (int32 or
// float32, moved as raw words).
//
// Replaces the TPU kernel of tools/experimental/vgather.py (_gather_kernel
// :41, _gather_call :65, pallas_call :74, gather_tables :90).  That kernel
// walked the table in VMEM-sized tiles over a sequential grid and served
// every index from the resident tile, because the TPU lowers a 1-D dynamic
// gather element by element; it never lowered on Mosaic.  On an H100 the
// gather is native: every element's word is one read through the
// read-only path.
//
// What bounds it on an H100: bytes.  Each element moves its index (4 or 8
// bytes, read once), one 4-byte word of each table (a 32-byte sector from a
// random place unless neighbouring indices share it: the postings
// expansions that call it read sorted runs, so neighbours mostly do) and
// one 4-byte word written per table.  So one thread takes 16 bytes of
// indices (four int32 or two int64) with one vector load, issues all its
// table reads before its stores, and writes each table's output as one
// vector.  No shared memory: nothing is reused across threads.  The kernel
// allocates nothing and does not synchronise.

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

template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_tables_kernel(const I* __restrict__ idx, Tables tb, long long total,
                     long long t_len, int n_tables) {
  constexpr int V = 16 / sizeof(I);
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long e0 = v * V;
  if (e0 >= total) return;
  const bool full = e0 + V <= total;
  union {
    uint4 raw;
    I ix[V];
  } u;
  if (full) {
    u.raw = __ldg(reinterpret_cast<const uint4*>(idx) + v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) u.ix[k] = e0 + k < total ? idx[e0 + k] : (I)-1;
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
    if (full) {
      if constexpr (V == 4) {
        reinterpret_cast<uint4*>(dst)[v] = make_uint4(r[0], r[1], r[2], r[3]);
      } else {
        reinterpret_cast<uint2*>(dst)[v] = make_uint2(r[0], r[1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (e0 + k < total) dst[e0 + k] = r[k];
      }
    }
  }
}

}  // namespace

// idx (total,) int32 (index_bytes 4) or int64 (8), 16-byte aligned; tables
// t0..t3 (t_len,) 4-byte words, outputs o0..o3 (total,) 16-byte aligned,
// fills f0..f3 as raw words; the first n_tables (1..4) are used
extern "C" int gather_tables_launch(const void* idx, const void* t0,
                                    const void* t1, const void* t2,
                                    const void* t3, void* o0, void* o1,
                                    void* o2, void* o3, uint32_t f0,
                                    uint32_t f1, uint32_t f2, uint32_t f3,
                                    long long total, long long t_len,
                                    int n_tables, int index_bytes,
                                    void* stream) {
  if (total <= 0) return 0;
  if (n_tables < 1 || n_tables > kMaxTables) return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long per_thread = 16 / index_bytes;
  const long long nvec = (total + per_thread - 1) / per_thread;
  const long long nblk = (nvec + kThreads - 1) / kThreads;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (index_bytes == 4) {
    gather_tables_kernel<int32_t><<<(unsigned)nblk, kThreads, 0, st>>>(
        static_cast<const int32_t*>(idx), tb, total, t_len, n_tables);
  } else if (index_bytes == 8) {
    gather_tables_kernel<long long><<<(unsigned)nblk, kThreads, 0, st>>>(
        static_cast<const long long*>(idx), tb, total, t_len, n_tables);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
