// Row gather of a packed gram table: out[., i, .] = table[., rows[i], .].
//
// Replaces two TPU kernels of stringsearchlib_tpu/ops/bitmap_matmul.py that
// compute the same function with two TPU mechanisms:
//
//   K3 gather_rows_dma    (pipelined HBM->HBM DMAs, NB % 1024 == 0)
//   K4 gather_rows_pallas (one grid step per row, NB % 128 == 0)
//
// and the gathered-row front end's jnp.take(bitmap, rows, axis=1) on the
// resident tile-major table (search/candidates.py candidates_bitmap_gather).
// One kernel serves all three: the table is viewed as (outer, G, C) bytes
// and the output as (outer, Gc, C).
//
//   row-major (G, NB) table:            outer = 1,      C = NB   (K3/K4)
//   tile-major (ntiles, G, 512) table:  outer = ntiles, C = 512  (the route)
//
// What bounds it on an H100: nothing but bytes.  The gathered route at the
// 10M-key headline copies Gc = 32-64 of 2,816 rows out of every one of
// 2,448 layout tiles: 40-80 MB read in 512-byte slices (four 128-byte
// lines each) and written contiguously.  So the kernel is a plain copy
// with 16-byte vector loads and stores: a block owns one output row and a
// run of kVecPerBlock 16-byte words of it; each thread issues its
// kVecPerThread loads before its stores, so every warp keeps eight
// independent 512-byte reads in flight.  No shared memory, no TMA.  Every
// offset is size_t.  The kernel allocates nothing and does not
// synchronise; rows must lie in [0, G).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 8;
constexpr int kVecPerBlock = kThreads * kVecPerThread;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ rows,
                   uint4* __restrict__ out,
                   long long outer, int g, int gc, int c16) {
  const int i = blockIdx.y;
  const size_t row = (size_t)__ldg(rows + i);
  const size_t total = (size_t)outer * (size_t)c16;
  const size_t j0 = (size_t)blockIdx.x * kVecPerBlock + threadIdx.x;
  uint4 buf[kVecPerThread];
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const size_t j = j0 + (size_t)k * kThreads;
    if (j < total) {
      const size_t o = j / (size_t)c16;
      const size_t v = j - o * (size_t)c16;
      buf[k] = __ldg(table + (o * (size_t)g + row) * (size_t)c16 + v);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const size_t j = j0 + (size_t)k * kThreads;
    if (j < total) {
      const size_t o = j / (size_t)c16;
      const size_t v = j - o * (size_t)c16;
      out[(o * (size_t)gc + (size_t)i) * (size_t)c16 + v] = buf[k];
    }
  }
}

}  // namespace

// table (outer, g, 16 * c16) bytes, rows (gc,) int32, out (outer, gc, 16 * c16)
extern "C" int gather_rows_launch(const void* table, const void* rows,
                                  void* out, long long outer, int g, int gc,
                                  int c16, void* stream) {
  if (outer <= 0 || gc <= 0 || c16 <= 0) return 0;
  const size_t total = (size_t)outer * (size_t)c16;
  const size_t nblk = (total + kVecPerBlock - 1) / kVecPerBlock;
  if (nblk > 0x7fffffffu || gc > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)nblk, (unsigned)gc);
  gather_rows_kernel<<<grid, kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(rows),
      static_cast<uint4*>(out), outer, g, gc, c16);
  return (int)cudaGetLastError();
}
