// Hit counts and 128-term block maxima from a bit-packed gram incidence.
//
// Replaces the TPU kernel stringsearchlib_tpu/ops/bitmap_matmul.py:
// bitmap_hits_bmax (a Pallas unpack + MXU matmul with a fused block-max
// epilogue).  Contract, bit for bit the reference's:
//
//   hits[b, t] = sum_g qcnt[b, g] * bit(g, t)        int8, term order
//   bmax[b, c] = max(hits[b, 128c : 128c + 128])     int8
//
// for sum_g qcnt[b, g] <= 127.  Table layout is the reference's plane-tiled,
// tile-major form: planes (ntiles, Gp, 512) bytes, and bit p of byte k of
// tile j holds term j*4096 + p*512 + k.  So one 16-byte word of a row slice
// yields, for each of the 8 bit planes, 16 consecutive terms.
//
// What bounds it on an H100 (main path: B = 512 queries, Gp = 2816 rows,
// 10.03M padded terms): the table is 3.5 GB, the hits it writes are
// B * 10.03M bytes (5.1 GB at B = 512), the block maxima 40 MB.  Read as a
// dense product it is 1.4e13 MACs - most of them by zero, since a query
// activates at most 30 gram rows.  So the kernel does the sparse product:
//
//   * the wrapper compacts each query's nonzero qcnt columns into a list of
//     (row, multiplicity), at most 127 entries, zero-terminated;
//   * one block per (layout tile, group of 32 queries); one warp per query
//     at a time; each lane owns 16 bytes of the tile's 512-byte row slice
//     and reads them with one coalesced 16-byte load per listed row (rows
//     shared by queries of the batch come from L2, so DRAM reads the table
//     about once per batch);
//   * the 8 bit planes accumulate as SWAR bytes: ((w >> p) & 0x01010101) *
//     mult adds one count per byte lane, and the <= 127 contract keeps every
//     byte below 128, so no lane carries into its neighbour - 32 registers
//     hold 128 counts;
//   * each plane's 16 counts are stored as one 16-byte write (a warp writes
//     512 contiguous bytes), and the 128-term block maxima come from the same
//     registers: a byte-wise max over the lane's words, then a max over the
//     8 lanes that share a block.
//
// Cost per query row is one 16-byte load and 96 integer ops per lane, so the
// kernel is bound by L2 reads of the listed rows and by the hits it writes,
// not by the table stream.  The kernel allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlkb = 512;          // bytes per layout tile row
constexpr int kTileLanes = 8 * kBlkb;  // terms per layout tile
constexpr int kSubs = kTileLanes / 128;  // 128-term blocks per tile
constexpr int kWarps = 8;
constexpr int kQueriesPerBlock = 32;

__device__ __forceinline__ uint32_t byte_max(uint32_t x) {
  uint32_t a = max(x & 0xffu, (x >> 8) & 0xffu);
  uint32_t b = max((x >> 16) & 0xffu, x >> 24);
  return max(a, b);
}

__global__ void __launch_bounds__(kWarps * 32)
bitmap_hits_bmax_kernel(const uint8_t* __restrict__ planes,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ mults,
                        int8_t* __restrict__ hits,
                        int8_t* __restrict__ bmax,
                        int n_queries, int gp, int ntiles, int vmax) {
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* tile_base =
      planes + (size_t)tile * (size_t)gp * kBlkb + (size_t)lane * 16;
  const size_t hits_row = (size_t)ntiles * kTileLanes;
  const size_t bmax_row = (size_t)ntiles * kSubs;
  const int q_end = min(n_queries, (int)(blockIdx.y + 1) * kQueriesPerBlock);

  for (int b = blockIdx.y * kQueriesPerBlock + warp; b < q_end; b += kWarps) {
    uint32_t acc[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[p][i] = 0u;
    }
    const int32_t* r = rows + (size_t)b * vmax;
    const int32_t* m = mults + (size_t)b * vmax;
    for (int v = 0; v < vmax; ++v) {
      const uint32_t mv = (uint32_t)__ldg(m + v);
      if (mv == 0u) break;  // lists are zero-terminated (uniform per warp)
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          tile_base + (size_t)__ldg(r + v) * kBlkb));
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int p = 0; p < 8; ++p) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[p][i] += ((ws[i] >> p) & 0x01010101u) * mv;
        }
      }
    }
    int8_t* hout = hits + (size_t)b * hits_row + (size_t)tile * kTileLanes +
                   (size_t)lane * 16;
    int8_t* bout = bmax + (size_t)b * bmax_row + (size_t)tile * kSubs;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      *reinterpret_cast<uint4*>(hout + p * kBlkb) =
          make_uint4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      uint32_t mx = byte_max(__vmaxu4(__vmaxu4(acc[p][0], acc[p][1]),
                                      __vmaxu4(acc[p][2], acc[p][3])));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // lanes 8c..8c+7 cover bytes 128c..128c+127 of plane p: block p*4 + c
      if ((lane & 7) == 0) bout[p * 4 + (lane >> 3)] = (int8_t)mx;
    }
  }
}

}  // namespace

extern "C" int bitmap_hits_bmax_launch(const void* planes, const void* rows,
                                       const void* mults, void* hits,
                                       void* bmax, int n_queries, int gp,
                                       int ntiles, int vmax, void* stream) {
  const dim3 grid((unsigned)ntiles,
                  (unsigned)((n_queries + kQueriesPerBlock - 1) /
                             kQueriesPerBlock));
  bitmap_hits_bmax_kernel<<<grid, kWarps * 32, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(mults), static_cast<int8_t*>(hits),
      static_cast<int8_t*>(bmax), n_queries, gp, ntiles, vmax);
  return (int)cudaGetLastError();
}
