// Hit counts, and optionally their 128-term block maxima, from a bit-packed
// gram incidence.
//
// Replaces two TPU kernels of stringsearchlib_tpu/ops/bitmap_matmul.py, one
// Pallas unpack + MXU matmul under two entries:
//
//   K1 bitmap_hits_bmax (fused block-max epilogue) -> bitmap_hits_bmax_launch
//   K2 bitmap_hits      (hits only)                -> bitmap_hits_launch
//
// Contract, bit for bit the reference's:
//
//   hits[b, t] = sum_g qcnt[b, g] * bit(g, t)        int8, term order
//   bmax[b, c] = max(hits[b, 128c : 128c + 128])     int8 (K1 only)
//
// for sum_g qcnt[b, g] <= 127.  Table layout is the reference's plane-tiled
// form, bit p of byte k of tile j holding term j*4096 + p*512 + k, in either
// of the reference's two shapes: tile-major planes (ntiles, Gp, 512), the
// resident tables' (the entries above), or row-major (Gp, ntiles * 512)
// (the *_rowmajor_launch entries).  So one 16-byte word of a row slice
// yields, for each of the 8 bit planes, 16 consecutive terms.  The counting
// body lives in bitmap_hits.cuh, shared with the K1 probes (probe_hits.cu).
//
// The product is sparse: a query lists ~19 of Gp = 2816 rows on K1's main
// path (10M terms, B = 512) and ~18 of D = 8192 sketch buckets on K2's.
// The wrapper compacts each query's nonzero qcnt columns into a
// zero-terminated list of (row, multiplicity), the rows of multiplicity 1
// first (a sketch bucket hit by several query grams carries their summed
// multiplicity).  Tensor cores do not serve it: a dense int8 wgmma over the
// batch's ~1,900 distinct rows would cost 2 * 512 * 1,900 * 10.03M ~ 2e13
// operations, >= 9.8 ms at 1,979 TOPS, four times this kernel's byte bound.
//
// What bounds it on an H100.  The bytes it must move: the hits, B * 4096
// per tile (5.1 GB on K1's main path at B = 512, 1.53 ms at 3.35 TB/s), and
// the listed rows of the table read once (~2.4 GB).  The first form of this
// kernel unpacked every listed row into 8 bit planes of SWAR bytes (31
// instructions per 32-bit word per row in its SASS) and ran a tile's query
// groups ~2,400 blocks apart, so the rows the groups share came from DRAM
// again; it was bound by that re-reading first and by integer issue next.
// This form is bound by memory: a variant with the same loads and stores and
// no counting runs within 5% of it (B = 512, 10M table, NVIDIA H100 80GB
// HBM3).  Its design:
//
//   * one block per (layout tile, group of 16 queries), the group index
//     fastest, so a tile's groups run side by side and the rows they share
//     come from L2; one warp per query at a time; each lane owns 16 bytes
//     (4 words) of the tile's 512-byte row slice and reads them with one
//     coalesced 16-byte load per listed row;
//   * counts are bit-sliced: slice j of a word holds bit j of the 32
//     counters of its 32 bit positions.  Rows of multiplicity 1 enter 8 at
//     a time through a carry-save tree of full adders (one LOP3 for the sum,
//     one for the carry: 7 adders fold 8 words into slices 0-2 and one carry
//     at weight 8, which ripples up through half adders), then 4, 2, 1 for
//     the list's tail; rows of higher multiplicity enter through a
//     ripple-carry add of mult * word.  The query's multiplicity sum picks
//     the slice count at compile time (4..7: counts stay below 2^NS, so no
//     carry leaves the top slice), uniformly per warp.  In SASS the group
//     loop issues 3.5-4.2 instructions per word per row, and with the tails
//     and the transpose a headline list costs ~7, against 31;
//   * once per (query, tile) an 8 x 8 bit transpose (three delta-swap
//     stages) turns the slices into the 8 planes of SWAR bytes, each
//     stored as one 16-byte streaming write (a warp writes 512 contiguous
//     bytes per plane; evict-first, so the hits do not push table rows out
//     of L2); with kBmax the 128-term block maxima come from the same
//     registers: a byte-wise max over the lane's words, then a max over the
//     8 lanes that share a block.  K2 compiles that epilogue out.
//
// Every offset is size_t.  The kernel allocates nothing and does not
// synchronise.

#include "bitmap_hits.cuh"

namespace {

constexpr int kSubs = kTileLanes / 128;  // 128-term blocks per tile
constexpr int kQueriesPerBlock = 16;

__device__ __forceinline__ uint32_t byte_max(uint32_t x) {
  uint32_t a = max(x & 0xffu, (x >> 8) & 0xffu);
  uint32_t b = max((x >> 16) & 0xffu, x >> 24);
  return max(a, b);
}

// one block: a (layout tile, group of 16 queries) pair of either layout
template <bool kBmax, class Layout>
__device__ __forceinline__ void hits_block(const uint8_t* __restrict__ planes,
                                           const int32_t* __restrict__ rows,
                                           const int32_t* __restrict__ mults,
                                           int8_t* __restrict__ hits,
                                           int8_t* __restrict__ bmax,
                                           int n_queries, int ntiles, int vmax,
                                           const Layout& layout) {
  const int groups = (n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int tile = blockIdx.x / groups;
  const int group = blockIdx.x - tile * groups;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* tile_base = planes + layout.tile(tile) + (size_t)lane * 16;
  const size_t hits_row = (size_t)ntiles * kTileLanes;
  const int q_end = min(n_queries, (group + 1) * kQueriesPerBlock);

  for (int b = group * kQueriesPerBlock + warp; b < q_end; b += kWarps) {
    const int32_t* rp = rows + (size_t)b * vmax;
    const int32_t* mp = mults + (size_t)b * vmax;
    uint32_t acc[8][4];
    count_query(tile_base, layout, rp, mp, vmax, lane, acc);
    int8_t* hout = hits + (size_t)b * hits_row + (size_t)tile * kTileLanes +
                   (size_t)lane * 16;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      __stcs(reinterpret_cast<uint4*>(hout + p * kBlkb),
             make_uint4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]));
      if constexpr (kBmax) {
        int8_t* bout = bmax + (size_t)b * ntiles * kSubs + (size_t)tile * kSubs;
        uint32_t mx = byte_max(__vmaxu4(__vmaxu4(acc[p][0], acc[p][1]),
                                        __vmaxu4(acc[p][2], acc[p][3])));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        // lanes 8c..8c+7 cover bytes 128c..128c+127 of plane p: block p*4+c
        if ((lane & 7) == 0) bout[p * 4 + (lane >> 3)] = (int8_t)mx;
      }
    }
  }
}

// the resident tables' tile-major (ntiles, Gp, 512) layout
template <bool kBmax>
__global__ void __launch_bounds__(kWarps * 32, 1)
bitmap_hits_kernel(const uint8_t* __restrict__ planes,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ mults,
                   int8_t* __restrict__ hits,
                   int8_t* __restrict__ bmax,
                   int n_queries, int gp, int ntiles, int vmax) {
  hits_block<kBmax>(planes, rows, mults, hits, bmax, n_queries, ntiles, vmax,
                    TileMajor{gp});
}

// the row-major (Gp, NB) layout, NB = ntiles * 512
template <bool kBmax>
__global__ void __launch_bounds__(kWarps * 32, 1)
bitmap_hits_rowmajor_kernel(const uint8_t* __restrict__ planes,
                            const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ mults,
                            int8_t* __restrict__ hits,
                            int8_t* __restrict__ bmax,
                            int n_queries, int gp, int ntiles, int vmax) {
  hits_block<kBmax>(planes, rows, mults, hits, bmax, n_queries, ntiles, vmax,
                    Strided{(size_t)ntiles * kBlkb, (size_t)kBlkb});
}

template <bool kBmax, bool kRowMajor>
int launch(const void* planes, const void* rows, const void* mults,
           void* hits, void* bmax, int n_queries, int gp, int ntiles,
           int vmax, void* stream) {
  // the row list's vector loads need 16-byte aligned lists of <= 128
  if (vmax % 4 || vmax > 128) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)ntiles * ((n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = kRowMajor ? bitmap_hits_rowmajor_kernel<kBmax>
                          : bitmap_hits_kernel<kBmax>;
  kernel<<<(unsigned)blocks, kWarps * 32, 0,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(mults), static_cast<int8_t*>(hits),
      static_cast<int8_t*>(bmax), n_queries, gp, ntiles, vmax);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: hits and 128-term block maxima
extern "C" int bitmap_hits_bmax_launch(const void* planes, const void* rows,
                                       const void* mults, void* hits,
                                       void* bmax, int n_queries, int gp,
                                       int ntiles, int vmax, void* stream) {
  return launch<true, false>(planes, rows, mults, hits, bmax, n_queries, gp,
                             ntiles, vmax, stream);
}

// K2: hits only
extern "C" int bitmap_hits_launch(const void* planes, const void* rows,
                                  const void* mults, void* hits,
                                  int n_queries, int gp, int ntiles,
                                  int vmax, void* stream) {
  return launch<false, false>(planes, rows, mults, hits, nullptr, n_queries,
                              gp, ntiles, vmax, stream);
}

// K1 and K2 on a row-major (Gp, ntiles * 512) table
extern "C" int bitmap_hits_bmax_rowmajor_launch(const void* planes,
                                                const void* rows,
                                                const void* mults, void* hits,
                                                void* bmax, int n_queries,
                                                int gp, int ntiles, int vmax,
                                                void* stream) {
  return launch<true, true>(planes, rows, mults, hits, bmax, n_queries, gp,
                            ntiles, vmax, stream);
}

extern "C" int bitmap_hits_rowmajor_launch(const void* planes,
                                           const void* rows,
                                           const void* mults, void* hits,
                                           int n_queries, int gp, int ntiles,
                                           int vmax, void* stream) {
  return launch<false, true>(planes, rows, mults, hits, nullptr, n_queries,
                             gp, ntiles, vmax, stream);
}
