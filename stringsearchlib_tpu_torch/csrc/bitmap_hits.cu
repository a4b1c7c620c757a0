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
// K2w, the wide counts (bitmap_hits_wide_launch), is the same counting body
// under an int32 epilogue, for queries of more than 127 gram windows.  It
// replaces no Pallas kernel: the reference's route for such queries is an
// XLA scan, candidates_bitmap_impl (stringsearchlib_tpu/search/
// candidates.py:1048), which accumulates one unpacked table row per query
// gram slot into int32 hits.  Contract:
//
//   hits[b, t] = sum_g qcnt[b, g] * bit(g, t)        int32, term order
//
// for sum_g qcnt[b, g] <= 65535 a launch, on tile-major tables; with
// `accumulate` set a launch adds its counts into the hits already in place,
// so the wrapper splits larger sums into parts of at most 65535 a row (hits
// are linear in the multiplicities) and launches once a part, the first
// storing and the rest accumulating.  The list's sum picks
// 8..16 counter slices per warp (counts below 2^NS); each group of 8 slices
// goes through the same 8 x 8 transpose, which gives the low and the high
// byte of every count, and __byte_perm joins them into 16-bit halves.  What
// bounds it: the listed rows read once and the int32 hits written once,
// four times K2's hit bytes; so each plane's 16 counts per lane are staged
// through the warp's 2 KB of shared memory and written back as 512
// contiguous bytes per store instruction (the store path of P8's int32
// epilogue, csrc/probe_hits.cu store_raw32_staged), every 32-byte sector
// whole; an accumulating launch (its own instance of the kernel, so the
// storing one keeps its code) reads the hits in place the same way, 512
// contiguous bytes per load instruction, and adds before it stores, in a
// helper that is not inlined (inlined, the instance took 122-123
// registers; so it takes 116, the storing one 117).  More counter slices
// per launch would not serve: 16 take 117 registers, and 32 would spill.
//
// Every offset is size_t.  The kernels allocate nothing and do not
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

// K2w's accumulating epilogue for one plane: the staged counts (chunk q at
// q ^ ((q >> 3) & 3), as wide_query writes them) added to the hits in place
__device__ __noinline__ void add_plane(uint4* dst, const uint4* stage, int lane) {
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    const int q = c * 32 + lane;
    const uint4 v = stage[q ^ ((q >> 3) & 3)];
    const uint4 h = __ldcs(dst + q);
    __stcs(dst + q, make_uint4(v.x + h.x, v.y + h.y, v.z + h.z, v.w + h.w));
  }
}

// K2w's epilogue for one (query, tile): the lane's 16 terms of each plane
// (byte k of word i is term 16 * lane + 4 * i + k) as int32 counts, staged
// through the warp's 2 KB of shared memory.  Chunk q (16 bytes) of a plane
// sits at q ^ ((q >> 3) & 3), so the lanes' writes (chunks 4 lane + c) and
// reads (chunks 32 c + lane) are free of bank conflicts.
template <int NS, bool kAcc>
__device__ __forceinline__ void wide_query(const uint8_t* tile_base,
                                           const int32_t* rp, const int32_t* mp,
                                           int n1, int n, int gp, int lane,
                                           int32_t* out, uint4* stage) {
  static_assert(NS >= 8 && NS <= 16, "two groups of 8 slices at most");
  uint32_t lo[4][8], hi[4][8];
  {
    uint32_t s[4][NS];
    count_slices<NS>(tile_base, TileMajor{gp}, rp, mp, n1, n, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      to_planes<NS, 0>(s[i], lo[i]);
      to_planes<NS, 8>(s[i], hi[i]);
    }
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    uint32_t o[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bytes 0, 1 and 2, 3 of the plane word: count = low | high << 8
      const uint32_t x = __byte_perm(lo[i][p], hi[i][p], 0x5140);
      const uint32_t y = __byte_perm(lo[i][p], hi[i][p], 0x7362);
      o[4 * i] = x & 0xffffu;
      o[4 * i + 1] = x >> 16;
      o[4 * i + 2] = y & 0xffffu;
      o[4 * i + 3] = y >> 16;
    }
    __syncwarp();  // every lane has read the previous plane from the stage
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = lane * 4 + c;
      stage[q ^ ((q >> 3) & 3)] = make_uint4(o[4 * c], o[4 * c + 1], o[4 * c + 2],
                                             o[4 * c + 3]);
    }
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)p * kBlkb);
    if constexpr (kAcc) {
      add_plane(dst, stage, lane);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = c * 32 + lane;
        __stcs(dst + q, stage[q ^ ((q >> 3) & 3)]);
      }
    }
  }
}

// K2w: one block per (layout tile, group of 16 queries), the group fastest,
// one warp per query at a time, as K1; tile-major tables; kAcc adds into
// the hits in place
template <bool kAcc>
__global__ void __launch_bounds__(kWarps * 32, 1)
bitmap_hits_wide_kernel(const uint8_t* __restrict__ planes,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ mults,
                        int32_t* __restrict__ hits,
                        int n_queries, int gp, int ntiles, int vmax) {
  const int groups = (n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int tile = blockIdx.x / groups;
  const int group = blockIdx.x - tile * groups;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* tile_base = planes + TileMajor{gp}.tile(tile) + (size_t)lane * 16;
  const size_t hits_row = (size_t)ntiles * kTileLanes;
  const int q_end = min(n_queries, (group + 1) * kQueriesPerBlock);
  __shared__ uint4 stage[kWarps * 128];  // 2 KB a warp
  for (int b = group * kQueriesPerBlock + warp; b < q_end; b += kWarps) {
    const int32_t* rp = rows + (size_t)b * vmax;
    const int32_t* mp = mults + (size_t)b * vmax;
    int total, n1, n;
    list_stats(mp, vmax, lane, total, n1, n);
    int32_t* out = hits + (size_t)b * hits_row + (size_t)tile * kTileLanes;
    uint4* st = stage + warp * 128;
    // slices for counts below 2^NS: the bits of the sum, at least 8
    switch (max(8, 32 - __clz(total))) {
      case 8: wide_query<8, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      case 9: wide_query<9, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      case 10: wide_query<10, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      case 11: wide_query<11, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      case 12: wide_query<12, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      case 13: wide_query<13, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      case 14: wide_query<14, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      case 15: wide_query<15, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
      default: wide_query<16, kAcc>(tile_base, rp, mp, n1, n, gp, lane, out, st); break;
    }
  }
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

// K2w: int32 hits of sums up to 65535 on a tile-major table, stored, or
// added to the hits in place when `accumulate` is nonzero; lists of any
// width that is a multiple of 4
extern "C" int bitmap_hits_wide_launch(const void* planes, const void* rows,
                                       const void* mults, void* hits,
                                       int n_queries, int gp, int ntiles,
                                       int vmax, int accumulate, void* stream) {
  if (vmax % 4 || vmax <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)ntiles * ((n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = accumulate ? bitmap_hits_wide_kernel<true>
                           : bitmap_hits_wide_kernel<false>;
  kernel<<<(unsigned)blocks, kWarps * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(mults), static_cast<int32_t*>(hits), n_queries,
      gp, ntiles, vmax);
  return (int)cudaGetLastError();
}
