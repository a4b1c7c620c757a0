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
// for sum_g qcnt[b, g] <= 127.  Table layout is the reference's plane-tiled,
// tile-major form: planes (ntiles, Gp, 512) bytes, and bit p of byte k of
// tile j holds term j*4096 + p*512 + k.  So one 16-byte word of a row slice
// yields, for each of the 8 bit planes, 16 consecutive terms.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlkb = 512;          // bytes per layout tile row
constexpr int kTileLanes = 8 * kBlkb;  // terms per layout tile
constexpr int kSubs = kTileLanes / 128;  // 128-term blocks per tile
constexpr int kWarps = 8;
constexpr int kQueriesPerBlock = 16;

__device__ __forceinline__ uint32_t byte_max(uint32_t x) {
  uint32_t a = max(x & 0xffu, (x >> 8) & 0xffu);
  uint32_t b = max((x >> 16) & 0xffu, x >> 24);
  return max(a, b);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

__device__ __forceinline__ uint4 row_slice(const uint8_t* tile_base, int r) {
  return __ldg(reinterpret_cast<const uint4*>(tile_base + (size_t)r * kBlkb));
}

// full adder on 32 bit lanes: s <- s ^ a ^ b; returns the carry (weight 2s)
__device__ __forceinline__ uint32_t fa(uint32_t& s, uint32_t a, uint32_t b) {
  const uint32_t t = s;
  s = t ^ a ^ b;
  return (t & a) | (t & b) | (a & b);
}

// adds carry word c at slice L and ripples it up; nothing leaves the top
// slice, since every count stays below 2^NS
template <int NS, int L>
__device__ __forceinline__ void carry_in(uint32_t (&s)[NS], uint32_t c) {
  static_assert(L < NS, "carry above the top slice");
#pragma unroll
  for (int j = L; j < NS - 1; ++j) {
    const uint32_t t = s[j];
    s[j] = t ^ c;
    c = t & c;
  }
  s[NS - 1] ^= c;
}

// swaps bits [d, 2d) of each 2d-bit group of a with bits [0, d) of b's
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, int d,
                                          uint32_t mask) {
  const uint32_t t = ((a >> d) ^ b) & mask;
  b ^= t;
  a ^= t << d;
}

// slices (bit j of every count) -> planes (byte k of plane p = the count of
// bit 8k + p): per byte an 8 x 8 bit transpose
template <int NS>
__device__ __forceinline__ void to_planes(const uint32_t (&s)[NS],
                                          uint32_t (&t)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = j < NS ? s[j < NS ? j : 0] : 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) swap_bits(t[j], t[j + 4], 4, 0x0f0f0f0fu);
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    swap_bits(t[j], t[j + 2], 2, 0x33333333u);
    swap_bits(t[j + 1], t[j + 3], 2, 0x33333333u);
  }
#pragma unroll
  for (int j = 0; j < 8; j += 2) swap_bits(t[j], t[j + 1], 1, 0x55555555u);
}

// One query's counts over one tile slice: n1 rows of multiplicity 1 first,
// then n - n1 rows of higher multiplicity; acc[p][i] = plane p of word i.
template <int NS>
__device__ __forceinline__ void count_rows(const uint8_t* tile_base,
                                           const int32_t* rp,
                                           const int32_t* mp, int n1, int n,
                                           uint32_t (&acc)[8][4]) {
  uint32_t s[4][NS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NS; ++j) s[i][j] = 0u;
  }
  int v = 0;
  for (; v + 8 <= n1; v += 8) {
    const int4 ra = __ldg(reinterpret_cast<const int4*>(rp + v));
    const int4 rb = __ldg(reinterpret_cast<const int4*>(rp + v + 4));
    const uint4 x0 = row_slice(tile_base, ra.x), x1 = row_slice(tile_base, ra.y);
    const uint4 x2 = row_slice(tile_base, ra.z), x3 = row_slice(tile_base, ra.w);
    const uint4 x4 = row_slice(tile_base, rb.x), x5 = row_slice(tile_base, rb.y);
    const uint4 x6 = row_slice(tile_base, rb.z), x7 = row_slice(tile_base, rb.w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t a1 = fa(s[i][0], word(x0, i), word(x1, i));
      const uint32_t b1 = fa(s[i][0], word(x2, i), word(x3, i));
      const uint32_t a2 = fa(s[i][1], a1, b1);
      const uint32_t c1 = fa(s[i][0], word(x4, i), word(x5, i));
      const uint32_t d1 = fa(s[i][0], word(x6, i), word(x7, i));
      const uint32_t b2 = fa(s[i][1], c1, d1);
      carry_in<NS, 3>(s[i], fa(s[i][2], a2, b2));
    }
  }
  if (v + 4 <= n1) {  // v is a multiple of 8 here: aligned
    const int4 ra = __ldg(reinterpret_cast<const int4*>(rp + v));
    const uint4 x0 = row_slice(tile_base, ra.x), x1 = row_slice(tile_base, ra.y);
    const uint4 x2 = row_slice(tile_base, ra.z), x3 = row_slice(tile_base, ra.w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t a1 = fa(s[i][0], word(x0, i), word(x1, i));
      const uint32_t b1 = fa(s[i][0], word(x2, i), word(x3, i));
      carry_in<NS, 2>(s[i], fa(s[i][1], a1, b1));
    }
    v += 4;
  }
  if (v + 2 <= n1) {  // a multiple of 4: aligned
    const int2 ra = __ldg(reinterpret_cast<const int2*>(rp + v));
    const uint4 x0 = row_slice(tile_base, ra.x), x1 = row_slice(tile_base, ra.y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      carry_in<NS, 1>(s[i], fa(s[i][0], word(x0, i), word(x1, i)));
    }
    v += 2;
  }
  if (v < n1) {
    const uint4 x0 = row_slice(tile_base, __ldg(rp + v));
#pragma unroll
    for (int i = 0; i < 4; ++i) carry_in<NS, 0>(s[i], word(x0, i));
    ++v;
  }
  for (; v < n; ++v) {  // multiplicity m > 1: add m * word, bit by bit of m
    const uint32_t m = (uint32_t)__ldg(mp + v);
    const uint4 x0 = row_slice(tile_base, __ldg(rp + v));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = word(x0, i);
      uint32_t c = 0u;
#pragma unroll
      for (int j = 0; j < NS - 1; ++j) c = fa(s[i][j], (m >> j) & 1u ? w : 0u, c);
      s[i][NS - 1] ^= ((m >> (NS - 1)) & 1u ? w : 0u) ^ c;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t t[8];
    to_planes<NS>(s[i], t);
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[p][i] = t[p];
  }
}

template <bool kBmax>
__global__ void __launch_bounds__(kWarps * 32, 1)
bitmap_hits_kernel(const uint8_t* __restrict__ planes,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ mults,
                   int8_t* __restrict__ hits,
                   int8_t* __restrict__ bmax,
                   int n_queries, int gp, int ntiles, int vmax) {
  const int groups = (n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int tile = blockIdx.x / groups;
  const int group = blockIdx.x - tile * groups;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* tile_base =
      planes + (size_t)tile * (size_t)gp * kBlkb + (size_t)lane * 16;
  const size_t hits_row = (size_t)ntiles * kTileLanes;
  const int q_end = min(n_queries, (group + 1) * kQueriesPerBlock);

  for (int b = group * kQueriesPerBlock + warp; b < q_end; b += kWarps) {
    const int32_t* rp = rows + (size_t)b * vmax;
    const int32_t* mp = mults + (size_t)b * vmax;
    // the list's sum, its rows of multiplicity 1 and its length
    int total = 0, n1 = 0, n = 0;
    for (int k = lane; k < vmax; k += 32) {
      const int m = __ldg(mp + k);
      total += m;
      n1 += m == 1;
      n += m != 0;
    }
    total = __reduce_add_sync(0xffffffffu, total);
    n1 = __reduce_add_sync(0xffffffffu, n1);
    n = __reduce_add_sync(0xffffffffu, n);
    uint32_t acc[8][4];
    if (total <= 15) {
      count_rows<4>(tile_base, rp, mp, n1, n, acc);
    } else if (total <= 31) {
      count_rows<5>(tile_base, rp, mp, n1, n, acc);
    } else if (total <= 63) {
      count_rows<6>(tile_base, rp, mp, n1, n, acc);
    } else {
      count_rows<7>(tile_base, rp, mp, n1, n, acc);
    }
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

template <bool kBmax>
int launch(const void* planes, const void* rows, const void* mults,
           void* hits, void* bmax, int n_queries, int gp, int ntiles,
           int vmax, void* stream) {
  // the row list's vector loads need 16-byte aligned lists of <= 128
  if (vmax % 4 || vmax > 128) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)ntiles * ((n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bitmap_hits_kernel<kBmax><<<(unsigned)blocks, kWarps * 32, 0,
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
  return launch<true>(planes, rows, mults, hits, bmax, n_queries, gp, ntiles,
                      vmax, stream);
}

// K2: hits only
extern "C" int bitmap_hits_launch(const void* planes, const void* rows,
                                  const void* mults, void* hits,
                                  int n_queries, int gp, int ntiles,
                                  int vmax, void* stream) {
  return launch<false>(planes, rows, mults, hits, nullptr, n_queries, gp,
                       ntiles, vmax, stream);
}
