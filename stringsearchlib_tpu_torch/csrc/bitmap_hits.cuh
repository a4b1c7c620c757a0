// The counting body of the hit-count kernels: one query's bit-plane counts
// over one 512-byte slice of a layout tile, from a compacted row list.
//
// Shared by csrc/bitmap_hits.cu (K1 / K2, and the wide counts K2w) and
// csrc/probe_hits.cu (the K1 probes P4-P9), which differ only in their
// epilogues.  bitmap_hits.cu's head comment describes the scheme:
// bit-sliced carry-save counters per 32-bit word, rows of multiplicity 1
// entering 8, 4, 2, 1 at a time, higher multiplicities through a
// ripple-carry add, and an 8 x 8 bit transpose into the 8 planes of SWAR
// bytes (K2w transposes each group of 8 slices alike).
//
// Table layouts (bit p of byte k of tile j holds term j*4096 + p*512 + k):
// tile-major (ntiles, Gp, 512), where row r's slice of tile j sits at
// j*Gp*512 + r*512, and row-major (Gp, NB), where it sits at r*NB + j*512.
//
// A private header of csrc/: everything is in an anonymous namespace, so
// each source that includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlkb = 512;          // bytes per layout tile row
constexpr int kTileLanes = 8 * kBlkb;  // terms per layout tile
constexpr int kWarps = 8;

// the tile-major layout: a tile's rows 512 bytes apart
struct TileMajor {
  int gp;
  __device__ __forceinline__ size_t tile(int t) const {
    return (size_t)t * (size_t)gp * kBlkb;
  }
  __device__ __forceinline__ size_t row(int r) const { return (size_t)r * kBlkb; }
};

// any layout given by its strides in bytes: row-major is (NB, 512),
// tile-major (512, Gp * 512)
struct Strided {
  size_t row_stride, tile_stride;
  __device__ __forceinline__ size_t tile(int t) const { return (size_t)t * tile_stride; }
  __device__ __forceinline__ size_t row(int r) const { return (size_t)r * row_stride; }
};

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

template <class Layout>
__device__ __forceinline__ uint4 row_slice(const uint8_t* tile_base,
                                           const Layout& layout, int r) {
  return __ldg(reinterpret_cast<const uint4*>(tile_base + layout.row(r)));
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

// slices OFF..OFF+7 (bit OFF + j of every count; slices past NS are 0) ->
// planes (byte k of plane p = those 8 bits of the count of bit 8k + p): per
// byte an 8 x 8 bit transpose
template <int NS, int OFF = 0>
__device__ __forceinline__ void to_planes(const uint32_t (&s)[NS],
                                          uint32_t (&t)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = OFF + j < NS ? s[OFF + j < NS ? OFF + j : 0] : 0u;
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

// One query's bit-sliced counts over one tile slice: n1 rows of
// multiplicity 1 first, then n - n1 rows of higher multiplicity;
// s[i][j] = slice j of word i.  Every count stays below 2^NS.
template <int NS, class Layout>
__device__ __forceinline__ void count_slices(const uint8_t* tile_base,
                                             const Layout& layout,
                                             const int32_t* rp,
                                             const int32_t* mp, int n1, int n,
                                             uint32_t (&s)[4][NS]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NS; ++j) s[i][j] = 0u;
  }
  int v = 0;
  for (; v + 8 <= n1; v += 8) {
    const int4 ra = __ldg(reinterpret_cast<const int4*>(rp + v));
    const int4 rb = __ldg(reinterpret_cast<const int4*>(rp + v + 4));
    const uint4 x0 = row_slice(tile_base, layout, ra.x);
    const uint4 x1 = row_slice(tile_base, layout, ra.y);
    const uint4 x2 = row_slice(tile_base, layout, ra.z);
    const uint4 x3 = row_slice(tile_base, layout, ra.w);
    const uint4 x4 = row_slice(tile_base, layout, rb.x);
    const uint4 x5 = row_slice(tile_base, layout, rb.y);
    const uint4 x6 = row_slice(tile_base, layout, rb.z);
    const uint4 x7 = row_slice(tile_base, layout, rb.w);
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
    const uint4 x0 = row_slice(tile_base, layout, ra.x);
    const uint4 x1 = row_slice(tile_base, layout, ra.y);
    const uint4 x2 = row_slice(tile_base, layout, ra.z);
    const uint4 x3 = row_slice(tile_base, layout, ra.w);
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
    const uint4 x0 = row_slice(tile_base, layout, ra.x);
    const uint4 x1 = row_slice(tile_base, layout, ra.y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      carry_in<NS, 1>(s[i], fa(s[i][0], word(x0, i), word(x1, i)));
    }
    v += 2;
  }
  if (v < n1) {
    const uint4 x0 = row_slice(tile_base, layout, __ldg(rp + v));
#pragma unroll
    for (int i = 0; i < 4; ++i) carry_in<NS, 0>(s[i], word(x0, i));
    ++v;
  }
  for (; v < n; ++v) {  // multiplicity m > 1: add m * word, bit by bit of m
    const uint32_t m = (uint32_t)__ldg(mp + v);
    const uint4 x0 = row_slice(tile_base, layout, __ldg(rp + v));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = word(x0, i);
      uint32_t c = 0u;
#pragma unroll
      for (int j = 0; j < NS - 1; ++j) c = fa(s[i][j], (m >> j) & 1u ? w : 0u, c);
      s[i][NS - 1] ^= ((m >> (NS - 1)) & 1u ? w : 0u) ^ c;
    }
  }
}

// One query's counts over one tile slice as SWAR bytes (NS <= 8):
// acc[p][i] = plane p of word i.
template <int NS, class Layout>
__device__ __forceinline__ void count_rows(const uint8_t* tile_base,
                                           const Layout& layout,
                                           const int32_t* rp,
                                           const int32_t* mp, int n1, int n,
                                           uint32_t (&acc)[8][4]) {
  uint32_t s[4][NS];
  count_slices<NS>(tile_base, layout, rp, mp, n1, n, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t t[8];
    to_planes<NS>(s[i], t);
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[p][i] = t[p];
  }
}

// A query list's sum, its rows of multiplicity 1 and its length, over the
// warp (every lane gets them)
__device__ __forceinline__ void list_stats(const int32_t* mp, int vmax, int lane,
                                           int& total, int& n1, int& n) {
  total = n1 = n = 0;
  for (int k = lane; k < vmax; k += 32) {
    const int m = __ldg(mp + k);
    total += m;
    n1 += m == 1;
    n += m != 0;
  }
  total = __reduce_add_sync(0xffffffffu, total);
  n1 = __reduce_add_sync(0xffffffffu, n1);
  n = __reduce_add_sync(0xffffffffu, n);
}

// One warp: query list (rp, mp) of length vmax (zero-terminated, rows of
// multiplicity 1 first) over the tile slice at tile_base (row 0, this lane's
// 16 bytes).  The list's sum picks the slice count, uniformly per warp.
template <class Layout>
__device__ __forceinline__ void count_query(const uint8_t* tile_base,
                                            const Layout& layout,
                                            const int32_t* rp,
                                            const int32_t* mp, int vmax,
                                            int lane, uint32_t (&acc)[8][4]) {
  int total, n1, n;
  list_stats(mp, vmax, lane, total, n1, n);
  if (total <= 15) {
    count_rows<4>(tile_base, layout, rp, mp, n1, n, acc);
  } else if (total <= 31) {
    count_rows<5>(tile_base, layout, rp, mp, n1, n, acc);
  } else if (total <= 63) {
    count_rows<6>(tile_base, layout, rp, mp, n1, n, acc);
  } else {
    count_rows<7>(tile_base, layout, rp, mp, n1, n, acc);
  }
}

}  // namespace
