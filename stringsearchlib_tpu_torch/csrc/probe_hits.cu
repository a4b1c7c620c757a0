// The K1 probes P4-P9: K1's counting body under the TPU probes' epilogues.
//
// Replaces the Pallas kernels of the reference's K1 probes (tools/), each a
// variant of K1's pair-dot kernel that stores something else per tile:
//
//   P4-P7 tools/probe_layout_r5.py:215-317 pair (row, tile, tile_q2, tile_o3)
//   P8    tools/probe_kernel_raw.py:136-182 raw_hits (i16 and i32)
//   P9    tools/probe_kernel_bisect.py:141-210 run (base, onedot, nodecode,
//         rawi32, onestore, noand)
//
// Each TPU kernel takes five int8 dots per layout tile, acc_m = q . (t & m)
// for PAIR_MASKS m = (0b100001, 0b1000010, -124, 8, 16), or, in `noand`, the
// plain signed dot q . t.  Under the contract (q non-negative integer
// counts, each row summing to <= 127) K1's carry-save counters give the
// exact plane counts h_p <= 127 of every term, and every accumulator is a
// fixed integer combination of them:
//
//   acc0 = h0 + 32 h5   acc1 = 2 h1 + 64 h6   acc2 = 4 h2 - 128 h7
//   acc3 = 8 h3         acc4 = 16 h4          q . t = sum_p w_p h_p,
//                                             w = (1, 2, ..., 64, -128)
//
// so this kernel counts exactly as K1 does (bitmap_hits.cuh) and computes,
// per term, in int32 what the TPU epilogue computed: decode_planes
// (probe_layout_r5.py:185-191, arithmetic shifts, bit-identical also above
// 31 windows where its fields carry), masks, sums, and the wrapping casts to
// int8 / int16.  Slot s of tile j for query b is element
// b * out_q_stride + j * out_t_stride + s * 512 + k, so one instance serves
// the term-ordered outputs (b, ntiles * W * 512) and P7's tile-major
// (ntiles, b, W * 512); the table's row and tile strides serve both input
// layouts.
//
// What bounds it on an H100: as K1, the listed rows read once and the
// outputs written once (W * 512 elements per (query, tile): 4 KB for the
// decoded variants, 5 KB of int16 or 10 KB of int32 raw accumulators).  The
// epilogue is per-term integer work (about 40 operations a term for the
// decode) where K1 stores its SWAR bytes as they come; a first, simple form.
// The int32 epilogue (P8 i32, P9 rawi32), whose 10 KB per (query, tile)
// make it the most store-bound, emits one slot at a time through shared
// memory (store_raw32_staged): 16 words live where store_slots holds all
// five slots' 80, and 512 contiguous bytes per store instruction where
// store_slots' 16-byte vectors lie 64 bytes apart (half of each sector per
// instruction).
//
// P6 (`tile_q2`, two query blocks resident and one table read): one block
// serves 32 queries, two of K1's 16-query groups, so a row that several of
// them list is read from L2 once per block and then from L1 (loads through
// the read-only path), where K1 reads it once per group.
//
// The kernel allocates nothing and does not synchronise.

#include "bitmap_hits.cuh"

namespace {

enum Epilogue {
  kPair = 0,      // decode_planes -> 8 int8 slots (P4-P7, P9 base)
  kRaw16 = 1,     // the 5 accumulators as int16 (P8 i16)
  kRaw32 = 2,     // as int32 (P8 i32, P9 rawi32)
  kOneDot = 3,    // decode_planes of [acc0] * 5 -> 8 int8 slots
  kNoDecode = 4,  // acc & 127 -> 5 int8 slots
  kNoAnd = 5,     // (q . t) & 127 -> 5 int8 slots
  kOneStore = 6,  // (sum of the 8 decoded planes) & 127 -> 1 int8 slot
};

template <int E>
struct Epi {
  static constexpr int kWidth = (E == kPair || E == kOneDot) ? 8
                                : E == kOneStore             ? 1
                                                             : 5;
  static constexpr int kBytes = E == kRaw16 ? 2 : E == kRaw32 ? 4 : 1;
};

// probe_layout_r5.py:185-191 decode_planes, int32
__device__ __forceinline__ void decode_planes(int p0, int p1, int p27, int p3,
                                              int p4, int (&d)[8]) {
  const int h7 = (127 - p27) >> 7;
  d[0] = p0 & 31;
  d[1] = (p1 >> 1) & 31;
  d[2] = (p27 + h7 * 128) >> 2;
  d[3] = p3 >> 3;
  d[4] = p4 >> 4;
  d[5] = p0 >> 5;
  d[6] = p1 >> 6;
  d[7] = h7;
}

// one term's outputs from its 8 plane counts
template <int E>
__device__ __forceinline__ void term_values(const int (&h)[8],
                                            int (&v)[Epi<E>::kWidth]) {
  const int a[5] = {h[0] + 32 * h[5], 2 * h[1] + 64 * h[6],
                    4 * h[2] - 128 * h[7], 8 * h[3], 16 * h[4]};
  if constexpr (E == kPair) {
    decode_planes(a[0], a[1], a[2], a[3], a[4], v);
  } else if constexpr (E == kOneDot) {
    decode_planes(a[0], a[0], a[0], a[0], a[0], v);
  } else if constexpr (E == kRaw16 || E == kRaw32) {
#pragma unroll
    for (int s = 0; s < 5; ++s) v[s] = a[s];
  } else if constexpr (E == kNoDecode) {
#pragma unroll
    for (int s = 0; s < 5; ++s) v[s] = a[s] & 127;
  } else if constexpr (E == kNoAnd) {
    const int dot = h[0] + 2 * h[1] + 4 * h[2] + 8 * h[3] + 16 * h[4] +
                    32 * h[5] + 64 * h[6] - 128 * h[7];
#pragma unroll
    for (int s = 0; s < 5; ++s) v[s] = dot & 127;
  } else {  // kOneStore
    int d[8];
    decode_planes(a[0], a[1], a[2], a[3], a[4], d);
    int tot = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) tot += d[p];
    v[0] = tot & 127;
  }
}

// One (query, tile): the lane's 16 terms of each plane (acc[p][i], byte j of
// word i is term 16 * lane + 4 * i + j) -> its 16 elements of each slot,
// stored as 16-byte streaming writes (a warp writes each slot contiguously).
template <int E>
__device__ __forceinline__ void store_slots(const uint32_t (&acc)[8][4],
                                            uint8_t* out, int lane) {
  constexpr int W = Epi<E>::kWidth, EB = Epi<E>::kBytes;
  constexpr uint32_t mask = EB == 4 ? 0xffffffffu : (1u << (8 * EB)) - 1u;
  uint32_t o[W][4 * EB];
#pragma unroll
  for (int s = 0; s < W; ++s) {
#pragma unroll
    for (int w = 0; w < 4 * EB; ++w) o[s][w] = 0u;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    int h[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) h[p] = (acc[p][t >> 2] >> (8 * (t & 3))) & 0xff;
    int v[W];
    term_values<E>(h, v);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      o[s][t * EB / 4] |= ((uint32_t)v[s] & mask) << (8 * (t * EB % 4));
    }
  }
#pragma unroll
  for (int s = 0; s < W; ++s) {
#pragma unroll
    for (int c = 0; c < EB; ++c) {
      __stcs(reinterpret_cast<uint4*>(out + ((size_t)s * kBlkb + (size_t)lane * 16) * EB +
                                      16 * c),
             make_uint4(o[s][4 * c], o[s][4 * c + 1], o[s][4 * c + 2], o[s][4 * c + 3]));
    }
  }
}

// kRaw32's store path: one slot at a time (16 words live), staged through
// the warp's 2 KB of shared memory and written back as 512 contiguous bytes
// per store instruction, four per slot, so every 32-byte sector is written
// whole by one instruction.  Chunk q (16 bytes) of the slot sits at
// q ^ ((q >> 3) & 3): the lanes' 16-byte writes (chunks 4 lane + c) and
// reads (chunks 32 c + lane) then each meet the 8 distinct bank groups
// within a quarter warp, free of bank conflicts.
__device__ __forceinline__ void store_raw32_staged(const uint32_t (&acc)[8][4],
                                                   uint8_t* out, int lane,
                                                   uint4* stage) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    uint32_t o[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      int h[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) h[p] = (acc[p][t >> 2] >> (8 * (t & 3))) & 0xff;
      int v[5];
      term_values<kRaw32>(h, v);
      o[t] = (uint32_t)v[s];
    }
    __syncwarp();  // every lane has read the previous slot from the stage
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = lane * 4 + c;
      stage[q ^ ((q >> 3) & 3)] = make_uint4(o[4 * c], o[4 * c + 1], o[4 * c + 2],
                                             o[4 * c + 3]);
    }
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)s * kBlkb * 4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = c * 32 + lane;
      __stcs(dst + q, stage[q ^ ((q >> 3) & 3)]);
    }
  }
}

// one block per (layout tile, group of QPB queries), the group fastest;
// one warp per query at a time, as K1
template <int E, int QPB>
__global__ void __launch_bounds__(kWarps * 32, 1)
probe_hits_kernel(const uint8_t* __restrict__ planes,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ mults,
                  uint8_t* __restrict__ out, int n_queries, int vmax,
                  Strided layout, size_t out_q_stride, size_t out_t_stride) {
  const int groups = (n_queries + QPB - 1) / QPB;
  const int tile = blockIdx.x / groups;
  const int group = blockIdx.x - tile * groups;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* tile_base = planes + layout.tile(tile) + (size_t)lane * 16;
  const int q_end = min(n_queries, (group + 1) * QPB);
  __shared__ uint4 stage[E == kRaw32 ? kWarps * 128 : 1];  // kRaw32: 2 KB a warp
  for (int b = group * QPB + warp; b < q_end; b += kWarps) {
    uint32_t acc[8][4];
    count_query(tile_base, layout, rows + (size_t)b * vmax,
                mults + (size_t)b * vmax, vmax, lane, acc);
    uint8_t* o = out + ((size_t)b * out_q_stride + (size_t)tile * out_t_stride) *
                           Epi<E>::kBytes;
    if constexpr (E == kRaw32) {
      store_raw32_staged(acc, o, lane, stage + warp * 128);
    } else {
      store_slots<E>(acc, o, lane);
    }
  }
}

template <int E, int QPB>
int launch(const void* planes, const void* rows, const void* mults, void* out,
           int n_queries, int ntiles, int vmax, Strided layout,
           size_t out_q_stride, size_t out_t_stride, cudaStream_t stream) {
  const long long blocks = (long long)ntiles * ((n_queries + QPB - 1) / QPB);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe_hits_kernel<E, QPB><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(mults), static_cast<uint8_t*>(out), n_queries,
      vmax, layout, out_q_stride, out_t_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: the table, row r of tile j at j * tile_stride + r * row_stride
// bytes; rows / mults: (n_queries, vmax) zero-terminated lists as K1's
// wrapper compacts them; out: element strides per query and per tile;
// epilogue: an Epilogue; queries_per_block: 16, or 32 for P6 (kPair only).
extern "C" int probe_hits_launch(const void* planes, const void* rows,
                                 const void* mults, void* out, int n_queries,
                                 int ntiles, int vmax, long long row_stride,
                                 long long tile_stride, long long out_q_stride,
                                 long long out_t_stride, int epilogue,
                                 int queries_per_block, void* stream) {
  // the row list's vector loads need 16-byte aligned lists of <= 128
  if (vmax % 4 || vmax > 128) return (int)cudaErrorInvalidValue;
  const Strided layout{(size_t)row_stride, (size_t)tile_stride};
  const size_t qs = (size_t)out_q_stride, ts = (size_t)out_t_stride;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (queries_per_block == 32) {
    if (epilogue != kPair) return (int)cudaErrorInvalidValue;
    return launch<kPair, 32>(planes, rows, mults, out, n_queries, ntiles, vmax,
                             layout, qs, ts, s);
  }
  if (queries_per_block != 16) return (int)cudaErrorInvalidValue;
  switch (epilogue) {
    case kPair:
      return launch<kPair, 16>(planes, rows, mults, out, n_queries, ntiles, vmax,
                               layout, qs, ts, s);
    case kRaw16:
      return launch<kRaw16, 16>(planes, rows, mults, out, n_queries, ntiles, vmax,
                                layout, qs, ts, s);
    case kRaw32:
      return launch<kRaw32, 16>(planes, rows, mults, out, n_queries, ntiles, vmax,
                                layout, qs, ts, s);
    case kOneDot:
      return launch<kOneDot, 16>(planes, rows, mults, out, n_queries, ntiles, vmax,
                                 layout, qs, ts, s);
    case kNoDecode:
      return launch<kNoDecode, 16>(planes, rows, mults, out, n_queries, ntiles,
                                   vmax, layout, qs, ts, s);
    case kNoAnd:
      return launch<kNoAnd, 16>(planes, rows, mults, out, n_queries, ntiles, vmax,
                                layout, qs, ts, s);
    case kOneStore:
      return launch<kOneStore, 16>(planes, rows, mults, out, n_queries, ntiles,
                                   vmax, layout, qs, ts, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
