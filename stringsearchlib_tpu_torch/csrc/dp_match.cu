// Batched semi-global edit distance: out[b, n] = qlen[b] - the least edit
// distance between query b and any substring of term n (free leading and
// trailing gaps in the term), the reference's stringMatch
// (nGramSearch.hpp:182-222) for B queries x N terms.
//
// Replaces the TPU kernel of tools/experimental/dp_pallas.py (_dp_kernel
// :45, _dp_call :86, pallas_call :112, dp_match_batch :121).  That kernel
// kept one (term tile, query) program's DP rows on the 128 vector lanes and
// removed the in-row dependency with a log-step roll/cummin scan, so it
// stopped at W <= 127 and left most lanes idle at short-tier widths.  None
// of that scheme is carried over.
//
// What bounds it on an H100: 32-bit integer issue.  The bytes (each term
// once, the lengths, the (B, N) int32 output) are small beside the work
// once B > 1.  So the body does the least work per pair it can:
//
//   * Myers' bit-vector recurrence (Myers 1999, in Hyyro's formulation),
//     the query as the pattern and the term as the text: per term
//     character, 11 operations for each 32 query characters (10 in the
//     lowest word) and 3 for the score and its minimum, in place of ~5 per
//     DP cell.  The vertical deltas (Pv, Mv) live in ceil(m/32)
//     32-bit words; a word passes its horizontal delta (the add's carry and
//     the shifted Ph/Mh bit) to the next.  Nothing enters the lowest word
//     (D[0][j] = 0, semi-global).  The query sits at the top of its words:
//     pad = 32 ceil(m/32) - m rows below it match every character and start
//     with vertical delta 0, so D stays 0 along them, and query position
//     m - 1 is bit 31 of the top word, whose outgoing horizontal delta
//     moves the score (from m).  The result takes the least score over j
//     in [0, len], D[m][0] = m included.  Query positions >= m are never
//     set in a mask.  A query of 1-3 characters pays a whole step, up to 3x
//     the 5m operations of its DP cells; a cell-DP branch for m = 1 measured
//     slower (its per-query branch costs more than it saves), so there is
//     none.
//   * The word count is a template parameter (1, 2, 4 or 8, the least that
//     holds Qp), so the state stays in registers; a query uses only its own
//     ceil(m/32) words, a branch uniform across the block.
//   * Work order: a thread owns a term and a block (128 terms) a chunk of
//     16 / NW queries (one query when the call has too few to fill a
//     chunk: its registers then hold one query's state, so more blocks fit
//     an SM), the grid (term tiles, query chunks); the grid holds as many
//     blocks as the card keeps resident (the occupancy API's blocks per SM
//     x the SM count) and a block walks its share of the tiles, so its
//     masks serve them all.  The thread reads its term once per chunk, 16 bytes
//     at a time where the row allows, and advances every query of the chunk
//     by each character, so all their states sit in registers together
//     (ILP across queries) and the row lookup is paid once per character
//     for the chunk.  Stores go along N for each query and coalesce.
//   * Match masks (Eq) are built by the block in shared memory for its
//     chunk, inside the launch: for uint8 terms a 256-row table indexed by
//     the byte; for int32 code points the chunk's distinct code points in
//     an open-addressing hash (64-bit keys, so every int32 is a key), each
//     given a dense row, and one row for a character no query of the chunk
//     holds.  The table is lane-major (lane = query x NW + word), so the
//     threads of a warp read one lane at their own rows: distinct
//     characters fall in distinct banks.  At most 45 KB of shared memory,
//     so no opt-in above 48 KB is needed.
//   * Past 8 words (a query over 256 characters) a second kernel keeps the
//     vector in a global scratch the wrapper allocates (word-major, so
//     neighbouring threads touch neighbouring words), builds each mask word
//     from the query on the fly, and walks the terms with a bounded grid.
//
// Exact for every qlen and every width W.  The kernels allocate nothing and
// the launch is one kernel, checked with cudaGetLastError.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 16;  // mask words per row of a full chunk
constexpr int kBig = 1 << 30;
// a budget of 128 registers a thread: without it ptxas kept some instances
// at 72 and spilled
constexpr int kMinBlocks = 4;

__device__ __forceinline__ int clamp_len(int m, int qp) {
  return min(max(m, 0), qp);
}

// One column of the recurrence for one query: NW words, words above `top`
// skipped; the query's last position is bit 31 of word `top`, so `score`
// follows the horizontal delta that word passes on.
template <int NW>
__device__ __forceinline__ void column(uint32_t* pv, uint32_t* mv,
                                       const uint32_t* eq, int top, int& score) {
  uint32_t hp = 0, hm = 0;  // horizontal delta entering the word
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if (NW > 1 && k > top) break;
    const uint32_t p = pv[k], n = mv[k];
    const uint32_t xv = eq[k] | n;
    const uint32_t e = eq[k] | hm;
    const uint32_t xh = (((e & p) + p) ^ p) | e;
    uint32_t ph = n | ~(xh | p);
    uint32_t mh = p & xh;
    const uint32_t hp_out = ph >> 31, hm_out = mh >> 31;
    if (NW == 1 || k == top) score += (int)hp_out - (int)hm_out;
    ph = (ph << 1) | hp;
    mh = (mh << 1) | hm;
    pv[k] = mh | ~(xv | ph);
    mv[k] = ph & xv;
    hp = hp_out;
    hm = hm_out;
  }
}

__device__ __forceinline__ uint32_t hash_slot(uint32_t c, int hbits) {
  return (c * 2654435761u) >> (32 - hbits);
}

// Register-state kernel: NW words per query, a chunk of QC queries per
// block (kLanes / NW, or 1).  Shared memory: the mask table, QC x NW lanes
// (lane = query x NW + word) of `rows` words each, then (int32 terms) the
// hash's keys and dense rows.
template <typename T, int NW, int QC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dp_match_kernel(const T* __restrict__ tokens, const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ qtok, const int32_t* __restrict__ qlens,
                int32_t* __restrict__ out, int n, int w, int nb, int qp,
                int hbits, int vb) {
  constexpr int kL = QC * NW;  // mask words per row
  constexpr bool kBytes = sizeof(T) == 1;
  extern __shared__ uint4 smem[];
  __shared__ int s_rows;
  __shared__ uint32_t s_pad[QC];  // each query's padding rows (word 0)
  __shared__ int s_m[QC];
  uint32_t* eqs = reinterpret_cast<uint32_t*>(smem);
  const int rows = kBytes ? 256 : QC * qp + 1;  // a lane's stride
  const int hsize = 1 << hbits;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(eqs + rows * kL);
  int* ids = reinterpret_cast<int*>(keys + hsize);
  const int nchunks = (nb + QC - 1) / QC;
  const size_t rb = (size_t)w * sizeof(T);

  for (int chunk = blockIdx.y; chunk < nchunks; chunk += gridDim.y) {
    const int b0 = chunk * QC;
    const int nq = min(QC, nb - b0);
    __syncthreads();  // the previous chunk's masks are no longer read
    if (threadIdx.x < QC) {
      const int m = threadIdx.x < nq ? clamp_len(qlens[b0 + threadIdx.x], qp) : 0;
      s_m[threadIdx.x] = m;
      s_pad[threadIdx.x] = (1u << ((32 - (m & 31)) & 31)) - 1u;
    }
    if (!kBytes) {
      for (int i = threadIdx.x; i < hsize; i += kThreads) keys[i] = 0ull;
      if (threadIdx.x == 0) s_rows = 0;
      __syncthreads();
      // the chunk's distinct code points, each given a dense row
      for (int it = threadIdx.x; it < nq * qp; it += kThreads) {
        const int q = it / qp, i = it - q * qp;
        if (i >= s_m[q]) continue;
        const uint32_t c = (uint32_t)qtok[(size_t)(b0 + q) * qp + i];
        const unsigned long long key = (1ull << 32) | c;
        uint32_t h = hash_slot(c, hbits);
        while (true) {
          const unsigned long long prev = atomicCAS(&keys[h], 0ull, key);
          if (prev == 0ull) {
            ids[h] = atomicAdd(&s_rows, 1);
            break;
          }
          if (prev == key) break;
          h = (h + 1) & (hsize - 1);
        }
      }
    }
    __syncthreads();
    // int32 terms: row s_rows is the row of no query character
    const int used = kBytes ? 256 : s_rows + 1;
    const int absent = used - 1;
    // every row matches each query's padding rows
#pragma unroll 1
    for (int lane = 0; lane < kL; ++lane) {
      const uint32_t v = lane % NW == 0 ? s_pad[lane / NW] : 0u;
      for (int r = threadIdx.x; r < used; r += kThreads) eqs[lane * rows + r] = v;
    }
    __syncthreads();
    auto row_of = [&](uint32_t c) -> int {
      if constexpr (kBytes) return (int)c;
      const unsigned long long key = (1ull << 32) | c;
      uint32_t h = hash_slot(c, hbits);
      while (true) {
        const unsigned long long k = keys[h];
        if (k == key) return ids[h];
        if (k == 0ull) return absent;
        h = (h + 1) & (hsize - 1);
      }
    };
    // query position i sits at bit i + pad: its last one at bit 31 of the
    // top word
    for (int it = threadIdx.x; it < nq * qp; it += kThreads) {
      const int q = it / qp, i = it - q * qp;
      const int m = s_m[q];
      if (i >= m) continue;
      const int32_t c = qtok[(size_t)(b0 + q) * qp + i];
      if (kBytes && (c < 0 || c > 255)) continue;  // never equals a byte
      const int bit = i + ((32 - (m & 31)) & 31);
      atomicOr(&eqs[(q * NW + (bit >> 5)) * rows + row_of((uint32_t)c)], 1u << (bit & 31));
    }
    __syncthreads();

    int top[QC];
#pragma unroll
    for (int q = 0; q < QC; ++q) top[q] = (s_m[q] - 1) >> 5;

    for (int t = blockIdx.x * kThreads + threadIdx.x; t < n; t += gridDim.x * kThreads) {
      const int len_raw = lengths[t];
      uint32_t pv[QC][NW], mv[QC][NW];
      int score[QC], best[QC];
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        score[q] = best[q] = s_m[q];
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          pv[q][k] = k == 0 ? ~s_pad[q] : ~0u;  // D[i][0] = i above the padding
          mv[q][k] = 0u;
        }
      }
      const int len = min(len_raw, w);
      auto step = [&](int row) {
        const uint32_t* e = eqs + row;
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          if (q >= nq) break;
          uint32_t eq[NW];
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            if (NW > 1 && k > top[q]) break;
            eq[k] = e[(q * NW + k) * rows];
          }
          column<NW>(pv[q], mv[q], eq, top[q], score[q]);
          best[q] = min(best[q], score[q]);
        }
      };
      // word i of the row (4 characters of uint8, 1 of int32): 16-byte
      // loads where the row stride and the base allow, else 4-byte ones,
      // else (uint8 rows of an odd width) bytes
      const unsigned char* row = reinterpret_cast<const unsigned char*>(tokens) + (size_t)t * rb;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      auto word_at = [&](int i) -> uint32_t {
        if (vb == 16) {
          if ((i & 3) == 0) x = __ldg(reinterpret_cast<const uint4*>(row) + (i >> 2));
          const uint32_t v = x.x;
          x.x = x.y;
          x.y = x.z;
          x.z = x.w;
          return v;
        }
        if (!kBytes || vb == 4) return __ldg(reinterpret_cast<const uint32_t*>(row) + i);
        uint32_t v = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (4 * i + u < len) v |= (uint32_t)__ldg(row + 4 * i + u) << (8 * u);
        }
        return v;
      };
      uint32_t word = 0;
      for (int j = 0; j < len; ++j) {
        uint32_t c;
        if constexpr (kBytes) {
          if ((j & 3) == 0) word = word_at(j >> 2);
          c = word & 255u;
          word >>= 8;
        } else {
          c = word_at(j);
        }
        step(row_of(c));
      }
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        if (q >= nq) break;
        const int mraw = qlens[b0 + q];
        const int bq = s_m[q] == 0 ? 0 : best[q];
        out[(size_t)(b0 + q) * n + t] = len_raw < 0 ? mraw - kBig : mraw - bq;
      }
    }
  }
}

// Queries over 8 words: the vector in global scratch (word k of thread g at
// [k * nthreads + g], Pv then Mv), masks built from the query per word.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dp_match_words_kernel(const T* __restrict__ tokens, const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ qtok, const int32_t* __restrict__ qlens,
                      int32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                      int n, int w, int nb, int qp) {
  const size_t nthreads = (size_t)gridDim.x * kThreads;
  const size_t g = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t nwords = (size_t)(qp + 31) / 32;
  uint32_t* P = scratch + g;
  uint32_t* M = scratch + nwords * nthreads + g;
  for (size_t t = g; t < (size_t)n; t += nthreads) {
    const int len_raw = lengths[t];
    const int len = min(len_raw, w);
    const T* term = tokens + t * (size_t)w;
    for (int b = 0; b < nb; ++b) {
      const int mraw = qlens[b];
      const int m = clamp_len(mraw, qp);
      const int32_t* q = qtok + (size_t)b * qp;
      int best = m;
      if (len_raw >= 0 && m > 0) {
        const int top = (m - 1) >> 5;
        const uint32_t topbit = 1u << ((m - 1) & 31);
        for (int k = 0; k <= top; ++k) {
          P[k * nthreads] = ~0u;
          M[k * nthreads] = 0u;
        }
        int score = m;
        for (int j = 0; j < len; ++j) {
          const int32_t c = (int32_t)term[j];
          uint32_t hp = 0, hm = 0;
          for (int k = 0; k <= top; ++k) {
            uint32_t eq = 0;
            const int hi = min(m, 32 * k + 32);
            for (int i = 32 * k; i < hi; ++i) eq |= (uint32_t)(q[i] == c) << (i & 31);
            const uint32_t p = P[k * nthreads], nv = M[k * nthreads];
            const uint32_t xv = eq | nv;
            const uint32_t e = eq | hm;
            const uint32_t xh = (((e & p) + p) ^ p) | e;
            uint32_t ph = nv | ~(xh | p);
            uint32_t mh = p & xh;
            if (k == top) {
              score += (ph & topbit) ? 1 : 0;
              score -= (mh & topbit) ? 1 : 0;
            }
            const uint32_t hp_out = ph >> 31, hm_out = mh >> 31;
            ph = (ph << 1) | hp;
            mh = (mh << 1) | hm;
            P[k * nthreads] = mh | ~(xv | ph);
            M[k * nthreads] = ph & xv;
            hp = hp_out;
            hm = hm_out;
          }
          best = min(best, score);
        }
      }
      out[(size_t)b * n + t] = len_raw < 0 ? mraw - kBig : mraw - best;
    }
  }
}

// bytes of shared memory of the register kernel (see dp_match_kernel)
size_t smem_bytes(int nw, int qc, int qp, int token_bytes, int* hbits) {
  *hbits = 1;
  if (token_bytes == 1) return (size_t)256 * qc * nw * 4;
  while ((1 << *hbits) < 2 * qc * qp) ++*hbits;
  return (size_t)(qc * qp + 1) * qc * nw * 4 + (size_t)(1 << *hbits) * 12;
}

// One launch of the register kernel: as many blocks as the card keeps
// resident at once (blocks per SM for this instance and its shared memory x
// the SM count), spread over the query chunks first, each block walking
// its share of the term tiles.
template <typename T, int NW, int QC>
int launch_words(const T* tk, const int32_t* ln, const int32_t* qt, const int32_t* ql,
                 int32_t* o, int n, int w, int nb, int qp, int vb, cudaStream_t stream) {
  int hbits;
  const size_t smem = smem_bytes(NW, QC, qp, (int)sizeof(T), &hbits);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dp_match_kernel<T, NW, QC>,
                                                      kThreads, smem);
  }
  if (e != cudaSuccess) return (int)e;
  const int resident = max(1, per_sm) * max(1, sms);
  const int nchunks = (nb + QC - 1) / QC;
  const int gy = min(nchunks, 65535);
  const int tiles = (n + kThreads - 1) / kThreads;
  const int gx = max(1, min(tiles, (resident + gy - 1) / gy));
  dp_match_kernel<T, NW, QC><<<dim3((unsigned)gx, (unsigned)gy), kThreads, smem, stream>>>(
      tk, ln, qt, ql, o, n, w, nb, qp, hbits, vb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* tokens, const void* lengths, const void* qtok,
           const void* qlens, void* out, void* scratch, int n, int w, int nb,
           int qp, int nw, int qc, int scratch_threads, cudaStream_t stream) {
  const T* tk = static_cast<const T*>(tokens);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  const int32_t* qt = static_cast<const int32_t*>(qtok);
  const int32_t* ql = static_cast<const int32_t*>(qlens);
  int32_t* o = static_cast<int32_t*>(out);
  if (nw == 0) {
    if (scratch_threads <= 0 || scratch_threads % kThreads) {
      return (int)cudaErrorInvalidValue;
    }
    dp_match_words_kernel<T><<<scratch_threads / kThreads, kThreads, 0, stream>>>(
        tk, ln, qt, ql, o, static_cast<uint32_t*>(scratch), n, w, nb, qp);
    return (int)cudaGetLastError();
  }
  if (qp > 32 * nw) return (int)cudaErrorInvalidValue;
  // the widest loads that the row stride and the base address allow
  const size_t rb = (size_t)w * sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(tokens);
  const int vb = (rb % 16 == 0 && base % 16 == 0) ? 16
                 : (rb % 4 == 0 && base % 4 == 0) ? 4 : 1;
  if (sizeof(T) == 4 && vb == 1) return (int)cudaErrorInvalidValue;
  if (qc != 1 && qc * nw != kLanes) return (int)cudaErrorInvalidValue;
#define DP_CASE(NWV)                                                          \
  case NWV:                                                                   \
    return qc == 1 ? launch_words<T, NWV, 1>(tk, ln, qt, ql, o, n, w, nb, qp, vb, stream) \
                   : launch_words<T, NWV, kLanes / NWV>(tk, ln, qt, ql, o, n, w, nb, qp, \
                                                        vb, stream);
  switch (nw) {
    DP_CASE(1)
    DP_CASE(2)
    DP_CASE(4)
    DP_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DP_CASE
}

}  // namespace

// tokens (n, w) uint8 (token_bytes 1) or int32 (4), lengths (n,) int32,
// qtok (nb, qp) int32, qlens (nb,) int32, out (nb, n) int32.  nw in {1, 2,
// 4, 8} (>= ceil(qp / 32)) picks the register kernel, with chunks of qc
// queries (16 / nw, or 1); nw == 0 the scratch kernel with scratch_threads
// threads and scratch of 2 * ceil(qp / 32) * scratch_threads uint32 words.
extern "C" int dp_match_launch(const void* tokens, const void* lengths,
                               const void* qtok, const void* qlens, void* out,
                               void* scratch, int n, int w, int nb, int qp,
                               int token_bytes, int nw, int qc,
                               int scratch_threads, void* stream) {
  if (n <= 0 || nb <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (token_bytes == 1) {
    return launch<uint8_t>(tokens, lengths, qtok, qlens, out, scratch, n, w,
                           nb, qp, nw, qc, scratch_threads, st);
  }
  if (token_bytes == 4) {
    return launch<int32_t>(tokens, lengths, qtok, qlens, out, scratch, n, w,
                           nb, qp, nw, qc, scratch_threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
