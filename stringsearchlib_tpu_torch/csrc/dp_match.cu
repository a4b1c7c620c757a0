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
// What bounds it on an H100: scalar integer work.  A call computes, for
// every (query, term) pair, qlen x len DP cells of ~5 32-bit operations;
// the bytes (each term's own characters, the lengths, the (B, N) int32
// output) are small beside that once B > 1, and at B = 1 over a 2M-term
// long tier the output write comes first.  So:
//
//   * one thread per (query, term) pair, Sellers' DP with the state along
//     the shorter static bound: along the query (a column of qlen + 1 cells,
//     walking the term's own len characters) when Qp <= W, else along the
//     term (a row of len + 1 cells, walking the query's qlen characters);
//   * the state bound S (8, 16, 32 or 64) is a template parameter, so the
//     loop over the state unrolls, the state and the other string's
//     characters stay in registers, and the loop still stops at the real
//     length, not at S;
//   * the block's query is staged once in shared memory;
//   * above 64 on both sides (a query over 64 characters against terms
//     wider than 64) the column lives in a global scratch buffer, cell-major
//     so that neighbouring threads touch neighbouring words, and a bounded
//     grid walks the terms.
//
// Exact for every qlen in [0, Qp] and every width W: integer arithmetic on
// the whole string.  The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBig = 1 << 30;
constexpr int kSmemMax = 48 * 1024;

// state along the query: col[i] = D[i][j] after j term characters;
// returns min over j <= len of D[m][j]
template <int S, typename T>
__device__ __forceinline__ int dp_query_state(const int* q, int m,
                                              const T* __restrict__ term,
                                              int len) {
  int qc[S];
  int col[S + 1];
#pragma unroll
  for (int i = 0; i < S; ++i) qc[i] = i < m ? q[i] : 0;
#pragma unroll
  for (int i = 0; i <= S; ++i) col[i] = i;
  int best = m;
  for (int j = 0; j < len; ++j) {
    const int c = (int)term[j];
    int diag = 0;  // D[0][j]; D[0][j + 1] = 0 stays in col[0]
#pragma unroll
    for (int i = 1; i <= S; ++i) {
      if (i > m) break;
      const int up = col[i];
      const int v = min(min(up, col[i - 1]) + 1, diag + (qc[i - 1] != c ? 1 : 0));
      diag = up;
      col[i] = v;
      if (i == m) best = min(best, v);
    }
  }
  return best;
}

// state along the term: row[p] = D[k][p] after k query characters;
// returns min over p <= len of D[m][p]
template <int S, typename T>
__device__ __forceinline__ int dp_term_state(const int* q, int m,
                                             const T* __restrict__ term,
                                             int len) {
  int tc[S];
  int row[S + 1];
#pragma unroll
  for (int p = 0; p < S; ++p) tc[p] = p < len ? (int)term[p] : 0;
#pragma unroll
  for (int p = 0; p <= S; ++p) row[p] = 0;
  for (int k = 0; k < m; ++k) {
    const int c = q[k];
    int diag = row[0];  // D[k][0]
    row[0] = k + 1;
#pragma unroll
    for (int p = 1; p <= S; ++p) {
      if (p > len) break;
      const int up = row[p];
      const int v = min(min(up, row[p - 1]) + 1, diag + (tc[p - 1] != c ? 1 : 0));
      diag = up;
      row[p] = v;
    }
  }
  int best = row[0];
#pragma unroll
  for (int p = 1; p <= S; ++p) {
    if (p <= len) best = min(best, row[p]);
  }
  return best;
}

// state along the query in global scratch (cell i at col[i * stride])
template <typename T>
__device__ int dp_query_mem(const int* q, int m, const T* __restrict__ term,
                            int len, int32_t* col, size_t stride) {
  for (int i = 0; i <= m; ++i) col[(size_t)i * stride] = i;
  int best = m;
  for (int j = 0; j < len; ++j) {
    const int c = (int)term[j];
    int diag = 0, left = 0;
    for (int i = 1; i <= m; ++i) {
      const int up = col[(size_t)i * stride];
      const int v = min(min(up, left) + 1, diag + (q[i - 1] != c ? 1 : 0));
      diag = up;
      left = v;
      col[(size_t)i * stride] = v;
    }
    best = min(best, left);
  }
  return best;
}

// S == 0: the scratch form (grid-stride over terms, gridDim.y == 1)
template <int S, bool kQueryState, typename T>
__global__ void __launch_bounds__(kThreads)
dp_match_kernel(const T* __restrict__ tokens, const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ qtok, const int32_t* __restrict__ qlens,
                int32_t* __restrict__ out, int32_t* __restrict__ scratch, int n,
                int w, int nb, int qp, int use_smem) {
  extern __shared__ int qs[];
  const int t0 = blockIdx.x * kThreads + threadIdx.x;
  const int step = (S == 0) ? gridDim.x * kThreads : n;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const int* q = qtok + (size_t)b * qp;
    if (use_smem) {
      __syncthreads();
      for (int i = threadIdx.x; i < qp; i += kThreads) qs[i] = q[i];
      __syncthreads();
      q = qs;
    }
    const int m_raw = qlens[b];
    const int m = min(max(m_raw, 0), qp);
    for (int t = t0; t < n; t += step) {
      const int len_raw = lengths[t];
      int r;
      if (len_raw < 0) {
        r = m_raw - kBig;  // no position p <= len exists
      } else {
        const int len = min(len_raw, w);
        const T* term = tokens + (size_t)t * (size_t)w;
        int best;
        if constexpr (S == 0) {
          best = dp_query_mem(q, m, term, len, scratch + t0,
                              (size_t)gridDim.x * kThreads);
        } else if constexpr (kQueryState) {
          best = dp_query_state<S>(q, m, term, len);
        } else {
          best = dp_term_state<S>(q, m, term, len);
        }
        r = m_raw - best;
      }
      out[(size_t)b * n + t] = r;
    }
  }
}

template <typename T>
int launch(const void* tokens, const void* lengths, const void* qtok,
           const void* qlens, void* out, void* scratch, int n, int w, int nb,
           int qp, int state_on_query, int s, int scratch_threads,
           cudaStream_t stream) {
  size_t smem = (size_t)qp * sizeof(int);
  int use_smem = 1;
  if (smem > (size_t)kSmemMax || qp == 0) {
    smem = 0;
    use_smem = 0;
  }
  const T* tk = static_cast<const T*>(tokens);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  const int32_t* qt = static_cast<const int32_t*>(qtok);
  const int32_t* ql = static_cast<const int32_t*>(qlens);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* sc = static_cast<int32_t*>(scratch);
  if (s == 0) {
    if (scratch_threads <= 0 || scratch_threads % kThreads) {
      return (int)cudaErrorInvalidValue;
    }
    dp_match_kernel<0, true, T><<<dim3(scratch_threads / kThreads, 1), kThreads,
                                  smem, stream>>>(tk, ln, qt, ql, o, sc, n, w,
                                                  nb, qp, use_smem);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads),
                  (unsigned)(nb < 65535 ? nb : 65535));
#define DP_CASE(SV)                                                          \
  case SV:                                                                   \
    if (state_on_query) {                                                    \
      dp_match_kernel<SV, true, T><<<grid, kThreads, smem, stream>>>(        \
          tk, ln, qt, ql, o, sc, n, w, nb, qp, use_smem);                    \
    } else {                                                                 \
      dp_match_kernel<SV, false, T><<<grid, kThreads, smem, stream>>>(       \
          tk, ln, qt, ql, o, sc, n, w, nb, qp, use_smem);                    \
    }                                                                        \
    break;
  switch (s) {
    DP_CASE(8)
    DP_CASE(16)
    DP_CASE(32)
    DP_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DP_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// tokens (n, w) uint8 (token_bytes 1) or int32 (4), lengths (n,) int32,
// qtok (nb, qp) int32, qlens (nb,) int32, out (nb, n) int32.  s in {8, 16,
// 32, 64} bounds the state (qp when state_on_query, else w); s == 0 takes
// the scratch form with scratch_threads threads and scratch of
// scratch_threads * (qp + 1) int32.
extern "C" int dp_match_launch(const void* tokens, const void* lengths,
                               const void* qtok, const void* qlens, void* out,
                               void* scratch, int n, int w, int nb, int qp,
                               int token_bytes, int state_on_query, int s,
                               int scratch_threads, void* stream) {
  if (n <= 0 || nb <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (token_bytes == 1) {
    return launch<uint8_t>(tokens, lengths, qtok, qlens, out, scratch, n, w,
                           nb, qp, state_on_query, s, scratch_threads, st);
  }
  if (token_bytes == 4) {
    return launch<int32_t>(tokens, lengths, qtok, qlens, out, scratch, n, w,
                           nb, qp, state_on_query, s, scratch_threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
