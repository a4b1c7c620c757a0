// The K1 probes' pure streams P1-P3: a column max over a packed table.
//
// Replaces three Pallas kernels of the reference's tools/:
//
//   P1 tools/probe_bandwidth.py:87-101 pl_stream      row-major, no r
//   P2 tools/probe_layout_r5.py:127-149 stream_row    row-major, with r
//   P3 tools/probe_layout_r5.py:152-174 stream_tile   tile-major, with r
//
// Contract, for every layout tile j and byte k < 512 of it:
//
//   out[j * 512 + k] = max(max_g int32(int8 t[g, j, k]), r[k])   int32
//
// (max over signed bytes; r optional), where row g of tile j sits at
// j * tile_stride + g * row_stride bytes: (NB, 512) for a row-major (G, NB)
// table, whose output is (1, NB), and (512, G * 512) for a tile-major
// (ntiles, G, 512) one, whose output is (ntiles, 1, 512): both are the same
// ntiles * 512 int32 in memory.  pl_stream's `t ^ r` is an XLA pass outside
// its kernel, not part of it: P1 takes the table as it is.
//
// What bounds it on an H100: bytes, the whole table read once (3.5-3.7 GB
// at the probes' shapes, >= 1.05 ms at 3.35 TB/s) and ntiles * 2 KB
// written.  Design: one block of 16 warps per layout tile; each lane owns
// 16 bytes of the tile's 512-byte row slice and keeps four 16-byte loads in
// flight (rows w, w + 16, w + 32, w + 48 for warp w), folding them with a
// signed byte-wise max (__vmaxs4); the 16 warps' partial maxima meet in
// shared memory, where 128 threads each widen 4 columns to int32, take r
// and store 16 bytes.
//
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlkb = 512;
constexpr int kStreamWarps = 16;
constexpr uint32_t kMinBytes = 0x80808080u;  // four int8 -128

__global__ void __launch_bounds__(kStreamWarps * 32)
probe_stream_kernel(const uint8_t* __restrict__ t,
                    const int32_t* __restrict__ r, int32_t* __restrict__ out,
                    int g, size_t row_stride, size_t tile_stride) {
  __shared__ uint32_t part[kStreamWarps][kBlkb / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint8_t* base = t + (size_t)blockIdx.x * tile_stride + (size_t)lane * 16;
  uint32_t m[4] = {kMinBytes, kMinBytes, kMinBytes, kMinBytes};
  int row = warp;
  for (; row + 3 * kStreamWarps < g; row += 4 * kStreamWarps) {
    uint4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = __ldcs(reinterpret_cast<const uint4*>(
          base + (size_t)(row + u * kStreamWarps) * row_stride));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      m[0] = __vmaxs4(m[0], x[u].x);
      m[1] = __vmaxs4(m[1], x[u].y);
      m[2] = __vmaxs4(m[2], x[u].z);
      m[3] = __vmaxs4(m[3], x[u].w);
    }
  }
  for (; row < g; row += kStreamWarps) {
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(base + (size_t)row * row_stride));
    m[0] = __vmaxs4(m[0], x.x);
    m[1] = __vmaxs4(m[1], x.y);
    m[2] = __vmaxs4(m[2], x.z);
    m[3] = __vmaxs4(m[3], x.w);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) part[warp][lane * 4 + i] = m[i];
  __syncthreads();
  const int c = threadIdx.x;  // columns 4c .. 4c + 3
  if (c < kBlkb / 4) {
    uint32_t x = kMinBytes;
#pragma unroll
    for (int w = 0; w < kStreamWarps; ++w) x = __vmaxs4(x, part[w][c]);
    int4 o = make_int4((int8_t)(x & 0xffu), (int8_t)((x >> 8) & 0xffu),
                       (int8_t)((x >> 16) & 0xffu), (int8_t)(x >> 24));
    if (r != nullptr) {
      const int4 rv = __ldg(reinterpret_cast<const int4*>(r) + c);
      o = make_int4(max(o.x, rv.x), max(o.y, rv.y), max(o.z, rv.z), max(o.w, rv.w));
    }
    __stcs(reinterpret_cast<int4*>(out + (size_t)blockIdx.x * kBlkb) + c, o);
  }
}

}  // namespace

// t: the table (g rows of every tile); r: 512 int32 or null; out: ntiles *
// 512 int32.
extern "C" int probe_stream_launch(const void* t, const void* r, void* out,
                                   int g, int ntiles, long long row_stride,
                                   long long tile_stride, void* stream) {
  if (g <= 0 || ntiles <= 0) return (int)cudaErrorInvalidValue;
  probe_stream_kernel<<<ntiles, kStreamWarps * 32, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(t), static_cast<const int32_t*>(r),
      static_cast<int32_t*>(out), g, (size_t)row_stride, (size_t)tile_stride);
  return (int)cudaGetLastError();
}
