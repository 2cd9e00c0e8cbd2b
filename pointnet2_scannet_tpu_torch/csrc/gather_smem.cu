// Row gather through shared-memory tiles: out[b, j, :] = src[b, idx[b, j], :].
//
// Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
// (_mxu_gather_fwd_only, the forward of mxu_gather, and
// _mxu_gather_split_fwd_only, the forward of mxu_gather_split). Both TPU
// kernels hold a batch row's whole (N, C) source in VMEM and build each
// 128-row output tile as a one-hot matrix product on the MXU, at f32
// HIGHEST precision or as three exact bf16 planes, because the TPU has no
// general gather. On this card a one-hot product would spend N
// multiply-adds on every word a gather only moves, so this kernel copies.
// Words move as raw 32 bits, so float32 and int32 are bit-exact, -0.0, inf
// and NaN included. (The TPU's product turns -0.0 into +0.0 and spreads a
// non-finite source value as NaN into the other rows of its tile; the port
// follows the gather.)
//
// Bound on the card: bytes, the output's above all (B x J x C words against
// the source's B x N x C). The design is output-tile-stationary: a tile is
// `rows` consecutive rows of the flat (B * J, C) output (or, for a row wider
// than a tile, one row's `width`-word chunk), so its words are one
// contiguous stretch of the output. A block reads the tile's indices once,
// coalesced, copies the source rows they name into a shared-memory tile
// with cp.async (16-byte copies where C % 4 == 0 and the source is aligned,
// else 4-byte copies; several rows a warp pass for narrow rows), and writes
// the tile with 16-byte streaming stores. The tile is double-buffered: one
// tile's stores overlap the next one's loads, and the indices run a tile
// further ahead. The source stays in L2, not in shared memory: a
// persistent grid of a few blocks per SM walks the tiles in order, so the
// blocks running together work on the same batch row or two (a batch row's
// source is at most a few MB at the port's shapes, L2 50 MB), and the
// streaming stores keep the output from evicting it.
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmemBytes = 227 * 1024;

// cp.async: 4-byte copies (cached in L1) and 16-byte ones (L2 only), commit
// groups, and a wait for every committed group
template <int VEC>
__device__ __forceinline__ void p2_cp_async(void* smem_dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void p2_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void p2_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int tile_stride(int rows, int width) {
  return (rows * width + 3) & ~3;
}

struct Tile {
  long long r0;  // first flat output row (b * J + j)
  int nr;        // rows
  int c0;        // first channel
  int w;         // channels
};

struct Shape {
  int N, J, C, rows, width, chunks;
  long long total_rows;
  __device__ __forceinline__ Tile tile(long long t) const {
    const long long rt = chunks == 1 ? t : t / chunks;
    const int ch = static_cast<int>(t - rt * chunks);
    Tile x;
    x.r0 = rt * rows;
    x.nr = static_cast<int>(min(static_cast<long long>(rows), total_rows - x.r0));
    x.c0 = ch * width;
    x.w = min(width, C - x.c0);
    return x;
  }
};

__device__ __forceinline__ void issue_indices(const Shape& s, long long t, const int* idx, int* sidx) {
  const Tile x = s.tile(t);
  for (int rr = threadIdx.x; rr < x.nr; rr += kThreads) {
    p2_cp_async<1>(reinterpret_cast<unsigned*>(sidx + rr), reinterpret_cast<const unsigned*>(idx + x.r0 + rr));
  }
}

// the tile's source rows into buf, laid out as the output stretch
template <int VEC>
__device__ __forceinline__ void issue_rows(const Shape& s, long long t, const unsigned* src,
                                           const int* sidx, unsigned* buf) {
  const Tile x = s.tile(t);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int units = x.w / VEC;
  const long long b0 = x.r0 / s.J;  // one 64-bit division a tile, 32-bit ones past a batch row
  const int j0 = static_cast<int>(x.r0 - b0 * s.J);
  auto row_src = [&](int rr) {
    int j = j0 + rr;
    long long b = b0;
    if (j >= s.J) {
      const int q = j / s.J;
      b += q;
      j -= q * s.J;
    }
    return src + (b * s.N + sidx[rr]) * s.C + x.c0;
  };
  if (units < 32) {  // several rows a warp pass: lane = slot * units + u
    const int per = 32 / units;
    const int slot = lane / units;
    const int u = lane - slot * units;
    if (slot >= per) return;
    for (int rr = warp * per + slot; rr < x.nr; rr += kWarps * per) {
      p2_cp_async<VEC>(buf + rr * x.w + u * VEC, row_src(rr) + u * VEC);
    }
  } else {
    for (int rr = warp; rr < x.nr; rr += kWarps) {
      const unsigned* from = row_src(rr);
      for (int u = lane; u < units; u += 32) p2_cp_async<VEC>(buf + rr * x.w + u * VEC, from + u * VEC);
    }
  }
}

// the tile's contiguous output stretch from buf: 16-byte streaming stores
// between a scalar head and tail
__device__ __forceinline__ void store_tile(const Shape& s, long long t, const unsigned* buf,
                                           unsigned* out) {
  const Tile x = s.tile(t);
  unsigned* dst = out + x.r0 * s.C + x.c0;
  const int len = x.nr * x.w;
  const int head = min(len, static_cast<int>(((16 - (reinterpret_cast<std::uintptr_t>(dst) & 15)) & 15) >> 2));
  const int nvec = (len - head) >> 2;
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  if (head == 0) {
    const uint4* vsrc = reinterpret_cast<const uint4*>(buf);
    for (int v = threadIdx.x; v < nvec; v += kThreads) __stcs(vdst + v, vsrc[v]);
  } else {
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const unsigned* p = buf + head + 4 * v;
      __stcs(vdst + v, make_uint4(p[0], p[1], p[2], p[3]));
    }
  }
  for (int q = threadIdx.x; q < head; q += kThreads) __stcs(dst + q, buf[q]);
  for (int q = head + 4 * nvec + threadIdx.x; q < len; q += kThreads) __stcs(dst + q, buf[q]);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    gather_smem_kernel(const unsigned* __restrict__ src, const int* __restrict__ idx, Shape s,
                       long long tiles, unsigned* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  const int stride = tile_stride(s.rows, s.width);  // 16-byte aligned buffers
  unsigned* buf[2] = {smem, smem + stride};
  int* sidx[2] = {reinterpret_cast<int*>(smem + 2 * stride),
                  reinterpret_cast<int*>(smem + 2 * stride) + s.rows};
  const long long step = gridDim.x;
  long long t = blockIdx.x;
  if (t >= tiles) return;

  issue_indices(s, t, idx, sidx[0]);
  p2_cp_async_commit();
  p2_cp_async_wait_all();
  __syncthreads();
  issue_rows<VEC>(s, t, src, sidx[0], buf[0]);
  if (t + step < tiles) issue_indices(s, t + step, idx, sidx[1]);
  p2_cp_async_commit();
  // tile k: rows in buf[k & 1], its indices were in sidx[k & 1]; tile k + 1's
  // indices in sidx[(k + 1) & 1]
  for (int k = 0; t < tiles; ++k, t += step) {
    const int cur = k & 1;
    p2_cp_async_wait_all();
    __syncthreads();  // tile k and the next indices landed; buf[cur ^ 1] and sidx[cur] are free
    if (t + step < tiles) issue_rows<VEC>(s, t + step, src, sidx[cur ^ 1], buf[cur ^ 1]);
    if (t + 2 * step < tiles) issue_indices(s, t + 2 * step, idx, sidx[cur]);
    p2_cp_async_commit();
    store_tile(s, t, buf[cur], out);
  }
}

}  // namespace

// src (B, N, C) and out (B, J, C) are 4-byte words (float32 or int32); idx
// (B, J) int32 indices that the caller guarantees lie in [0, N). rows,
// width and blocks come from gather_smem_kernel.plan(): a tile is rows
// whole output rows (width == C), or one row's width-word chunk (rows ==
// 1); blocks is the persistent grid. Shared memory: two tiles and two
// index stretches, 8 * (rows * width + rows) bytes and up to 24 of padding.
extern "C" int p2_gather_smem(const void* src, const int* idx, int B, int N,
                              int J, int C, int rows, int width, int blocks,
                              void* out, void* stream) {
  if (B <= 0 || J <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || rows < 1 || width < 1 || blocks < 1 || (rows > 1 && width != C) ||
      (width < C && width % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(rows) * width > kMaxSmemBytes / 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * (2 * static_cast<size_t>(tile_stride(rows, width)) + 2 * rows);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.N = N;
  s.J = J;
  s.C = C;
  s.rows = rows;
  s.width = width;
  s.chunks = (C + width - 1) / width;
  s.total_rows = static_cast<long long>(B) * J;
  const long long tiles = (s.total_rows + rows - 1) / rows * s.chunks;
  const unsigned grid = static_cast<unsigned>(blocks < tiles ? blocks : tiles);
  const bool vec = C % 4 == 0 && reinterpret_cast<std::uintptr_t>(src) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec) {
    static int allowed[kP2MaxDevices] = {};
    err = p2_allow_smem(gather_smem_kernel<4>, smem, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_smem_kernel<4><<<grid, kThreads, smem, st>>>(
        static_cast<const unsigned*>(src), idx, s, tiles, static_cast<unsigned*>(out));
  } else {
    static int allowed[kP2MaxDevices] = {};
    err = p2_allow_smem(gather_smem_kernel<1>, smem, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_smem_kernel<1><<<grid, kThreads, smem, st>>>(
        static_cast<const unsigned*>(src), idx, s, tiles, static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
