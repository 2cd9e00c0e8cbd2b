// A stable counting sort of each index row over the whole card, and the
// ordered sum over its segments: the scatter-add
//   out[b, n, :] = sum over j with idx[b, j] == n of g[b, j, :]
// summed in ascending j from +0.0f, rows that no j references 0, with no
// float atomics. scatter_smem.cu's sort route and scatter_add.cu's sort
// route both run it through csr_scatter_add() below.
//
// Bound on the card: bytes of g (each word read once) and of out (written
// once). Each index row is sorted once, in parallel over the card, and
// then summed output-stationary with the accumulator in registers:
//   1. tile_count_kernel, one block per (tile of `tile` indices, batch row):
//      the tile's key counts, in 16-bit halves of shared-memory words
//      (integer atomics: order-free), written out as counts (B, tiles, N).
//   2. tile_prefix_kernel, a thread per (batch row, key): the exclusive
//      prefix of the key's counts over the tiles (in place) and its total;
//      row_scan_kernel, one block per batch row: the exclusive prefix of
//      the keys' totals, offsets (B, N + 1).
//   3. place_kernel, one block per tile: the tile's keys are staged in
//      shared memory and `walkers` warps each walk a stretch of them in
//      ascending j, 32 at a time, ranking equal keys by shuffles (the
//      lower lanes with the same key; __match_any_sync costs more here)
//      against the walker's own per-key running counts in shared memory;
//      then every thread writes its j's to order[offsets[key] +
//      counts[tile][key] + the key's count in the earlier stretches +
//      rank]. So order (B, J) lists each key's j in ascending order, a
//      stable counting sort.
//   4. segment_sum_kernel, one warp per (batch row, group of `rows`
//      consecutive output rows, 32-channel chunk): the group's entries are
//      one contiguous run of order, which the warp walks kBatch at a time:
//      it loads the kBatch j's (the next kBatch in flight meanwhile), then
//      each lane loads its channel of all kBatch g rows before it adds them
//      in order, storing each finished output row once, coalesced (rows no
//      entry names are written 0 first). A lane adds into one register in
//      program order, so every sum is in ascending j. The sum is bound by
//      the latency of those scattered row loads: 16 a batch leave registers
//      for more resident warps than 32 or 64 (both measured slower at every
//      shape), and a short group per warp keeps the warps of a run read by
//      several chunk warps from queueing behind each other. Channel
//      chunks of a row run in warps of their own, so a skewed row (one
//      source row can collect hundreds of references) holds up only its
//      own warps.
#pragma once

#include <cuda_runtime.h>

#include "smem_limit.cuh"

namespace {

constexpr int kCountThreads = 256;
constexpr int kScanThreads = 1024;  // 32 full warps: the scan below needs it
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kPrefixThreads = 256;
constexpr int kPrefixBatch = 8;
constexpr int kPlaceThreads = 256;
constexpr int kMaxWalkers = kPlaceThreads / 32;
constexpr int kPlace = 4;  // entries a thread places at once
constexpr int kSumThreads = 256;
constexpr int kMaxRows = 31;  // a group's offsets fit one warp
constexpr int kBatch = 16;  // entries whose g rows a sum warp loads together
constexpr int kMaxTile = 8192;  // local ranks and keys share a 32-bit word
constexpr int kMaxN = 65535;    // keys fit 16 bits

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// 16-bit counter of key in a shared array of packed pairs
__device__ __forceinline__ unsigned half_shift(int key) { return (key & 1) * 16u; }

__global__ void __launch_bounds__(kCountThreads)
    tile_count_kernel(const int* __restrict__ idx, int N, int J, int tile,
                      int tiles, int* __restrict__ counts) {
  extern __shared__ unsigned packed[];  // ceil(N / 2) words
  const int t = blockIdx.x;
  const long long b = blockIdx.y;
  const int words = (N + 1) / 2;
  for (int w = threadIdx.x; w < words; w += kCountThreads) packed[w] = 0u;
  __syncthreads();
  const int* ib = idx + b * J;
  const int j1 = min(J, (t + 1) * tile);
  for (int j = t * tile + threadIdx.x; j < j1; j += kCountThreads) {
    const int key = ib[j];
    atomicAdd(&packed[key >> 1], 1u << half_shift(key));
  }
  __syncthreads();
  int* cb = counts + (b * tiles + t) * N;
  for (int n = threadIdx.x; n < N; n += kCountThreads) {
    cb[n] = static_cast<int>((packed[n >> 1] >> half_shift(n)) & 0xffffu);
  }
}

// per key: the exclusive prefix of its counts over the tiles, in place, and
// its total in offsets[b][n]
__global__ void __launch_bounds__(kPrefixThreads)
    tile_prefix_kernel(int N, int tiles, int* __restrict__ counts,
                       int* __restrict__ offsets) {
  const int n = blockIdx.x * kPrefixThreads + threadIdx.x;
  if (n >= N) return;
  const long long b = blockIdx.y;
  int* cb = counts + b * tiles * N + n;
  int s = 0;
  for (int t0 = 0; t0 < tiles; t0 += kPrefixBatch) {  // kPrefixBatch loads in flight
    int c[kPrefixBatch];
#pragma unroll
    for (int u = 0; u < kPrefixBatch; ++u) {
      c[u] = t0 + u < tiles ? cb[static_cast<long long>(t0 + u) * N] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPrefixBatch; ++u) {
      if (t0 + u < tiles) {
        cb[static_cast<long long>(t0 + u) * N] = s;
        s += c[u];
      }
    }
  }
  offsets[b * (N + 1) + n] = s;
}

// offsets[b]: the keys' totals -> their exclusive prefix, and J at N. Warp
// w owns a contiguous stretch of 32 * per keys and reads it 32 at a time,
// coalesced.
__global__ void __launch_bounds__(kScanThreads)
    row_scan_kernel(int N, int J, int* __restrict__ offsets) {
  __shared__ int warp_base[kScanWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* off = offsets + static_cast<long long>(blockIdx.x) * (N + 1);
  const int per = (N + kScanThreads - 1) / kScanThreads;
  const int first = warp * 32 * per;
  int total = 0;
#pragma unroll 8
  for (int k = 0; k < per; ++k) {
    const int n = first + k * 32 + lane;
    total += n < N ? off[n] : 0;
  }
  total = warp_inclusive_scan(total, lane);
  if (lane == 31) warp_base[warp] = total;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_base[lane];
    warp_base[lane] = warp_inclusive_scan(t, lane) - t;
  }
  __syncthreads();
  int carry = warp_base[warp];
  for (int k = 0; k < per; ++k) {
    const int n = first + k * 32 + lane;
    const int c = n < N ? off[n] : 0;
    const int incl = warp_inclusive_scan(c, lane);
    if (n < N) off[n] = carry + incl - c;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (threadIdx.x == 0) off[N] = J;
}

__global__ void __launch_bounds__(kPlaceThreads)
    place_kernel(const int* __restrict__ idx, int N, int J, int tile, int tiles, int walkers,
                 const int* __restrict__ counts, const int* __restrict__ offsets,
                 int* __restrict__ order) {
  extern __shared__ unsigned smem[];
  unsigned* entry = smem;  // tile words: key, then key | rank in its stretch << 16
  const int words = (N + 1) / 2;
  unsigned* packed = smem + tile;  // walkers x words: each walker's 16-bit cursors
  const int t = blockIdx.x;
  const long long b = blockIdx.y;
  const int j0 = t * tile;
  const int len = min(tile, J - j0);
  const int stretch = tile / walkers;
  const int* ib = idx + b * J;
  for (int e = threadIdx.x; e < len; e += kPlaceThreads) entry[e] = static_cast<unsigned>(ib[j0 + e]);
  for (int w = threadIdx.x; w < walkers * words; w += kPlaceThreads) packed[w] = 0u;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp < walkers) {  // warp w ranks its stretch of the tile in ascending j
    const int lane = threadIdx.x & 31;
    unsigned* cursor = packed + warp * words;
    const int end = min(len, (warp + 1) * stretch);
    for (int e0 = warp * stretch; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      const bool live = e < end;
      const int key = live ? static_cast<int>(entry[e]) : -1;  // dead lanes group apart
      unsigned below = 0, peers = 0;  // lanes with this key: lower ones, all
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        const bool same = __shfl_sync(0xffffffffu, key, d) == key;
        below += same && d < lane;
        peers += same;
      }
      unsigned rank = 0;
      if (live) rank = ((cursor[key >> 1] >> half_shift(key)) & 0xffffu) + below;
      __syncwarp();  // every lane has read its cursor before the last peer moves it
      if (live && below + 1 == peers) atomicAdd(&cursor[key >> 1], peers << half_shift(key));
      __syncwarp();
      if (live) entry[e] = static_cast<unsigned>(key) | (rank << 16);
    }
  }
  __syncthreads();

  const int* cb = counts + (b * tiles + t) * N;
  const int* off = offsets + b * (N + 1);
  int* ob = order + b * J;
  for (int e0 = threadIdx.x; e0 < len; e0 += kPlace * kPlaceThreads) {
    int key[kPlace], rank[kPlace], base[kPlace];
#pragma unroll
    for (int u = 0; u < kPlace; ++u) {  // kPlace entries' lookups in flight
      const int e = e0 + u * kPlaceThreads;
      base[u] = 0;
      if (e < len) {
        const unsigned w = entry[e];
        key[u] = static_cast<int>(w & 0xffffu);
        rank[u] = static_cast<int>(w >> 16);
        for (int q = 0; q < e / stretch; ++q) {  // the key's count in the earlier stretches
          rank[u] += static_cast<int>((packed[q * words + (key[u] >> 1)] >> half_shift(key[u])) & 0xffffu);
        }
        base[u] = off[key[u]] + cb[key[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kPlace; ++u) {
      const int e = e0 + u * kPlaceThreads;
      if (e < len) ob[base[u] + rank[u]] = j0 + e;
    }
  }
}

__global__ void __launch_bounds__(kSumThreads)
    segment_sum_kernel(const float* __restrict__ g,
                       const int* __restrict__ offsets,
                       const int* __restrict__ order, int N, int J, int C,
                       int rows, int groups, int chunks, long long warps,
                       float* __restrict__ out) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) >> 5;
  if (w >= warps) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int chunk = static_cast<int>(w % chunks);
  const long long rest = w / chunks;
  const int group = static_cast<int>(rest % groups);
  const long long b = rest / groups;
  const int n0 = group * rows;
  const int nr = min(rows, N - n0);
  const int c = chunk * 32 + lane;
  const bool live = c < C;

  // lane r holds the start of the group's row r (lane nr: the group's end)
  const int bound = lane <= nr ? offsets[b * (N + 1) + n0 + lane] : 0;
  const int start = __shfl_sync(0xffffffffu, bound, 0);
  const int end = __shfl_sync(0xffffffffu, bound, nr);
  const int* ord = order + b * J;
  const float* gb = g + b * J * C + (live ? c : 0);
  float* ob = out + (b * N + n0) * C + c;

  // rows no entry names are 0
  const int next = __shfl_down_sync(0xffffffffu, bound, 1);
  for (unsigned empty = __ballot_sync(0xffffffffu, lane < nr && next == bound); empty;
       empty &= empty - 1) {
    if (live) ob[static_cast<long long>(__ffs(empty) - 1) * C] = 0.0f;
  }

  int r = -1;  // the row being summed; warp-uniform
  float acc = 0.0f;
  int mine = lane < kBatch && start + lane < end ? ord[start + lane] : 0;  // lane u: entry k0 + u
  for (int k0 = start; k0 < end; k0 += kBatch) {  // warp-uniform bounds
    const int cnt = min(kBatch, end - k0);
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long j = __shfl_sync(0xffffffffu, mine, u);
      v[u] = (live && u < cnt) ? gb[j * C] : 0.0f;
    }
    const int e = k0 + lane;
    mine = lane < kBatch && e + kBatch < end ? ord[e + kBatch] : 0;  // the next batch, in flight
    int row = 0;  // the row of entry k0 + lane
    for (int q = 1; q < nr; ++q) row += __shfl_sync(0xffffffffu, bound, q) <= e;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int ru = __shfl_sync(0xffffffffu, row, u);
      if (u < cnt) {
        if (ru != r) {  // entry u starts row ru: row r is done
          if (live && r >= 0) ob[static_cast<long long>(r) * C] = acc;
          acc = 0.0f;
          r = ru;
        }
        acc = __fadd_rn(acc, v[u]);
      }
    }
  }
  if (live && r >= 0) ob[static_cast<long long>(r) * C] = acc;
}

// idx (B, J) int32 in [0, N), trusted; g (B, J, C) float32; out (B, N, C)
// float32, every word written. tile: the indices a sort block takes (a
// multiple of 32 * walkers, at most 8192); walkers: the warps that rank a
// tile (1 to 8); rows: the output rows a sum warp takes (1 to 31); all from
// scatter_smem_kernel.sort_plan(). scratch: int32 words for
// counts (B, ceil(J / tile), N), offsets (B, N + 1) and order (B, J), in
// that order, which the caller allocates.
inline int csr_scatter_add(const int* idx, const float* g, int B, int N, int J, int C, int tile,
                           int walkers, int rows, int* scratch, float* out, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (J < 0 || N > kMaxN || B > 65535 || tile > kMaxTile || walkers < 1 ||
      walkers > kMaxWalkers || tile < 32 * walkers || tile % (32 * walkers) != 0 ||
      rows < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (J + tile - 1) / tile;
  int* counts = scratch;
  int* offsets = counts + static_cast<long long>(B) * tiles * N;
  int* order = offsets + static_cast<long long>(B) * (N + 1);
  const size_t packed = static_cast<size_t>((N + 1) / 2) * sizeof(unsigned);
  cudaError_t err;
  if (tiles > 0) {
    static int count_allowed[kP2MaxDevices] = {};
    err = p2_allow_smem(tile_count_kernel, packed, count_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_count_kernel<<<dim3(tiles, B), kCountThreads, packed, s>>>(idx, N, J, tile, tiles, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_prefix_kernel<<<dim3((N + kPrefixThreads - 1) / kPrefixThreads, B), kPrefixThreads, 0, s>>>(
      N, tiles, counts, offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_scan_kernel<<<B, kScanThreads, 0, s>>>(N, J, offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0) {
    const size_t smem = static_cast<size_t>(tile) * sizeof(unsigned) + walkers * packed;
    static int place_allowed[kP2MaxDevices] = {};
    err = p2_allow_smem(place_kernel, smem, place_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    place_kernel<<<dim3(tiles, B), kPlaceThreads, smem, s>>>(idx, N, J, tile, tiles, walkers,
                                                            counts, offsets, order);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = (N + rows - 1) / rows;
  const int chunks = (C + 31) / 32;
  const long long warps = static_cast<long long>(B) * groups * chunks;
  const long long blocks = (warps * 32 + kSumThreads - 1) / kSumThreads;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      g, offsets, order, N, J, C, rows, groups, chunks, warps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
