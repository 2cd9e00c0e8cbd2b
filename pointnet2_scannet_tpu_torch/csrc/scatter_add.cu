// Deterministic scatter-add, the backward of the row gather:
//   out[b, n, :] = sum over j with idx[b, j] == n of g[b, j, :]
// summed in ascending j from +0.0f; rows that no j references are 0.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
// (_mxu_gather_split_bwd, reached through mxu_scatter_add from the row
// gather's VJP). That kernel computes the scatter exactly in f32 as one-hot
// MXU matmuls; its order of summation is fixed, so every run gives the same
// bits. Here the same contract, with the order pinned to ascending j: the
// plain PyTorch version on the CPU (scatter_add_) and XLA's scatter on the CPU
// both sum in that order, so all three agree bit for bit. Float atomics would
// add in a different order on every run, so no two threads ever add into one
// output word.
//
// Bound on the card: bytes of g (403 MB at FP0, B = 32, J = 24576, C = 128),
// read a row slice at a time in the order of a sort by index, and the tail
// of skewed rows: a column resampled from few points repeats them, so one
// source row may collect ~1000 of the ~12-24 references a row gets on
// average, and its sum is one chain of adds. Two routes, which
// scatter_kernel.plan() picks from the shapes:
//   1. block_kernel, one launch, where a batch row's indices and their sort
//      fit one block's shared memory (every index row of the SSG and MSG
//      train steps). A block per (slice of kChunks 32-channel chunks, group
//      of consecutive output rows, batch row) sorts the indices that fall in
//      its group in shared memory, a stable counting sort: each thread loads
//      kCountBatch indices at once and integer atomics count each walker
//      warp's stretch of j (16-bit counters, two a word); a prefix over the
//      walkers and a block scan give each key's offset; each walker then
//      walks its stretch in ascending j, 32 at a time (the next 32 in
//      flight), ranking equal keys by shuffles, so order (16-bit j's) lists
//      each key's j ascending. The block then streams its slice of the g
//      rows in that order through a double-buffered page of shared memory
//      (cp.async, `page` entries a stage, every warp issuing whatever the
//      rows' lengths; 16-byte copies past L1 where C % 4 == 0, which
//      measured faster than 4-byte ones at every FP level, 4-byte ones
//      elsewhere), and warp w sums the rows n with n % 32 == w from the
//      page into registers, carrying a row that crosses pages, and stores
//      each row once, coalesced. A skewed row is one warp's chain of
//      shared-memory adds, a few cycles an entry, beside the next page's
//      loads. The sum is bound by the page: fewer, longer pages measured
//      faster on the H100 than a third stage, wider slices at J >= 2048 or
//      more row groups, so plan() takes the fewest chunks that keep one
//      block a multiprocessor and the largest page shared memory holds.
//   2. csr_sort.cuh's card-wide sort and ordered sum (scatter_smem.cu's sort
//      route), where the row does not fit: J above 65535 (P3's FP0, J =
//      98304) or more than shared memory holds.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "csr_sort.cuh"
#include "on_device.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kBlockThreads = 1024;  // 32 warps
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kMaxPage = 1024;  // entries of a page
constexpr int kCountBatch = 8;  // indices a thread loads at once while counting
constexpr int kMaxBlockJ = 65535;  // j, counts and ranks fit 16 bits

// The index of the last offset <= k in off[0..n], n >= 0; off ascending,
// off[0] <= k.
__device__ __forceinline__ int last_at_most(const int* off, int n, int k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Copies 16 bytes from device memory to shared memory, past L1 (cp.async.cg).
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Words of shared memory before the region: off (rows + 1 ints), rounded
// up to 16 bytes for the region's 16-byte copies.
__host__ __device__ inline int head_words(int rows) { return (rows + 4) / 4 * 4; }

// grid (slices of kChunks x 32 channels, groups, B). Dynamic shared memory:
// off (head_words(rows) ints), then one region of 4-byte words that holds
// first the walkers' packed 16-bit counters (walkers x ceil(rows / 2)) and
// then the page's two stages (2 x page x kChunks x 32 floats), then order (J
// 16-bit j's). kVec: floats a copy of the page moves (4 where C % 4 == 0,
// else 1).
template <int kChunks, int kVec>
__global__ void __launch_bounds__(kBlockThreads)
    block_kernel(const int* __restrict__ idx, const float* __restrict__ g, int N, int J, int C,
                 int rows_per_group, int walkers, int page, float* __restrict__ out) {
  constexpr int kWidth = kChunks * 32;  // channels of the block's slice
  extern __shared__ __align__(16) int block_smem[];
  __shared__ int warp_total[kBlockWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kWidth;
  const int n0 = blockIdx.y * rows_per_group;
  const int rows = min(rows_per_group, N - n0);
  const long long b = blockIdx.z;
  const int words = (rows + 1) / 2;
  const int region = max(walkers * words, 2 * page * kWidth);
  int* off = block_smem;
  unsigned* cursor = reinterpret_cast<unsigned*>(off + head_words(rows));
  float* stages = reinterpret_cast<float*>(off + head_words(rows));
  unsigned short* order = reinterpret_cast<unsigned short*>(off + head_words(rows) + region);
  const int* ib = idx + b * J;
  const int stretch = max(32, (J + walkers * 32 - 1) / (walkers * 32) * 32);

  // each walker's key counts over its stretch of j
  for (int w = threadIdx.x; w < walkers * words; w += kBlockThreads) cursor[w] = 0u;
  __syncthreads();
  for (int j0 = threadIdx.x; j0 < J; j0 += kCountBatch * kBlockThreads) {
    int key[kCountBatch];  // kCountBatch loads in flight
#pragma unroll
    for (int u = 0; u < kCountBatch; ++u) {
      const int j = j0 + u * kBlockThreads;
      key[u] = j < J ? ib[j] - n0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kCountBatch; ++u) {
      if (static_cast<unsigned>(key[u]) < static_cast<unsigned>(rows)) {
        const int j = j0 + u * kBlockThreads;
        atomicAdd(&cursor[(j / stretch) * words + (key[u] >> 1)], 1u << half_shift(key[u]));
      }
    }
  }
  __syncthreads();
  // per key: the exclusive prefix of its counts over the walkers (in place)
  // and its total; both keys of a word at once, neither half can carry
  for (int w = threadIdx.x; w < words; w += kBlockThreads) {
    unsigned run = 0u;
    for (int q = 0; q < walkers; ++q) {
      const unsigned c = cursor[q * words + w];
      cursor[q * words + w] = run;
      run += c;
    }
    off[2 * w] = static_cast<int>(run & 0xffffu);
    if (2 * w + 1 < rows) off[2 * w + 1] = static_cast<int>(run >> 16);
  }
  __syncthreads();
  {  // off: the totals -> their exclusive prefix, the group's total at rows
    const int per = (rows + kBlockThreads - 1) / kBlockThreads;
    const int lo = min(rows, static_cast<int>(threadIdx.x) * per);
    const int hi = min(rows, lo + per);
    int local = 0;
    for (int n = lo; n < hi; ++n) local += off[n];
    const int incl = warp_inclusive_scan(local, lane);
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_total[lane] = warp_inclusive_scan(warp_total[lane], lane);
    __syncthreads();
    int base = incl - local + (warp > 0 ? warp_total[warp - 1] : 0);
    for (int n = lo; n < hi; ++n) {
      const int c = off[n];
      off[n] = base;
      base += c;
    }
    if (threadIdx.x == 0) off[rows] = warp_total[kBlockWarps - 1];
  }
  __syncthreads();
  if (warp < walkers) {  // walker `warp` places its stretch in ascending j
    unsigned* cur = cursor + warp * words;
    const int end = min(J, (warp + 1) * stretch);
    int next = warp * stretch + lane < end ? ib[warp * stretch + lane] - n0 : -1;
    for (int j0 = warp * stretch; j0 < end; j0 += 32) {
      const int j = j0 + lane;
      const int k = next;
      next = j + 32 < end ? ib[j + 32] - n0 : -1;  // the next step's key, in flight
      const int key = static_cast<unsigned>(k) < static_cast<unsigned>(rows) ? k : -1;
      unsigned below = 0, peers = 0;  // lanes with this key: lower ones, all
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        const bool same = __shfl_sync(0xffffffffu, key, d) == key;
        below += same && d < lane;
        peers += same;
      }
      unsigned rank = 0;
      if (key >= 0) rank = ((cur[key >> 1] >> half_shift(key)) & 0xffffu) + below;
      __syncwarp();  // every lane has read its cursor before the last peer moves it
      if (key >= 0 && below + 1 == peers) atomicAdd(&cur[key >> 1], peers << half_shift(key));
      __syncwarp();
      if (key >= 0) order[off[key] + rank] = static_cast<unsigned short>(j);
    }
  }
  __syncthreads();

  bool live[kChunks];  // lane's channel of each 32-channel chunk lies below C
#pragma unroll
  for (int q = 0; q < kChunks; ++q) live[q] = c0 + q * 32 + lane < C;
  float* ob = out + (b * N + n0) * C + c0 + lane;
  for (int r = warp; r < rows; r += kBlockWarps) {  // rows no entry names are 0
    if (off[r] == off[r + 1]) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        if (live[q]) ob[static_cast<long long>(r) * C + q * 32] = 0.0f;
      }
    }
  }
  const int total = off[rows];
  const float* gb = g + b * J * C + c0;
  // the page of entries p0 .. p0 + page into one stage while the other is
  // summed: each entry's slice is a run of kWidth floats of one g row, kPer
  // copies of kVec floats, which consecutive threads take (a warp moves 128
  // coalesced bytes, or 512 with kVec = 4)
  auto issue = [&](int p0, float* stage) {
    constexpr int kPer = kWidth / kVec;
    const int n = min(page, total - p0);
    for (int it = threadIdx.x; it < n * kPer; it += kBlockThreads) {
      const int e = it / kPer;
      const int f = (it - e * kPer) * kVec;
      if (c0 + f < C) {
        const float* src = gb + static_cast<long long>(order[p0 + e]) * C + f;
        if constexpr (kVec == 4) {
          copy16_async(stage + e * kWidth + f, src);
        } else {
          __pipeline_memcpy_async(stage + e * kWidth + f, src, sizeof(float));
        }
      }
    }
    __pipeline_commit();
  };
  if (total > 0) issue(0, stages);
  float acc[kChunks];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) acc[q] = 0.0f;
  for (int p0 = 0, i = 0; p0 < total; p0 += page, i ^= 1) {
    const float* stage = stages + i * page * kWidth + lane;
    if (p0 + page < total) {
      issue(p0 + page, stages + (i ^ 1) * page * kWidth);
    } else {
      __pipeline_commit();  // an empty group: wait_prior(1) below still means this page
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    const int pend = min(p0 + page, total);
    const int r_lo = last_at_most(off, rows, p0);
    const int r_hi = last_at_most(off, rows, pend - 1);
    // warp w owns the rows r with r % 32 == w; the row open at p0 is r_lo,
    // whose owner kept its sums in acc
    for (int r = r_lo + (warp - r_lo % kBlockWarps + kBlockWarps) % kBlockWarps; r <= r_hi;
         r += kBlockWarps) {
      const int start = off[r], end = off[r + 1];
      if (start == end) continue;
      if (start >= p0) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q) acc[q] = 0.0f;
      }
      const int k1 = min(end, pend);
#pragma unroll 4
      for (int k = max(start, p0); k < k1; ++k) {
        const float* x = stage + (k - p0) * kWidth;
#pragma unroll
        for (int q = 0; q < kChunks; ++q) acc[q] = __fadd_rn(acc[q], x[q * 32]);
      }
      if (end <= pend) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          if (live[q]) ob[static_cast<long long>(r) * C + q * 32] = acc[q];
        }
      }
    }
    __syncthreads();  // the stage is summed before the next page's loads reuse it
  }
}

template <int kChunks, int kVec>
cudaError_t launch_block(const int* idx, const float* g, int B, int N, int J, int C,
                         int rows_per_group, int walkers, int page, float* out,
                         cudaStream_t stream) {
  const long long words = (rows_per_group + 1) / 2;
  const long long stages = 2LL * page * kChunks * 32;
  const long long region = walkers * words > stages ? walkers * words : stages;
  const size_t smem = static_cast<size_t>(head_words(rows_per_group) + region) * sizeof(int) +
                      static_cast<size_t>(J) * sizeof(unsigned short);
  static int allowed[kP2MaxDevices] = {};
  cudaError_t err = p2_allow_smem(block_kernel<kChunks, kVec>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kChunks * 32 - 1) / (kChunks * 32), (N + rows_per_group - 1) / rows_per_group,
                  B);
  block_kernel<kChunks, kVec><<<grid, kBlockThreads, smem, stream>>>(idx, g, N, J, C,
                                                                     rows_per_group, walkers,
                                                                     page, out);
  return cudaGetLastError();
}

}  // namespace

// idx (B, J) int32 in [0, N), trusted; g (B, J, C) float32; out (B, N, C)
// float32, every word written. The block route, one launch: chunks (a
// block's slice of channels in 32-channel chunks, 1 to 4), vec (floats a
// copy moves: 4, where C % 4 == 0, or 1), rows_per_group
// (the output rows a block takes, 1 to N), walkers (the warps that sort, 1
// to 32) and page (entries a stage of the page holds, 1 to 1024), all from
// scatter_kernel.plan(), which keeps J <= 65535 and the block's shared
// memory (scatter_kernel.block_bytes) within the card's. device: the card
// that holds the tensors.
extern "C" int p2_scatter_add(const int* idx, const float* g, int B, int N, int J, int C,
                              int chunks, int vec, int rows_per_group, int walkers, int page,
                              float* out, int device, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (J < 0 || J > kMaxBlockJ || B > 65535 || rows_per_group < 1 || rows_per_group > N ||
      (N + rows_per_group - 1) / rows_per_group > 65535 || walkers < 1 ||
      walkers > kBlockWarps || page < 1 || page > kMaxPage || (vec == 4 && C % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p2_on_device(device, [&] {
    switch (chunks * 10 + vec) {
#define P2_BLOCK_CASE(c, v) \
  case c * 10 + v:          \
    return launch_block<c, v>(idx, g, B, N, J, C, rows_per_group, walkers, page, out, s);
      P2_BLOCK_CASE(1, 1) P2_BLOCK_CASE(2, 1) P2_BLOCK_CASE(3, 1) P2_BLOCK_CASE(4, 1)
      P2_BLOCK_CASE(1, 4) P2_BLOCK_CASE(2, 4) P2_BLOCK_CASE(3, 4) P2_BLOCK_CASE(4, 4)
#undef P2_BLOCK_CASE
      default: return cudaErrorInvalidValue;
    }
  }));
}

// The sort route: csr_scatter_add (csr_sort.cuh) with scatter_kernel.plan()'s
// tile, walkers and rows; scratch as csr_scatter_add takes it; device as
// above.
extern "C" int p2_scatter_add_sort(const int* idx, const float* g, int B, int N, int J, int C,
                                   int tile, int walkers, int rows, int* scratch, float* out,
                                   int device, void* stream) {
  return static_cast<int>(p2_on_device(device, [&] {
    return static_cast<cudaError_t>(
        csr_scatter_add(idx, g, B, N, J, C, tile, walkers, rows, scratch, out, stream));
  }));
}
