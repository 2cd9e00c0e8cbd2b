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
// both sum in that order, so all three agree bit for bit.
//
// Bound on the card: bytes of g (403 MB at FP0, B = 32, J = 24576, C = 128)
// and, for the short rows of the deep levels, launch latency. Float atomics
// would add in a different order on every run, so the design never lets two
// threads add into one output word:
//   1. csr_kernel, one block per batch row: a stable counting sort of idx[b]
//      into CSR form. Integer shared-memory atomics count the keys (integer
//      addition is order-free), a block scan turns the counts into offsets,
//      and one warp then walks j in ascending order, 32 at a time, placing
//      each j at its key's cursor. Equal keys inside the 32 are ranked by
//      __match_any_sync and the popcount of the lower lanes, so order[]
//      lists each key's j in ascending order. Shared memory holds only the N
//      counters (4 N bytes); idx is read from device memory twice.
//   2. segment_sum_kernel, one warp per (b, n, 32-channel chunk): each lane
//      adds g[b, order[k], c] for k over the key's segment in order and
//      stores once. Consecutive lanes read consecutive words of a g row, so
//      every read is one coalesced 128-byte line. Segments are skewed: a
//      column resampled from few points repeats them, and one source row
//      may collect ~1000 of the ~12-24 references a row gets on average. So
//      the channel chunks of a segment run in warps of their own, the warp
//      loads 32 entries of order[] at once and broadcasts them by shuffle,
//      and each lane issues all 32 row loads before it adds them in order:
//      a long segment costs its length / 32 memory latencies, not its
//      length times two.
#include <cuda_runtime.h>

namespace {

constexpr int kSortThreads = 1024;  // 32 full warps: the scans below need it
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSumThreads = 256;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// offsets (B, N + 1): segment bounds; order (B, J): the j of each segment,
// ascending. Dynamic shared memory: N ints, first the counts, then the
// cursors.
__global__ void __launch_bounds__(kSortThreads)
    csr_kernel(const int* __restrict__ idx, int N, int J,
               int* __restrict__ offsets, int* __restrict__ order) {
  extern __shared__ int cursor[];
  __shared__ int warp_total[kSortWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  const int* row = idx + b * J;
  int* off = offsets + b * (N + 1);
  int* ord = order + b * J;

  for (int n = threadIdx.x; n < N; n += kSortThreads) cursor[n] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < J; j += kSortThreads) atomicAdd(&cursor[row[j]], 1);
  __syncthreads();

  // exclusive scan of the counts: each thread owns a contiguous run of keys
  const int per = (N + kSortThreads - 1) / kSortThreads;
  const int lo = min(N, static_cast<int>(threadIdx.x) * per);
  const int hi = min(N, lo + per);
  int local = 0;
  for (int n = lo; n < hi; ++n) local += cursor[n];
  const int incl = warp_inclusive_scan(local, lane);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_total[lane] = warp_inclusive_scan(warp_total[lane], lane);
  __syncthreads();
  int base = incl - local + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int n = lo; n < hi; ++n) {
    const int c = cursor[n];
    cursor[n] = base;
    off[n] = base;
    base += c;
  }
  if (threadIdx.x == 0) off[N] = J;
  __syncthreads();

  // stable placement: warp 0 walks j in ascending order, 32 at a time
  if (warp != 0) return;
  const unsigned lower = (1u << lane) - 1u;
  for (int j0 = 0; j0 < J; j0 += 32) {
    const int j = j0 + lane;
    const bool live = j < J;
    const int key = live ? row[j] : -1;  // dead lanes group apart from keys
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int pos = live ? cursor[key] + __popc(peers & lower) : 0;
    __syncwarp();  // every lane has read its cursor before the leader moves it
    if (live && lane == __ffs(peers) - 1) cursor[key] += __popc(peers);
    __syncwarp();
    if (live) ord[pos] = j;
  }
}

__global__ void __launch_bounds__(kSumThreads)
    segment_sum_kernel(const float* __restrict__ g,
                       const int* __restrict__ offsets,
                       const int* __restrict__ order, int N, int J, int C,
                       int chunks, long long warps, float* __restrict__ out) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) >> 5;
  if (w >= warps) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long seg = w / chunks;
  const int c = static_cast<int>(w - seg * chunks) * 32 + lane;
  const bool live = c < C;
  const long long b = seg / N;
  const int n = static_cast<int>(seg - b * N);
  const int start = offsets[b * (N + 1) + n];
  const int end = offsets[b * (N + 1) + n + 1];
  const int* ord = order + b * J;
  const float* gb = g + b * J * C + (live ? c : 0);
  float acc = 0.0f;
  for (int k0 = start; k0 < end; k0 += 32) {  // warp-uniform bounds
    const int cnt = min(32, end - k0);
    const int mine = lane < cnt ? ord[k0 + lane] : 0;
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const long long j = __shfl_sync(0xffffffffu, mine, u);
      v[u] = (live && u < cnt) ? gb[j * C] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if (u < cnt) acc = __fadd_rn(acc, v[u]);
    }
  }
  if (live) out[seg * C + c] = acc;
}

}  // namespace

// idx (B, J) int32 in [0, N), trusted; g (B, J, C) float32; out (B, N, C)
// float32. offsets (B, N + 1) and order (B, J) int32 are scratch that the
// caller allocates. N <= kMaxN (128 KiB of counters in shared memory).
extern "C" int p2_scatter_add(const int* idx, const float* g, int B, int N,
                              int J, int C, int* offsets, int* order,
                              float* out, void* stream) {
  constexpr int kMaxN = 32768;
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (N > kMaxN || J < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(N) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_kernel<<<B, kSortThreads, smem, s>>>(idx, N, J, offsets, order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (C + 31) / 32;
  const long long warps = static_cast<long long>(B) * N * chunks;
  const long long blocks = (warps * 32 + kSumThreads - 1) / kSumThreads;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      g, offsets, order, N, J, C, chunks, warps, out);
  return static_cast<int>(cudaGetLastError());
}
