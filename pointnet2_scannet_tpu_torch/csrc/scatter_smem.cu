// Deterministic scatter-add into shared memory, the backward of
// gather_smem.cu:
//   out[b, n, :] = sum over j with idx[b, j] == n of g[b, j, :]
// summed in ascending j from +0.0f; rows that no j references are 0.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
// (_mxu_gather_bwd, the VJP of mxu_gather). The TPU kernel keeps the whole
// (N, C) accumulator of a batch row in VMEM and adds one 128-row one-hot
// product into it per grid step. The design point carried over is that
// accumulator held on chip: here each block accumulates a share of a batch
// row's output in shared memory, so no float atomics and no device-memory
// read-modify-write; the sum order is ascending j, as in scatter_add.cu, the
// CPU's scatter_add_ and XLA's scatter, so all agree bit for bit and every
// launch gives the same bits.
//
// One block of 32 warps per (batch row, row group, channel slice): the block
// owns the output rows n with n % G == group and channels [c0, c0 + w), an
// accumulator of ceil(N / G) x w words. Warp k owns the block's rows whose
// local index n / G is k modulo 32, so no two warps ever add into the same
// word. The block walks j in tiles of 1024 keys, one a thread: a stable
// counting sort in shared memory (ballots per owning warp, then scans) lists
// each warp's entries of the tile in ascending j; each warp then takes its
// list kBatch entries at a time, the lanes as channels loading a stretch of
// g's row for all kBatch entries before adding them in order. A lane adds
// into one channel only, in program order, so the order of every sum is
// ascending j.
//
// Bound on the card: bytes of g (each word read once). Every block of a
// batch row reads all of idx[b, :] (from L2), and a tile's turn ends when
// its busiest warp is done (a row referenced many times, for one).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps; one key a thread per tile
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;       // listed entries whose g rows load together
constexpr int kMaxSmemBytes = 200 * 1024;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    scatter_smem_kernel(const int* __restrict__ idx,
                        const float* __restrict__ g, int N, int J, int C,
                        int cs, int groups, float* __restrict__ out) {
  extern __shared__ float acc[];  // (rows, w): local row r is n = r * groups + group
  __shared__ int offset[kWarps][kWarps + 1];  // [source warp][owner warp]
  __shared__ int start[kWarps + 1];           // each owner's list in the tile
  __shared__ int list_row[kThreads];
  __shared__ int list_j[kThreads];
  const long long b = blockIdx.z;
  const int group = blockIdx.y;
  const int c0 = blockIdx.x * cs;
  const int w = min(cs, C - c0);
  const int rows = (N - group + groups - 1) / groups;
  for (int t = threadIdx.x; t < rows * w; t += kThreads) acc[t] = 0.0f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int* ib = idx + b * J;
  const float* gb = g + b * J * C + c0;
  for (int j0 = 0; j0 < J; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const int n = j < J ? ib[j] : -1;
    const int r = n / groups;
    const int owner = n >= 0 && n - r * groups == group ? (r & 31) : -1;
    int rank = 0;
    for (int o = 0; o < kWarps; ++o) {
      const unsigned peers = __ballot_sync(0xffffffffu, owner == o);
      if (lane == o) offset[warp][o] = __popc(peers);
      if (owner == o) rank = __popc(peers & lower);
    }
    __syncthreads();  // also: the previous tile's lists are consumed
    {  // warp o: exclusive scan of owner o's counts over the source warps
      const int count = offset[lane][warp];
      const int incl = warp_inclusive_scan(count, lane);
      offset[lane][warp] = incl - count;
      if (lane == 31) start[warp + 1] = incl;  // owner o's total, for now
    }
    __syncthreads();
    if (warp == 0) {
      const int total = start[lane + 1];
      const int incl = warp_inclusive_scan(total, lane);
      start[lane + 1] = incl;
      if (lane == 0) start[0] = 0;
    }
    __syncthreads();
    if (owner >= 0) {
      const int pos = start[owner] + offset[warp][owner] + rank;
      list_row[pos] = r;
      list_j[pos] = j;
    }
    __syncthreads();
    const int end = start[warp + 1];
    for (int e0 = start[warp]; e0 < end; e0 += kBatch) {
      const int cnt = min(kBatch, end - e0);
      int rowk[kBatch], jk[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        rowk[e] = e < cnt ? list_row[e0 + e] : 0;
        jk[e] = e < cnt ? list_j[e0 + e] : 0;
      }
      for (int c = lane; c < w; c += 32) {
        float v[kBatch];
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          v[e] = e < cnt ? gb[static_cast<long long>(jk[e]) * C + c] : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          if (e < cnt) {
            float* a = acc + rowk[e] * w + c;
            *a = __fadd_rn(*a, v[e]);
          }
        }
      }
    }
  }
  __syncthreads();

  float* obase = out + b * N * C + c0;
  for (int t = threadIdx.x; t < rows * w; t += kThreads) {
    const int r = t / w;
    obase[(static_cast<long long>(r) * groups + group) * C + (t - r * w)] = acc[t];
  }
}

}  // namespace

// idx (B, J) int32 in [0, N), trusted; g (B, J, C) float32; out (B, N, C)
// float32, every word written. cs: the channels a block accumulates; groups:
// the row groups a batch row's output is split into (ceil(N / groups) * cs *
// 4 <= 200 KiB).
extern "C" int p2_scatter_smem(const int* idx, const float* g, int B, int N,
                               int J, int C, int cs, int groups, float* out,
                               void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (J < 0 || cs <= 0 || groups <= 0 || groups > N || B > 65535 ||
      groups > 65535 ||
      static_cast<long long>((N + groups - 1) / groups) * cs * 4 > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = cs < C ? cs : C;
  const size_t smem = static_cast<size_t>((N + groups - 1) / groups) * w * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_smem_kernel<<<dim3((C + cs - 1) / cs, groups, B), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      idx, g, N, J, C, cs, groups, out);
  return static_cast<int>(cudaGetLastError());
}
