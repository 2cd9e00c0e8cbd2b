// Deterministic scatter-add, the backward of gather_smem.cu:
//   out[b, n, :] = sum over j with idx[b, j] == n of g[b, j, :]
// summed in ascending j from +0.0f; rows that no j references are 0.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
// (_mxu_gather_bwd, the VJP of mxu_gather). The TPU kernel keeps a batch
// row's (N, C) accumulator in VMEM and adds one 128-row one-hot product into
// it per grid step. Here the sum order is pinned to ascending j, as in
// scatter_add.cu, the CPU's scatter_add_ and XLA's scatter, so all agree bit
// for bit and every launch gives the same bits; no float atomics.
//
// Bound on the card: bytes of g (each word read once) and of out (written
// once). Two routes, which scatter_smem_kernel.plan() picks from the shapes:
// where the accumulate route's blocks of a batch row would walk few indices
// in all (at most 65536: the MXU-gather configuration's SA2 and SA3
// backwards), accumulate_kernel below, an accumulator in shared memory;
// elsewhere (bench_gather's J = 32768, where every one of its blocks walking
// all J indices cost 2.4x scatter_add_) the sort route, csr_sort.cuh's
// csr_scatter_add: it sorts each index row once, in parallel over the card,
// and then sums output-stationary with the accumulator in registers (see
// the note at the head of csr_sort.cuh).
#include <cuda_runtime.h>

#include "csr_sort.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kAccThreads = 1024;  // 32 warps; one key a thread per tile
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kAccBatch = 8;  // listed entries whose g rows load together
constexpr int kAccSmemBytes = 200 * 1024;

// The accumulate route, for little index work a batch row: one block of 32
// warps per (batch row, row group, channel slice) owns the output rows n
// with n % G == group and channels [c0, c0 + w), an accumulator of
// ceil(N / G) x w words in shared memory. Warp k owns the block's rows whose
// local index n / G is k modulo 32, so no two warps ever add into the same
// word. The block walks all J indices of its batch row in tiles of 1024
// keys, one a thread: a stable counting sort in shared memory (ballots per
// owning warp, then scans) lists each warp's entries of the tile in
// ascending j; each warp then takes its list kAccBatch entries at a time,
// the lanes as channels loading a stretch of g's row for all kAccBatch
// entries before adding them in order. g is read in tile order, and a
// skewed row's adds stay in shared memory; every block pays a walk of all
// J indices.
__global__ void __launch_bounds__(kAccThreads)
    accumulate_kernel(const int* __restrict__ idx,
                        const float* __restrict__ g, int N, int J, int C,
                        int cs, int groups, float* __restrict__ out) {
  extern __shared__ float acc[];  // (rows, w): local row r is n = r * groups + group
  __shared__ int offset[kAccWarps][kAccWarps + 1];  // [source warp][owner warp]
  __shared__ int start[kAccWarps + 1];           // each owner's list in the tile
  __shared__ int list_row[kAccThreads];
  __shared__ int list_j[kAccThreads];
  const long long b = blockIdx.z;
  const int group = blockIdx.y;
  const int c0 = blockIdx.x * cs;
  const int w = min(cs, C - c0);
  const int rows = (N - group + groups - 1) / groups;
  for (int t = threadIdx.x; t < rows * w; t += kAccThreads) acc[t] = 0.0f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int* ib = idx + b * J;
  const float* gb = g + b * J * C + c0;
  for (int j0 = 0; j0 < J; j0 += kAccThreads) {
    const int j = j0 + threadIdx.x;
    const int n = j < J ? ib[j] : -1;
    const int r = n / groups;
    const int owner = n >= 0 && n - r * groups == group ? (r & 31) : -1;
    int rank = 0;
    for (int o = 0; o < kAccWarps; ++o) {
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
    for (int e0 = start[warp]; e0 < end; e0 += kAccBatch) {
      const int cnt = min(kAccBatch, end - e0);
      int rowk[kAccBatch], jk[kAccBatch];
#pragma unroll
      for (int e = 0; e < kAccBatch; ++e) {
        rowk[e] = e < cnt ? list_row[e0 + e] : 0;
        jk[e] = e < cnt ? list_j[e0 + e] : 0;
      }
      for (int c = lane; c < w; c += 32) {
        float v[kAccBatch];
#pragma unroll
        for (int e = 0; e < kAccBatch; ++e) {
          v[e] = e < cnt ? gb[static_cast<long long>(jk[e]) * C + c] : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < kAccBatch; ++e) {
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
  for (int t = threadIdx.x; t < rows * w; t += kAccThreads) {
    const int r = t / w;
    obase[(static_cast<long long>(r) * groups + group) * C + (t - r * w)] = acc[t];
  }
}

}  // namespace

// The sort route: csr_scatter_add (csr_sort.cuh) with scatter_smem_kernel.plan()'s
// tile, walkers and rows.
extern "C" int p2_scatter_smem(const int* idx, const float* g, int B, int N,
                               int J, int C, int tile, int walkers, int rows,
                               int* scratch, float* out, void* stream) {
  return csr_scatter_add(idx, g, B, N, J, C, tile, walkers, rows, scratch, out, stream);
}

// The accumulate route: idx, g and out as above; cs: the channels a block
// accumulates; groups: the row groups a batch row's output is split into
// (ceil(N / groups) * cs * 4 <= 200 KiB); both from
// scatter_smem_kernel.plan().
extern "C" int p2_scatter_smem_accumulate(const int* idx, const float* g, int B, int N,
                                          int J, int C, int cs, int groups, float* out,
                                          void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (J < 0 || cs <= 0 || groups <= 0 || groups > N || B > 65535 || groups > 65535 ||
      static_cast<long long>((N + groups - 1) / groups) * cs * 4 > kAccSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = cs < C ? cs : C;
  const size_t smem = static_cast<size_t>((N + groups - 1) / groups) * w * sizeof(float);
  static int allowed[kP2MaxDevices] = {};
  cudaError_t err = p2_allow_smem(accumulate_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  accumulate_kernel<<<dim3((C + cs - 1) / cs, groups, B), kAccThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(idx, g, N, J, C, cs, groups, out);
  return static_cast<int>(cudaGetLastError());
}
