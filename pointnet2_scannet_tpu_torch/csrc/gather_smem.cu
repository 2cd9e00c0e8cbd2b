// Row gather out of shared memory: out[b, j, :] = src[b, idx[b, j], :].
//
// Replaces pointnet2_scannet_tpu/ops/pallas/gather_kernel.py
// (_mxu_gather_fwd_only, the forward of mxu_gather, and
// _mxu_gather_split_fwd_only, the forward of mxu_gather_split). Both TPU
// kernels hold a batch row's whole (N, C) source in VMEM and build each
// 128-row output tile as a one-hot matrix product on the MXU, at f32
// HIGHEST precision or as three exact bf16 planes, because the TPU has no
// general gather. On this card a one-hot product would spend N
// multiply-adds on every word a gather only moves (about 8e11 operations at
// B = 32, J = 32768, N = 8192, C = 16), so this kernel keeps the TPU
// kernels' design point, the batch row's source held on chip, and copies.
//
// One block per (batch row, row group): the block stages the source rows
// n with n % G == group, whole (ceil(N / G) x C words, at most
// kMaxSmemBytes; the wrapper picks G), then walks all J indices of its
// batch row, 32 at a time a warp, and writes the output rows whose index
// falls in its group: each output row is written whole by one block, its
// words by consecutive lanes (several rows a pass when C < 32). Words move
// as raw 32 bits, so float32 and int32 are bit-exact, -0.0, inf and NaN
// included. (The TPU's product turns -0.0 into +0.0 and spreads a
// non-finite source value as NaN into the other rows of its tile; the port
// follows the gather.)
//
// Bound on the card: bytes, the output's above all. Each source word is
// staged once; every block reads all of its batch row's indices (from L2).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmemBytes = 200 * 1024;

__global__ void __launch_bounds__(kThreads)
    gather_smem_kernel(const unsigned* __restrict__ src,
                       const int* __restrict__ idx, int N, int J, int C,
                       int groups, unsigned* __restrict__ out) {
  extern __shared__ unsigned slab[];  // (rows, C): local row r is n = r * groups + group
  const long long b = blockIdx.y;
  const int group = blockIdx.x;
  const int rows = (N - group + groups - 1) / groups;
  const unsigned* sb = src + b * N * C;
  for (int t = threadIdx.x; t < rows * C; t += kThreads) {
    const int r = t / C;
    slab[t] = sb[(static_cast<long long>(r) * groups + group) * C + (t - r * C)];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* ib = idx + b * J;
  unsigned* ob = out + b * J * C;
  // rows a pass: lane = slot * C + c for C < 32, else one row, c = lane + 32 k
  const int per = C < 32 ? 32 / C : 1;
  const int slot = C < 32 ? lane / C : 0;
  const int c0 = lane - slot * C;
  for (int j0 = warp * 32; j0 < J; j0 += kThreads) {
    const int j = j0 + lane;
    const int n = j < J ? ib[j] : -1;
    const int r = n / groups;
    unsigned mine = __ballot_sync(0xffffffffu, n >= 0 && n - r * groups == group);
    while (mine) {  // warp-uniform
      int from = -1;  // the lane whose entry this lane's slot copies
#pragma unroll 4
      for (int k = 0; k < per && mine; ++k) {
        const int s = __ffs(mine) - 1;
        if (k == slot) from = s;
        mine &= mine - 1;
      }
      const int rr = __shfl_sync(0xffffffffu, r, from < 0 ? 0 : from);
      if (from >= 0 && slot < per) {
        const unsigned* row = slab + rr * C;
        unsigned* dst = ob + static_cast<long long>(j0 + from) * C;
        for (int c = c0; c < C; c += 32) dst[c] = row[c];
      }
    }
  }
}

}  // namespace

// src (B, N, C) and out (B, J, C) are 4-byte words (float32 or int32); idx
// (B, J) int32 indices that the caller guarantees lie in [0, N). groups:
// the row groups a batch row's source is split into, ceil(N / groups) * C
// * 4 <= 200 KiB.
extern "C" int p2_gather_smem(const void* src, const int* idx, int B, int N,
                              int J, int C, int groups, void* out,
                              void* stream) {
  if (B <= 0 || J <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || groups <= 0 || groups > N || groups > 65535 || B > 65535 ||
      static_cast<long long>((N + groups - 1) / groups) * C * 4 > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>((N + groups - 1) / groups) * C * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_smem_kernel<<<dim3(groups, B), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(src), idx, N, J, C, groups,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
