// Row gather of 4-byte words: out[b, j, :] = src[b, idx[b, j], :].
//
// Replaces pointnet2_scannet_tpu/ops/pallas/vmem_gather_kernel.py
// (_vmem_gather_fwd_only, reached through vmem_gather / vmem_gather_any).
// float32 and int32 rows move as raw 32-bit words, so the copy is bit-exact
// for both. The backward is scatter_add.cu.
//
// Bound on the card: bytes. The TPU kernel rebuilt a gather out of 128-lane
// selects because the TPU has no general gather; the card loads any address,
// so this is a plain copy over the flat output. The row widths on the serving
// path (3, 9, 67, 131 and 259 words) are not multiples of 4, so the source
// reads stay one word each, but each thread writes 4 consecutive output words
// with one 16-byte store and pays the flat-index division once for the 4
// (the per-word division dominated a one-word-per-thread version). The source
// rows of a batch (at most 8 MiB at SA1) stay in L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__global__ void gather_kernel(const unsigned* __restrict__ src,
                              const int* __restrict__ idx, int N, int J, int C,
                              long long total, bool aligned,
                              unsigned* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kVec;
  for (long long t0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
       t0 < total; t0 += stride) {
    long long row = t0 / C;  // b * J + j
    int c = static_cast<int>(t0 - row * C);
    long long b = row / J;
    int j = static_cast<int>(row - b * J);
    const unsigned* srow = src + (b * N + idx[row]) * C;
    unsigned v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      v[e] = t0 + e < total ? srow[c] : 0u;
      if (++c == C) {  // the next word starts the next row
        c = 0;
        ++row;
        if (++j == J) {
          j = 0;
          ++b;
        }
        if (t0 + e + 1 < total) srow = src + (b * N + idx[row]) * C;
      }
    }
    if (aligned && t0 + kVec <= total) {
      *reinterpret_cast<uint4*>(out + t0) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < kVec && t0 + e < total; ++e) out[t0 + e] = v[e];
    }
  }
}

}  // namespace

// src and out are 4-byte words (float32 or int32); idx holds int32 indices
// that the caller guarantees lie in [0, N).
extern "C" int p2_gather(const void* src, const int* idx, int B, int N, int J,
                         int C, void* out, void* stream) {
  const long long total = static_cast<long long>(B) * J * C;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (total + kThreads * kVec - 1) / (kThreads * kVec);
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  const bool aligned = reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(src), idx, N, J, C, total, aligned,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
