// Row gather of raw words: out[b, j, :] = src[b, idx[b, j], :].
//
// Replaces pointnet2_scannet_tpu/ops/pallas/vmem_gather_kernel.py
// (_vmem_gather_fwd_only, reached through vmem_gather / vmem_gather_any).
// float32 and int32 rows move as raw 32-bit words, so the copy is bit-exact
// for both (-0.0, inf and NaN patterns included). bfloat16 rows of even C
// come as int32 lane pairs (the wrapper's view of the same bytes, as the
// TPU kernel's _pack_bf16 bitcast); odd C (a 3-channel input's SA1 payload
// of 9), or a row start off 4-byte alignment, moves 2-byte words through
// the same kernel. The backward is scatter_add.cu.
//
// Bound on the card: bytes, reached only with many independent loads in
// flight. The TPU kernel rebuilt a gather out of 128-lane selects because
// the TPU has no general gather; the card loads any address, so this is a
// copy over the flat output, one tile of K * 256 output words a block. A
// block first loads the indices of the rows its tile touches, coalesced,
// and turns each into the offset of its source row in shared memory; then
// each thread issues its K source loads, all independent, before its K
// coalesced stores. Index math is 32-bit: a flat word splits into (row,
// word) by a multiply-high and a shift with a magic number the host
// computes, never a division. A word is 16 bytes (uint4) where every row
// is a whole number of them and both pointers are 16-byte aligned (the FP
// levels' 128-1024 channels, MSG's pregather widths), else 4 bytes (the
// 3, 9, 67, 99, 131 and 259-word rows). The source rows of a batch (at most
// 37 MiB at SA1) mostly stay in L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 8;
constexpr unsigned kMaxWords = 0x7fffffffu;  // flat words of one launch: below 2^31

// n / d for n < 2^31 by a multiply-high and a shift (d >= 1)
struct Divider {
  unsigned magic;
  unsigned shift;
};

Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while ((1ull << shift) < d) ++shift;
  const unsigned long long magic = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return Divider{static_cast<unsigned>(magic), shift};
}

__device__ __forceinline__ unsigned p2_div(unsigned n, Divider v) {
  return (__umulhi(n, v.magic) + n) >> v.shift;
}

// W: the word (unsigned or uint4); K: words a thread moves
template <typename W, int K>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const W* __restrict__ src, const int* __restrict__ idx, int N, int width,
                  Divider by_width, Divider by_j, unsigned total, W* __restrict__ out) {
  __shared__ long long base[K * kThreads + 1];  // source word offset of each row of the tile
  const unsigned t0 = blockIdx.x * (K * kThreads);
  const unsigned r0 = p2_div(t0, by_width);
  const unsigned r1 = p2_div(min(t0 + K * kThreads, total) - 1, by_width);
  for (unsigned r = r0 + threadIdx.x; r <= r1; r += kThreads) {
    const unsigned b = p2_div(r, by_j);
    base[r - r0] = (static_cast<long long>(b) * N + idx[r]) * width;
  }
  __syncthreads();
  W v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned t = t0 + k * kThreads + threadIdx.x;
    if (t < total) {
      const unsigned r = p2_div(t, by_width);
      v[k] = src[base[r - r0] + (t - r * width)];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned t = t0 + k * kThreads + threadIdx.x;
    if (t < total) out[t] = v[k];
  }
}

template <typename W, int K>
cudaError_t launch(const W* src, const int* idx, int B, int N, int J, int width, W* out,
                   cudaStream_t stream) {
  // batch rows a launch takes: its flat words stay below 2^31
  const long long row_words = static_cast<long long>(J) * width;
  const long long rows = kMaxWords / row_words;
  const Divider by_width = make_divider(static_cast<unsigned>(width));
  const Divider by_j = make_divider(static_cast<unsigned>(J));
  for (long long b0 = 0; b0 < B; b0 += rows) {
    const long long nb = B - b0 < rows ? B - b0 : rows;
    const unsigned total = static_cast<unsigned>(nb * row_words);
    const unsigned blocks = (total + K * kThreads - 1) / (K * kThreads);
    gather_kernel<W, K><<<blocks, kThreads, 0, stream>>>(
        src + b0 * N * width, idx + b0 * J, N, width, by_width, by_j, total, out + b0 * row_words);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename W>
cudaError_t dispatch(const void* src, const int* idx, int B, int N, int J, int width, int per_thread,
                     void* out, cudaStream_t s) {
  const W* p = static_cast<const W*>(src);
  W* o = static_cast<W*>(out);
  switch (per_thread) {
    case 1: return launch<W, 1>(p, idx, B, N, J, width, o, s);
    case 2: return launch<W, 2>(p, idx, B, N, J, width, o, s);
    case 4: return launch<W, 4>(p, idx, B, N, J, width, o, s);
    case 8: return launch<W, kMaxPerThread>(p, idx, B, N, J, width, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src (B, N, C) and out (B, J, C) are words of esize bytes: 4 (float32,
// int32, or bfloat16 lane pairs) or 2 (bfloat16); idx holds int32 indices
// that the caller guarantees lie in [0, N). With esize 4, vec 4 moves
// 16-byte words (C % 4 == 0, src and out 16-byte aligned), vec 1 4-byte
// ones; esize 2 takes vec 1. per_thread (1, 2, 4 or 8) words a thread:
// gather_kernel.plan(). device: the card that holds the tensors.
extern "C" int p2_gather(const void* src, const int* idx, int B, int N, int J, int C, int vec,
                         int per_thread, int esize, void* out, int device, void* stream) {
  if (static_cast<long long>(B) * J * C <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || (esize != 4 && esize != 2) || (vec != 1 && (vec != 4 || esize != 4)) ||
      C % vec != 0 ||
      static_cast<long long>(J) * (C / vec) > kMaxWords ||
      (vec == 4 && (reinterpret_cast<std::uintptr_t>(src) % 16 != 0 ||
                    reinterpret_cast<std::uintptr_t>(out) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p2_on_device(device, [&] {
    if (esize == 2) return dispatch<unsigned short>(src, idx, B, N, J, C, per_thread, out, s);
    return vec == 4 ? dispatch<uint4>(src, idx, B, N, J, C / 4, per_thread, out, s)
                    : dispatch<unsigned>(src, idx, B, N, J, C, per_thread, out, s);
  }));
}
