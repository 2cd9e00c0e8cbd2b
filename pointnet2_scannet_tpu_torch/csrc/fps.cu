// Furthest-point sampling, one block per batch row.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/fps_kernel.py
// (furthest_point_sample_pallas). Contract: index 0 seeds the selection; a
// running min-distance starts at 1e10 (or -1 for points with |p|^2 <= 1e-3
// when skip_near_origin is set, so they are never picked); each of the
// npoint-1 steps lowers it against the last pick and takes the argmax, the
// lowest index winning a tie.
//
// Bound on the card: the npoint-1 steps are sequential and each ends in a
// block-wide argmax, so the kernel is bound by the two __syncthreads of each
// step, not by bytes or FLOPs, and only B blocks run (32 of 132 SMs at the
// serving batch). The design keeps everything on chip for the whole loop:
// xyz in dynamic shared memory (12 N bytes, 96 KiB at N = 8192), each
// thread's min-distances in registers (PPT per thread, strided so neighbour
// threads read neighbour shared-memory words), and one (value, index)
// shuffle reduction per warp before a single cross-warp pass.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kNoIndex = 0x7fffffff;

// (v, i) <- the better of (v, i) and (ov, oi): larger value, then lower index
__device__ __forceinline__ void p2_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void p2_warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    p2_better(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ xyz, int N, int npoint,
               int skip_near_origin, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* src = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  int* dst = out + static_cast<size_t>(blockIdx.x) * npoint;

  for (int i = tid; i < N; i += nthreads) {
    sx[i] = src[3 * i];
    sy[i] = src[3 * i + 1];
    sz[i] = src[3 * i + 2];
  }
  __syncthreads();

  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * nthreads;
    float v = -CUDART_INF_F;  // slots past N never win
    if (i < N) {
      const bool valid =
          !skip_near_origin || p2_sqnorm(sx[i], sy[i], sz[i]) > 1e-3f;
      v = valid ? 1e10f : -1.0f;
    }
    mind[k] = v;
  }
  if (tid == 0) dst[0] = 0;

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float px = sx[last], py = sy[last], pz = sz[last];
    float bv = -CUDART_INF_F;
    int bi = kNoIndex;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * nthreads;
      if (i < N) {
        const float m = fminf(mind[k], p2_sqdist(sx[i], sy[i], sz[i], px, py, pz));
        mind[k] = m;
        if (m > bv) {  // i ascends with k: strict > keeps the lowest index
          bv = m;
          bi = i;
        }
      }
    }
    p2_warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : kNoIndex;
      p2_warp_argmax(bv, bi);
      if (lane == 0) {
        s_last = bi;
        dst[j] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PPT>
cudaError_t launch_fps(const float* xyz, int B, int N, int npoint, int skip,
                       int* out, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<B, threads, smem, stream>>>(xyz, N, npoint, skip, out);
  return cudaGetLastError();
}

}  // namespace

// Points per thread is a compile-time register count: the smallest of
// 1, 2, 4, 8, 16 that covers N with at most 1024 threads (N <= 16384).
extern "C" int p2_fps(const float* xyz, int B, int N, int npoint,
                      int skip_near_origin, int* out, void* stream) {
  if (B <= 0 || npoint <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || N > 16 * kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((N + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int ppt = (N + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ppt <= 1)
    err = launch_fps<1>(xyz, B, N, npoint, skip_near_origin, out, threads, s);
  else if (ppt <= 2)
    err = launch_fps<2>(xyz, B, N, npoint, skip_near_origin, out, threads, s);
  else if (ppt <= 4)
    err = launch_fps<4>(xyz, B, N, npoint, skip_near_origin, out, threads, s);
  else if (ppt <= 8)
    err = launch_fps<8>(xyz, B, N, npoint, skip_near_origin, out, threads, s);
  else
    err = launch_fps<16>(xyz, B, N, npoint, skip_near_origin, out, threads, s);
  return static_cast<int>(err);
}

extern "C" const char* p2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
