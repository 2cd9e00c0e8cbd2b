// The pieces of one furthest-point-sampling step that fps.cu's kernels and
// fps_probe.cu's timing probes share: the sentinels, the argmax order
// (larger value, then lower index) and its warp reductions.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

constexpr int kP2NoIndex = 0x7fffffff;

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float neg_inf() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static constexpr float kFar = 1e10f;
  static constexpr float kNear = 1e-3f;
};
template <>
struct Num<double> {
  static __device__ __forceinline__ double neg_inf() { return -CUDART_INF; }
  static __device__ __forceinline__ double min(double a, double b) { return fmin(a, b); }
  static constexpr double kFar = 1e10;
  static constexpr double kNear = 1e-3;
};

// (v, i) <- the better of (v, i) and (ov, oi): larger value, then lower index
template <typename T>
__device__ __forceinline__ void p2_better(T& v, int& i, T ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// the warp's best (v, i) in lane 0: 5 rounds of two shuffles and a compare
template <typename T>
__device__ __forceinline__ void p2_warp_argmax(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    p2_better(v, i, ov, oi);
  }
}

// the warp's best (v, i) in every lane
template <typename T>
__device__ __forceinline__ void p2_warp_argmax_all(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    p2_better(v, i, ov, oi);
  }
}

// A candidate of a step, reduced over a warp into every lane. float32 packs
// it into two 32-bit keys that compare as unsigned integers in the argmax
// order: the value's bits made order-preserving (negatives flipped, the sign
// bit set on the rest), then the complement of the index (a lower index is
// a larger key). Two redux.sync maxima reduce it: the first over the value
// keys, the second over the index keys of the lanes that hold that maximum.
// float64 keeps the (value, index) pair and the shuffle reduction.
template <typename T>
struct Best;

template <>
struct Best<float> {
  unsigned hi, lo;
  static __device__ __forceinline__ Best make(float v, int i) {
    const unsigned u = __float_as_uint(v);
    return Best{(u & 0x80000000u) ? ~u : (u | 0x80000000u), ~static_cast<unsigned>(i)};
  }
  static __device__ __forceinline__ Best none() { return Best{0u, 0u}; }
  __device__ __forceinline__ void warp_reduce() {
    const unsigned m = __reduce_max_sync(0xffffffffu, hi);
    lo = __reduce_max_sync(0xffffffffu, hi == m ? lo : 0u);
    hi = m;
  }
  __device__ __forceinline__ int index() const { return static_cast<int>(~lo); }
};

template <>
struct Best<double> {
  double v;
  int i;
  static __device__ __forceinline__ Best make(double v, int i) { return Best{v, i}; }
  static __device__ __forceinline__ Best none() { return Best{-CUDART_INF, kP2NoIndex}; }
  __device__ __forceinline__ void warp_reduce() { p2_warp_argmax_all(v, i); }
  __device__ __forceinline__ int index() const { return i; }
};

// 1e10 for a point that may be picked; -1 for one near the origin under
// skip (never picked while another is left)
template <typename T>
__device__ __forceinline__ T p2_start_distance(T x, T y, T z, int skip) {
  return !skip || p2_sqnorm(x, y, z) > Num<T>::kNear ? Num<T>::kFar : T(-1);
}

// Lowers the thread's min-distances against (px, py, pz), reading its points
// (every blockDim.x-th of count, from threadIdx.x) from shared memory, and
// returns its best (value, local index); i ascends with k, so strict >
// keeps the lowest.
template <typename T, int PPT>
__device__ __forceinline__ void p2_step(const T* sx, const T* sy, const T* sz, int count,
                                        T px, T py, T pz, T (&mind)[PPT], T& bv, int& bi) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  bv = Num<T>::neg_inf();
  bi = kP2NoIndex;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * nthreads;
    if (i < count) {
      const T m = Num<T>::min(mind[k], p2_sqdist(sx[i], sy[i], sz[i], px, py, pz));
      mind[k] = m;
      if (m > bv) {
        bv = m;
        bi = i;
      }
    }
  }
}
