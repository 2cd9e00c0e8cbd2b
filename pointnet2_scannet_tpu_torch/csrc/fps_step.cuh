// The pieces of one furthest-point-sampling step that fps.cu's kernels and
// fps_probe.cu's timing probes share: the sentinels, the argmax order
// (larger value, then lower index), its warp reductions and the cluster
// kernel's exchange of candidates between blocks.
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
  // *this <- the better of *this and o
  __device__ __forceinline__ void take(const Best& o) {
    if (o.hi > hi || (o.hi == hi && o.lo > lo)) *this = o;
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
  __device__ __forceinline__ void take(const Best& o) { p2_better(v, i, o.v, o.i); }
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

// The cluster kernel's exchange. A candidate's index is a tag: its global
// index shifted left by kP2SlotBits, or-ed with the slot that holds its
// point (the rank of its block in the cluster; a warp's, in the probes).
// Indices are unique, so the tag orders ties as the index does.
constexpr int kP2SlotBits = 8;

// Shared memory of the cluster by address (PTX): the shared-window address
// of p, and that address in block `rank`.
__device__ __forceinline__ unsigned p2_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned p2_mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// A transaction barrier (mbarrier) in the block's shared memory, and stores
// into another block that count their bytes on that block's barrier
// (st.async): a phase completes when its one arrival (the expected bytes)
// has come and every byte has landed.
__device__ __forceinline__ void p2_mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void p2_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void p2_mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
}
// Waits until the phase of that parity has completed. A wait that has not
// ended after 2^22 tries (seconds; a step takes about a microsecond) is a
// fault: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void p2_mbar_wait(unsigned bar, unsigned parity) {
  for (int spin = 0; spin < (1 << 22); ++spin) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
  }
  __trap();
}
__device__ __forceinline__ void p2_st_async(unsigned addr, unsigned a, unsigned b, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               :: "r"(addr), "r"(a), "r"(b), "r"(bar) : "memory");
}
__device__ __forceinline__ void p2_st_async(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}
__device__ __forceinline__ void p2_st_async(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}
__device__ __forceinline__ void p2_st_async(unsigned addr, double a, double b, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];"
               :: "r"(addr), "d"(a), "d"(b), "r"(bar) : "memory");
}
__device__ __forceinline__ void p2_st_async(unsigned addr, double a, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];"
               :: "r"(addr), "d"(a), "r"(bar) : "memory");
}

// A block's candidate and its point, as the cluster kernel exchanges them.
template <typename T>
struct alignas(16) P2Vec4 {
  T x, y, z, w;
};

// Sends a block's record (key and point) into the slots key and pt of
// another block (shared::cluster addresses), counted on that block's
// barrier bar: 24 bytes in float32, 40 in float64 (kP2RecordBytes).
__device__ __forceinline__ void p2_send(unsigned key, unsigned pt, unsigned bar, const Best<float>& k,
                                        const P2Vec4<float>& p) {
  p2_st_async(key, k.hi, k.lo, bar);
  p2_st_async(pt, make_float4(p.x, p.y, p.z, 0.f), bar);
}
__device__ __forceinline__ void p2_send(unsigned key, unsigned pt, unsigned bar, const Best<double>& k,
                                        const P2Vec4<double>& p) {
  const unsigned long long v = static_cast<unsigned long long>(__double_as_longlong(k.v));
  p2_st_async(key, make_uint4(static_cast<unsigned>(v), static_cast<unsigned>(v >> 32),
                              static_cast<unsigned>(k.i), 0u), bar);
  p2_st_async(pt, p.x, p.y, bar);
  p2_st_async(pt + 16, p.z, bar);
}
template <typename T>
constexpr unsigned kP2RecordBytes = sizeof(T) == 4 ? 24u : 40u;

// The slots of the exchange, in every block of a cluster of up to 8: per
// step parity, block r's record in key[.][r] and pt[.][r], and the barrier
// that counts the bytes coming into this block.
template <typename T>
struct P2Exchange {
  Best<T> key[2][8];
  P2Vec4<T> pt[2][8];
  unsigned long long bar[2];
};

// Before the cluster's first barrier: both barriers expect one arrival a
// phase, made visible to the cluster.
template <typename T>
__device__ __forceinline__ void p2_exchange_init(P2Exchange<T>& ex) {
  if (threadIdx.x == 0) {
    p2_mbar_init(p2_smem(&ex.bar[0]));
    p2_mbar_init(p2_smem(&ex.bar[1]));
    p2_mbar_init_fence();
  }
}

// Step j (>= 1) of the exchange, every thread of the block, w the block's
// candidate (tag: global index << kP2SlotBits | rank) in every thread and
// its point at local index (tag >> kP2SlotBits) - base of sx, sy, sz.
// Thread 0 makes the step's arrival, expecting csize records; lane r <
// csize of warp 0 sends the block's record into block r; every thread
// waits for its own block's barrier, then each warp reduces the csize keys
// itself. Returns the winner's tag, its point in p. The slots and barrier
// of step j are used again at step j + 2, and a block sends step j + 2's
// record only after it has received step j + 1's from every block, each
// sent after that block's barrier of step j + 1 (__syncthreads), which its
// warps reach only after reading step j's slots.
template <typename T>
__device__ __forceinline__ int p2_exchange(P2Exchange<T>& ex, int j, int rank, int csize, const Best<T>& w,
                                           const T* sx, const T* sy, const T* sz, int base,
                                           P2Vec4<T>& p) {
  const int buf = j & 1;
  const unsigned bar = p2_smem(&ex.bar[buf]);
  if (threadIdx.x == 0) p2_mbar_expect(bar, csize * kP2RecordBytes<T>);
  if (threadIdx.x < static_cast<unsigned>(csize)) {
    const int tag = w.index();
    const int l = tag == kP2NoIndex ? 0 : (tag >> kP2SlotBits) - base;
    const unsigned r = threadIdx.x;
    p2_send(p2_mapa(p2_smem(&ex.key[buf][rank]), r), p2_mapa(p2_smem(&ex.pt[buf][rank]), r),
            p2_mapa(bar, r), w, P2Vec4<T>{sx[l], sy[l], sz[l], T(0)});
  }
  p2_mbar_wait(bar, ((j - 1) >> 1) & 1);
  const int lane = threadIdx.x & 31;
  Best<T> k = lane < csize ? ex.key[buf][lane] : Best<T>::none();
  k.warp_reduce();
  const int win = k.index();
  p = ex.pt[buf][win & ((1 << kP2SlotBits) - 1)];
  return win;
}
