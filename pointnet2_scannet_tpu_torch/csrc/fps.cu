// Furthest-point sampling: one block per batch row, or for rows too large
// for one block's shared memory, one thread-block cluster per batch row.
//
// Replaces pointnet2_scannet_tpu/ops/pallas/fps_kernel.py
// (furthest_point_sample_pallas). Contract: index 0 seeds the selection; a
// running min-distance starts at 1e10 (or -1 for points with |p|^2 <= 1e-3
// when skip_near_origin is set, so they are never picked); each of the
// npoint-1 steps lowers it against the last pick and takes the argmax, the
// lowest index winning a tie. float32 and float64 run as two instantiations
// of the same kernels, every operation rounded on its own (sqdist.cuh).
//
// Bound on the card: the npoint-1 steps are sequential and each ends in an
// argmax over the whole row, so the kernel is bound by the synchronisation
// of each step, not by bytes or FLOPs, and only B blocks (or clusters) run.
// The design keeps everything on chip for the whole loop: xyz in dynamic
// shared memory (12 bytes a point in float32, 24 in float64), each thread's
// min-distances in registers (PPT per thread, strided so neighbour threads
// read neighbour shared-memory words), and one (value, index) shuffle
// reduction per warp before a single cross-warp pass.
//
// fps_kernel (one block a row) takes a row that fits one block: 16384
// float32 or 8192 float64 points. fps_cluster_kernel splits a larger row
// over a cluster of up to 8 blocks (the portable cluster size), each
// holding a share of at most that many points, so float32 reaches 131072
// points and float64 65536. Each step: every block reduces its share to a
// candidate (value, index and the point's coordinates) in its own shared
// memory; one cluster barrier; then every warp of every block reads the
// cluster's candidates through distributed shared memory, one a lane, and
// reduces them (larger value, then lower index), so all blocks pick the
// same winner as the plain version and take its coordinates from the
// winning candidate. The candidate slots alternate between two buffers, so
// one cluster barrier a step suffices: a block overwrites the slot of step
// j only after every block has passed the barrier of step j + 1, that is,
// after every block has read step j's candidates.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "smem_limit.cuh"
#include "sqdist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kNoIndex = 0x7fffffff;
constexpr size_t kMaxSmemBytes = 227 * 1024;

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

// the warp's best (v, i) in lane 0
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

// Loads count points of src (x, y, z interleaved) into sx, sy, sz and sets
// each thread's min-distances: 1e10, -1 near the origin under skip, -inf
// past count (never wins).
template <typename T, int PPT>
__device__ __forceinline__ void p2_load_share(const T* src, int count, int skip,
                                              T* sx, T* sy, T* sz, T (&mind)[PPT]) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < count; i += nthreads) {
    sx[i] = src[3 * i];
    sy[i] = src[3 * i + 1];
    sz[i] = src[3 * i + 2];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * nthreads;
    T v = Num<T>::neg_inf();
    if (i < count) {
      const bool valid = !skip || p2_sqnorm(sx[i], sy[i], sz[i]) > Num<T>::kNear;
      v = valid ? Num<T>::kFar : T(-1);
    }
    mind[k] = v;
  }
}

// Lowers the thread's min-distances against (px, py, pz) and returns its
// best (value, local index); i ascends with k, so strict > keeps the lowest.
template <typename T, int PPT>
__device__ __forceinline__ void p2_step(const T* sx, const T* sy, const T* sz, int count,
                                        T px, T py, T pz, T (&mind)[PPT], T& bv, int& bi) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  bv = Num<T>::neg_inf();
  bi = kNoIndex;
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

template <typename T, int PPT>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const T* __restrict__ xyz, int N, int npoint,
               int skip_near_origin, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char p2_fps_smem[];
  T* sx = reinterpret_cast<T*>(p2_fps_smem);
  T* sy = sx + N;
  T* sz = sy + N;
  __shared__ T red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* src = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  int* dst = out + static_cast<size_t>(blockIdx.x) * npoint;

  T mind[PPT];
  p2_load_share(src, N, skip_near_origin, sx, sy, sz, mind);
  if (threadIdx.x == 0) dst[0] = 0;

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    T bv;
    int bi;
    p2_step(sx, sy, sz, N, sx[last], sy[last], sz[last], mind, bv, bi);
    p2_warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : Num<T>::neg_inf();
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

template <typename T>
struct Candidate {
  T v;
  int i;
  T x, y, z;
};

template <typename T, int PPT>
__global__ void __launch_bounds__(kMaxThreads)
    fps_cluster_kernel(const T* __restrict__ xyz, int N, int share, int npoint,
                       int skip_near_origin, int* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char p2_fps_smem[];
  T* sx = reinterpret_cast<T*>(p2_fps_smem);
  T* sy = sx + share;
  T* sz = sy + share;
  __shared__ T red_v[32];
  __shared__ int red_i[32];
  __shared__ Candidate<T> cand[2];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const long long b = blockIdx.x / csize;
  const int base = rank * share;
  const int count = min(share, N - base);
  const T* row = xyz + b * N * 3;
  int* dst = out + b * npoint;

  T mind[PPT];
  p2_load_share(row + static_cast<long long>(base) * 3, count, skip_near_origin, sx, sy, sz, mind);
  if (rank == 0 && threadIdx.x == 0) dst[0] = 0;

  T px = row[0], py = row[1], pz = row[2];
  for (int j = 1; j < npoint; ++j) {
    const int slot = j & 1;
    T bv;
    int bi;
    p2_step(sx, sy, sz, count, px, py, pz, mind, bv, bi);
    p2_warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : Num<T>::neg_inf();
      bi = lane < nwarps ? red_i[lane] : kNoIndex;
      p2_warp_argmax(bv, bi);
      if (lane == 0) {
        Candidate<T> c{bv, kNoIndex, T(0), T(0), T(0)};
        if (bi != kNoIndex) c = Candidate<T>{bv, base + bi, sx[bi], sy[bi], sz[bi]};
        cand[slot] = c;
      }
    }
    cluster.sync();
    Candidate<T> c{Num<T>::neg_inf(), kNoIndex, T(0), T(0), T(0)};
    if (lane < csize) c = *cluster.map_shared_rank(&cand[slot], lane);
    T wv = c.v;
    int wi = c.i;
    p2_warp_argmax_all(wv, wi);
    const int from = __ffs(__ballot_sync(0xffffffffu, lane < csize && c.i == wi)) - 1;
    px = __shfl_sync(0xffffffffu, c.x, from);
    py = __shfl_sync(0xffffffffu, c.y, from);
    pz = __shfl_sync(0xffffffffu, c.z, from);
    if (rank == 0 && threadIdx.x == 0) dst[j] = wi;
  }
  cluster.sync();  // no block leaves while another may still read its slots
}

template <typename T, int PPT>
cudaError_t launch_fps(const T* xyz, int B, int N, int npoint, int skip,
                       int cluster, int threads, int* out, cudaStream_t stream) {
  const int share = (N + cluster - 1) / cluster;
  const size_t smem = static_cast<size_t>(share) * 3 * sizeof(T);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (cluster == 1) {
    static int allowed[kP2MaxDevices] = {};
    cudaError_t err = p2_allow_smem(fps_kernel<T, PPT>, smem, allowed);
    if (err != cudaSuccess) return err;
    fps_kernel<T, PPT><<<B, threads, smem, stream>>>(xyz, N, npoint, skip, out);
    return cudaGetLastError();
  }
  static int allowed[kP2MaxDevices] = {};
  cudaError_t err = p2_allow_smem(fps_cluster_kernel<T, PPT>, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<T, PPT>, xyz, N, share, npoint, skip, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xyz, int B, int N, int npoint, int skip,
                     int cluster, int threads, int ppt, int* out, cudaStream_t s) {
  const T* p = static_cast<const T*>(xyz);
  switch (ppt) {
    case 1: return launch_fps<T, 1>(p, B, N, npoint, skip, cluster, threads, out, s);
    case 2: return launch_fps<T, 2>(p, B, N, npoint, skip, cluster, threads, out, s);
    case 4: return launch_fps<T, 4>(p, B, N, npoint, skip, cluster, threads, out, s);
    case 8: return launch_fps<T, 8>(p, B, N, npoint, skip, cluster, threads, out, s);
    case 16:
      if constexpr (sizeof(T) == 4) {
        return launch_fps<T, 16>(p, B, N, npoint, skip, cluster, threads, out, s);
      } else {
        return cudaErrorInvalidValue;  // 8 float64 points a thread fill shared memory
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xyz (B, N, 3) float32 (f64 = 0) or float64 (f64 = 1); out (B, npoint)
// int32. cluster, threads and ppt (points per thread: 1, 2, 4, 8, or 16 in
// float32) come from fps_kernel.plan(): cluster 1 runs fps_kernel, more
// runs fps_cluster_kernel with ceil(N / cluster) points a block; threads *
// ppt must cover that share and its coordinates fit in shared memory.
extern "C" int p2_fps(const void* xyz, int B, int N, int npoint,
                      int skip_near_origin, int f64, int cluster, int threads,
                      int ppt, int* out, void* stream) {
  if (B <= 0 || npoint <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || cluster < 1 || cluster > kMaxCluster || cluster > N ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(threads) * ppt < (N + cluster - 1) / cluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f64 ? dispatch<double>(xyz, B, N, npoint, skip_near_origin, cluster, threads, ppt, out, s)
          : dispatch<float>(xyz, B, N, npoint, skip_near_origin, cluster, threads, ppt, out, s);
  return static_cast<int>(err);
}

extern "C" const char* p2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
