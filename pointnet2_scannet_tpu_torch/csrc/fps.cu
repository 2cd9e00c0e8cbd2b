// Furthest-point sampling: one block per batch row, or, for rows too large
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
// argmax over the whole row, so the kernel is bound by the latency of each
// step (its distance update, then a reduction across the row), not by
// bytes or FLOPs, and only B blocks (or clusters) run.
//
// fps_kernel takes a row that fits one block's shared memory (16384 float32
// or 8192 float64 points). The row's coordinates stay in shared memory for
// the whole loop (to look up each step's winner); a thread's own points sit
// in registers (float32, up to 8 a thread) or are read from shared memory,
// strided so neighbour threads read neighbour words, with its
// min-distances in registers. Each step has one barrier: every warp reduces
// its candidates (Best in fps_step.cuh: two redux.sync in float32) and its
// lane 0 writes the result into its slot of a double-buffered array; after
// the barrier every warp reduces all the slots itself, so all agree on the
// winner with no second barrier. A warp writes the slots of step j + 2 only
// after every warp has passed the barrier of step j + 1, that is, after
// every warp has read step j's. On the H100 this step took 0.83-0.85 µs at
// 8192 points against the earlier design's 1.43 (two barriers, shuffle
// argmaxes, points read from shared memory). The same row split over a
// cluster of 2, 4 or 8 blocks that each held it took 1.03-1.84 µs a step,
// whether the blocks exchanged their keys through a cluster barrier or
// through remote stores and an mbarrier: an exchange between
// multiprocessors cost ~0.7 µs a step, more than it saved (PERF.md).
//
// fps_cluster_kernel splits a larger row over a cluster of up to 8 blocks
// (the portable cluster size), each holding a share of at most 16384
// float32 or 8192 float64 points, so float32 reaches 131072 points and
// float64 65536. Each step: every block reduces its share to a candidate
// (value, index and the point's coordinates) in its own shared memory; one
// cluster barrier; then every warp of every block reads the cluster's
// candidates through distributed shared memory, one a lane, and reduces
// them (larger value, then lower index), taking the winner's coordinates
// from its candidate. The candidate slots alternate between two buffers, so
// one cluster barrier a step suffices, as above.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_step.cuh"
#include "on_device.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr size_t kMaxSmemBytes = 227 * 1024;

template <typename T, int PPT>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const T* __restrict__ xyz, int N, int npoint, int skip_near_origin,
               int* __restrict__ out) {
  constexpr bool kRegs = sizeof(T) == 4 && PPT <= 8;  // points in registers
  extern __shared__ __align__(16) unsigned char p2_fps_smem[];
  T* sx = reinterpret_cast<T*>(p2_fps_smem);
  T* sy = sx + N;
  T* sz = sy + N;
  __shared__ Best<T> slots[2][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* row = xyz + static_cast<long long>(blockIdx.x) * N * 3;
  int* dst = out + static_cast<long long>(blockIdx.x) * npoint;

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sx[i] = row[3 * i];
    sy[i] = row[3 * i + 1];
    sz[i] = row[3 * i + 2];
  }
  __syncthreads();
  T mind[PPT];
  T rx[kRegs ? PPT : 1], ry[kRegs ? PPT : 1], rz[kRegs ? PPT : 1];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const T x = i < N ? sx[i] : T(0);
    const T y = i < N ? sy[i] : T(0);
    const T z = i < N ? sz[i] : T(0);
    mind[k] = i < N ? p2_start_distance(x, y, z, skip_near_origin) : Num<T>::neg_inf();
    if constexpr (kRegs) {
      rx[k] = x;
      ry[k] = y;
      rz[k] = z;
    }
  }
  if (threadIdx.x == 0) dst[0] = 0;

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const T px = sx[last], py = sy[last], pz = sz[last];
    T bv = Num<T>::neg_inf();
    int bi = kP2NoIndex;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if constexpr (kRegs) {  // past N: -inf stays -inf and never wins
        const T m = Num<T>::min(mind[k], p2_sqdist(rx[k], ry[k], rz[k], px, py, pz));
        mind[k] = m;
        if (m > bv) {
          bv = m;
          bi = i;
        }
      } else if (i < N) {
        const T m = Num<T>::min(mind[k], p2_sqdist(sx[i], sy[i], sz[i], px, py, pz));
        mind[k] = m;
        if (m > bv) {
          bv = m;
          bi = i;
        }
      }
    }
    Best<T> c = Best<T>::make(bv, bi);
    c.warp_reduce();
    if (lane == 0) slots[j & 1][warp] = c;
    __syncthreads();
    Best<T> w = lane < nwarps ? slots[j & 1][lane] : Best<T>::none();
    w.warp_reduce();
    last = w.index();
    if (threadIdx.x == 0) dst[j] = last;
  }
}

template <typename T>
struct Candidate {
  T v;
  int i;
  T x, y, z;
};

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
    mind[k] = i < count ? p2_start_distance(sx[i], sy[i], sz[i], skip) : Num<T>::neg_inf();
  }
}

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
      bi = lane < nwarps ? red_i[lane] : kP2NoIndex;
      p2_warp_argmax(bv, bi);
      if (lane == 0) {
        Candidate<T> c{bv, kP2NoIndex, T(0), T(0), T(0)};
        if (bi != kP2NoIndex) c = Candidate<T>{bv, base + bi, sx[bi], sy[bi], sz[bi]};
        cand[slot] = c;
      }
    }
    cluster.sync();
    Candidate<T> c{Num<T>::neg_inf(), kP2NoIndex, T(0), T(0), T(0)};
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
cudaError_t launch_fps(const T* xyz, int B, int N, int npoint, int skip, int cluster, int threads,
                       int* out, cudaStream_t stream) {
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
  // a stream capture records this launch, cluster dimension included, as a
  // kernel node (the fused train steps' CUDA graphs at rows past 16384)
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<T, PPT>, xyz, N, share, npoint, skip, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xyz, int B, int N, int npoint, int skip, int cluster, int threads,
                     int ppt, int* out, cudaStream_t s) {
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
// device: the card that holds the tensors.
extern "C" int p2_fps(const void* xyz, int B, int N, int npoint, int skip_near_origin, int f64,
                      int cluster, int threads, int ppt, int* out, int device, void* stream) {
  if (B <= 0 || npoint <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || cluster < 1 || cluster > kMaxCluster || cluster > N ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(threads) * ppt < (N + cluster - 1) / cluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p2_on_device(device, [&] {
    return f64 ? dispatch<double>(xyz, B, N, npoint, skip_near_origin, cluster, threads, ppt, out, s)
               : dispatch<float>(xyz, B, N, npoint, skip_near_origin, cluster, threads, ppt, out, s);
  }));
}

extern "C" const char* p2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
