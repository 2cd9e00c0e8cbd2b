// Furthest-point sampling: one block per batch row, or, for rows larger than
// one block takes, one thread-block cluster per batch row.
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
// cluster of 2, 4 or 8 blocks that each held it took 1.03-1.84 µs a step:
// an exchange between multiprocessors cost ~0.7 µs a step, more than it
// saved at that size (PERF.md).
//
// fps_cluster_kernel splits a larger row over a cluster of up to 8 blocks
// (the portable cluster size; fps_kernel.plan takes 8), block r holding
// points [r * share, (r + 1) * share) in shared memory. Where the share
// allows (up to 8192 float32 or 4096 float64 points a block, so up to
// 65536 / 32768 a row in 8 blocks), each thread keeps its 8 float32 or 4
// float64 points in registers and takes fps_kernel's update; larger rows,
// up to 131072 / 65536 points, read twice as many from shared memory. A
// step: the update; the block's
// candidate as fps_kernel finds it (redux keys, one __syncthreads), tagged
// with its global index and the block's rank; then the exchange
// (p2_exchange in fps_step.cuh): lane r of warp 0 sends the block's key
// and point into block r with st.async, which counts the bytes on block
// r's transaction barrier (mbarrier), and every warp waits on its own
// block's barrier and reduces the csize keys itself, taking the winner's
// point from its record. No cluster barrier runs inside the loop. On the
// H100 that exchange took 0.76-0.82 µs a step at 3-8 blocks, against
// 1.50-2.57 for every warp's key pushed through distributed shared memory
// under one cluster barrier a step and 1.35-1.44 for one key a block under
// it (fps_probe.cu kinds 10, 6 and 9; PERF.md).
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

// Points a thread of fps_cluster_kernel keeps in registers: 8 float32 or 4
// float64 (their min-distances beside them, no spills); twice that reads
// them from shared memory.
template <typename T>
constexpr int kRegPoints = sizeof(T) == 4 ? 8 : 4;

template <typename T, int PPT>
__global__ void __launch_bounds__(kMaxThreads, 1)  // one block an SM: up to 64 registers a thread
    fps_cluster_kernel(const T* __restrict__ xyz, int N, int share, int npoint,
                       int skip_near_origin, int* __restrict__ out) {
  constexpr bool kRegs = PPT <= kRegPoints<T>;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char p2_fps_smem[];
  T* sx = reinterpret_cast<T*>(p2_fps_smem);
  T* sy = sx + share;
  T* sz = sy + share;
  __shared__ Best<T> slots[2][32];
  __shared__ __align__(16) P2Exchange<T> ex;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const long long b = blockIdx.x / csize;
  const int base = rank * share;
  const int count = min(share, N - base);
  const T* row = xyz + b * N * 3;
  const T* src = row + static_cast<long long>(base) * 3;
  int* dst = out + b * npoint;

  p2_exchange_init(ex);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    sx[i] = src[3 * i];
    sy[i] = src[3 * i + 1];
    sz[i] = src[3 * i + 2];
  }
  __syncthreads();
  T mind[PPT];
  T rx[kRegs ? PPT : 1], ry[kRegs ? PPT : 1], rz[kRegs ? PPT : 1];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const T x = i < count ? sx[i] : T(0);
    const T y = i < count ? sy[i] : T(0);
    const T z = i < count ? sz[i] : T(0);
    mind[k] = i < count ? p2_start_distance(x, y, z, skip_near_origin) : Num<T>::neg_inf();
    if constexpr (kRegs) {
      rx[k] = x;
      ry[k] = y;
      rz[k] = z;
    }
  }
  if (rank == 0 && threadIdx.x == 0) dst[0] = 0;
  cluster.sync();  // every block runs, its barriers set up, before any record is sent

  T px = row[0], py = row[1], pz = row[2];
  for (int j = 1; j < npoint; ++j) {
    T bv = Num<T>::neg_inf();
    int bi = kP2NoIndex;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if constexpr (kRegs) {  // past count: -inf stays -inf and never wins
        const T m = Num<T>::min(mind[k], p2_sqdist(rx[k], ry[k], rz[k], px, py, pz));
        mind[k] = m;
        if (m > bv) {
          bv = m;
          bi = i;
        }
      } else if (i < count) {
        const T m = Num<T>::min(mind[k], p2_sqdist(sx[i], sy[i], sz[i], px, py, pz));
        mind[k] = m;
        if (m > bv) {
          bv = m;
          bi = i;
        }
      }
    }
    // the block's candidate, as fps_kernel reduces a step (one barrier)
    Best<T> c = Best<T>::make(bv, bi == kP2NoIndex ? kP2NoIndex : (base + bi) << kP2SlotBits | rank);
    c.warp_reduce();
    if (lane == 0) slots[j & 1][warp] = c;
    __syncthreads();
    Best<T> w = lane < nwarps ? slots[j & 1][lane] : Best<T>::none();
    w.warp_reduce();
    P2Vec4<T> p;
    const int win = p2_exchange(ex, j, rank, csize, w, sx, sy, sz, base, p);
    px = p.x;
    py = p.y;
    pz = p.z;
    if (rank == 0 && threadIdx.x == 0) dst[j] = win >> kP2SlotBits;
  }
  cluster.sync();  // no block leaves while another may still send into it
}

template <typename T, int PPT>
cudaError_t launch_block(const T* xyz, int B, int N, int npoint, int skip, int threads, int* out,
                         cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(T);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  static int allowed[kP2MaxDevices] = {};
  cudaError_t err = p2_allow_smem(fps_kernel<T, PPT>, smem, allowed);
  if (err != cudaSuccess) return err;
  fps_kernel<T, PPT><<<B, threads, smem, stream>>>(xyz, N, npoint, skip, out);
  return cudaGetLastError();
}

// The cluster launch of B rows: B clusters of `cluster` blocks. With out
// null, stores in *clusters how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) instead of launching.
template <typename T, int PPT>
cudaError_t launch_cluster(const T* xyz, int B, int N, int npoint, int skip, int cluster, int threads,
                           int* out, cudaStream_t stream, int* clusters) {
  const int share = (N + cluster - 1) / cluster;
  const size_t smem = static_cast<size_t>(share) * 3 * sizeof(T);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
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
  if (out == nullptr) return cudaOccupancyMaxActiveClusters(clusters, fps_cluster_kernel<T, PPT>, &cfg);
  // a stream capture records this launch, cluster dimension included, as a
  // kernel node (the fused train steps' CUDA graphs at rows past 16384)
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<T, PPT>, xyz, N, share, npoint, skip, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xyz, int B, int N, int npoint, int skip, int cluster, int threads,
                     int ppt, int* out, cudaStream_t s, int* clusters = nullptr) {
  const T* p = static_cast<const T*>(xyz);
  constexpr int kR = kRegPoints<T>;
  if (cluster > 1) {  // registers (kR a thread) or shared memory (2 kR)
    if (ppt == kR) return launch_cluster<T, kR>(p, B, N, npoint, skip, cluster, threads, out, s, clusters);
    if (ppt == 2 * kR) {
      return launch_cluster<T, 2 * kR>(p, B, N, npoint, skip, cluster, threads, out, s, clusters);
    }
    return cudaErrorInvalidValue;
  }
  switch (ppt) {
    case 1: return launch_block<T, 1>(p, B, N, npoint, skip, threads, out, s);
    case 2: return launch_block<T, 2>(p, B, N, npoint, skip, threads, out, s);
    case 4: return launch_block<T, 4>(p, B, N, npoint, skip, threads, out, s);
    case 8: return launch_block<T, 8>(p, B, N, npoint, skip, threads, out, s);
    case 16:
      if constexpr (sizeof(T) == 4) {
        return launch_block<T, 16>(p, B, N, npoint, skip, threads, out, s);
      } else {
        return cudaErrorInvalidValue;  // 8 float64 points a thread fill shared memory
      }
    default: return cudaErrorInvalidValue;
  }
}

// the launch shape p2_fps and p2_fps_clusters take
bool valid_shape(int N, int cluster, int threads, int ppt) {
  return N > 0 && cluster >= 1 && cluster <= kMaxCluster && cluster <= N && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 &&
         static_cast<long long>(threads) * ppt >= (N + cluster - 1) / cluster;
}

}  // namespace

// xyz (B, N, 3) float32 (f64 = 0) or float64 (f64 = 1); out (B, npoint)
// int32. cluster, threads and ppt (points per thread) come from
// fps_kernel.plan(): cluster 1 runs fps_kernel (ppt 1, 2, 4, 8, or 16 in
// float32), more runs fps_cluster_kernel with ceil(N / cluster) points a
// block (ppt 8 or 16 in float32, 4 or 8 in float64); threads * ppt must
// cover that share and its coordinates fit in shared memory. device: the
// card that holds the tensors.
extern "C" int p2_fps(const void* xyz, int B, int N, int npoint, int skip_near_origin, int f64,
                      int cluster, int threads, int ppt, int* out, int device, void* stream) {
  if (B <= 0 || npoint <= 0) return static_cast<int>(cudaSuccess);
  if (!valid_shape(N, cluster, threads, ppt) || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p2_on_device(device, [&] {
    return f64 ? dispatch<double>(xyz, B, N, npoint, skip_near_origin, cluster, threads, ppt, out, s)
               : dispatch<float>(xyz, B, N, npoint, skip_near_origin, cluster, threads, ppt, out, s);
  }));
}

// How many clusters of fps_cluster_kernel at that launch shape (cluster >
// 1) the card holds at once, into *clusters: 0 where none fits.
extern "C" int p2_fps_clusters(int f64, int N, int cluster, int threads, int ppt, int device,
                               int* clusters) {
  if (!valid_shape(N, cluster, threads, ppt) || cluster < 2 || clusters == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *clusters = 0;
  return static_cast<int>(p2_on_device(device, [&] {
    return f64 ? dispatch<double>(nullptr, 1, N, 1, 0, cluster, threads, ppt, nullptr, nullptr, clusters)
               : dispatch<float>(nullptr, 1, N, 1, 0, cluster, threads, ppt, nullptr, nullptr, clusters);
  }));
}

extern "C" const char* p2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
