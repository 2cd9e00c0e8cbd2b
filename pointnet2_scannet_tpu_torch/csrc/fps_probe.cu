// Timing probes of one furthest-point-sampling step (float32, 8 points a
// thread), for ops/cuda/profile_scatter.py: each kernel runs npoint-1 steps
// that keep only one part of a step of fps.cu's kernels, so the profile
// reads that part's time a step on its own.
//   0  the earlier one-block kernel's distance update: points read from
//      shared memory
//   1  its block reduction: a shuffle argmax a warp, two barriers and a
//      second argmax in warp 0
//   2  the earlier cluster kernel's exchange: one candidate a block, the
//      cluster barrier, distributed shared-memory reads and a shuffle argmax
//   3  fps_kernel's distance update: points in registers
//   4  fps_kernel's reduction: redux.sync keys, one barrier
//   5  the exchange of a row split over a cluster of blocks that each
//      hold it: every warp's key pushed into every block, one cluster
//      barrier (a design measured slower than one block a row, PERF.md)
//   6  every warp's key and point pushed into every block, one cluster
//      barrier, every warp reducing the cluster's csize x warps keys, up to
//      8 blocks of 1024 (a design measured slower than kind 10, PERF.md)
//   7  kind 4 with the cluster barrier in place of __syncthreads (1 block)
//   8  a block reduction (kind 4), then warp 0 pushes the block's key and
//      point into every block with a cluster-scope release store, and
//      every warp polls the csize keys (acquire loads) until this step's
//      have come: no cluster barrier
//   9  a block reduction (kind 4), then warp 0 pushes the block's key and
//      point into every block (p2_push), one cluster barrier, every warp
//      reducing the csize keys
//  10  fps_cluster_kernel's exchange (p2_exchange in fps_step.cuh): a block
//      reduction (kind 4), then warp 0 pushes the block's key and point
//      into every block with st.async, which counts its bytes on that
//      block's transaction barrier; every warp waits on its own block's
//      barrier: no cluster barrier
// A step's pick depends on the thread's own result (0, 3) or on the
// reduction's (1, 2, 4-10), so steps cannot overlap, and thread 0 of the
// first block writes it to out (B, npoint) as fps_kernel does. A block's
// points (threads * 8) are a power of two, so a pick wraps with a mask. The update
// probes' picks are no FPS; only their times mean anything.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_step.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPPT = 8;
constexpr int kP2MaxSlots = 1 << kP2SlotBits;  // 8 blocks of 32 warps

template <typename T>
struct P2Point {
  T x, y, z;
};

// A step's candidates, double-buffered by step parity: slot s of buffer b
// holds warp s's key and point, pushed there by that warp.
template <typename T>
struct P2Slots {
  Best<T> key[2][kP2MaxSlots];
  P2Point<T> pt[2][kP2MaxSlots];
};

// Kinds 6 and 9: lane r < csize of the warp stores its key and point into
// slot `slot` of buffer buf in block r of the cluster (distributed shared
// memory).
template <typename T>
__device__ __forceinline__ void p2_push(P2Slots<T>& s, int buf, int slot, const Best<T>& key,
                                        const P2Point<T>& pt, int csize) {
  const unsigned lane = threadIdx.x & 31;
  if (lane < static_cast<unsigned>(csize)) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    *cluster.map_shared_rank(&s.key[buf][slot], lane) = key;
    *cluster.map_shared_rank(&s.pt[buf][slot], lane) = pt;
  }
}

// Every thread of the cluster arrives (its stores released) and waits (the
// others' acquired): the one barrier of a step.
__device__ __forceinline__ void p2_cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The step's winner among the nslots keys of buffer buf, read a few a lane
// and reduced over the warp, in every lane: its tag, and its point.
template <typename T>
__device__ __forceinline__ int p2_pick(const P2Slots<T>& s, int buf, int nslots, P2Point<T>& pt) {
  const int lane = threadIdx.x & 31;
  Best<T> w = Best<T>::none();
#pragma unroll
  for (int r = 0; r < kP2MaxSlots / 32; ++r) {
    if (lane + 32 * r < nslots) w.take(s.key[buf][lane + 32 * r]);
  }
  w.warp_reduce();
  const int tag = w.index();
  pt = s.pt[buf][tag & (kP2MaxSlots - 1)];
  return tag;
}

// Kind 8's stores and loads: a plain store into another block's shared
// memory, one with cluster-scope release, and a load of the block's own
// with cluster-scope acquire.
__device__ __forceinline__ void p2_st_cluster(unsigned addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}
__device__ __forceinline__ void p2_st_release(unsigned addr, unsigned long long v) {
  asm volatile("st.release.cluster.shared::cluster.b64 [%0], %1;" :: "r"(addr), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long p2_ld_acquire(unsigned addr) {
  unsigned long long v;
  asm volatile("ld.acquire.cluster.shared::cta.b64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}

struct ProbeCandidate {
  float v;
  int i;
  float x, y, z;
};

// a value in [0, 2^20) that depends on the thread, the step and the last pick
__device__ __forceinline__ float probe_value(int j, int last) {
  return static_cast<float>(((threadIdx.x ^ static_cast<unsigned>(last)) * 2654435761u +
                             static_cast<unsigned>(j) * 40503u) >> 12);
}

template <int kKind>
__global__ void __launch_bounds__(1024)
    probe_kernel(const float* __restrict__ xyz, int npoint, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char p2_probe_smem[];
  const int n = blockDim.x * kPPT;  // the block's points
  float* sx = reinterpret_cast<float*>(p2_probe_smem);
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;
  __shared__ ProbeCandidate cand[2];
  __shared__ Best<float> slots[2][32];
  __shared__ __align__(16) P2Slots<float> xslots;
  __shared__ __align__(16) unsigned long long ckey[2][8];
  __shared__ __align__(16) float4 cpt[2][8];
  __shared__ __align__(16) P2Exchange<float> ex;
  if constexpr (kKind == 8) {
    if (threadIdx.x < 16) ckey[threadIdx.x >> 3][threadIdx.x & 7] = 0ull;  // step mark 0
  }
  if constexpr (kKind == 10) p2_exchange_init(ex);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int rank = 0;
  int csize = 1;
  if constexpr (kKind == 2 || kKind >= 5) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    csize = static_cast<int>(cg::this_cluster().num_blocks());
  }
  const float* row = xyz + static_cast<long long>(blockIdx.x / csize) * n * 3;
  int* dst = out + static_cast<long long>(blockIdx.x / csize) * npoint;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = row[3 * i];
    sy[i] = row[3 * i + 1];
    sz[i] = row[3 * i + 2];
  }
  if constexpr (kKind == 2 || kKind >= 5) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  float mind[kPPT], rx[kPPT], ry[kPPT], rz[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    mind[k] = 1e10f;
    rx[k] = sx[i];
    ry[k] = sy[i];
    rz[k] = sz[i];
  }
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    if constexpr (kKind == 0 || kKind == 3) {
      float bv;
      int bi;
      if constexpr (kKind == 0) {
        p2_step(sx, sy, sz, n, sx[last], sy[last], sz[last], mind, bv, bi);
      } else {
        const float px = sx[last], py = sy[last], pz = sz[last];
        bv = -CUDART_INF_F;
        bi = kP2NoIndex;
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          const float m = fminf(mind[k], p2_sqdist(rx[k], ry[k], rz[k], px, py, pz));
          mind[k] = m;
          if (m > bv) {
            bv = m;
            bi = threadIdx.x + k * blockDim.x;
          }
        }
      }
      last = (bi + j * 7919) & (n - 1);
    } else if constexpr (kKind == 1) {
      float bv = probe_value(j, last);
      int bi = threadIdx.x;
      p2_warp_argmax(bv, bi);
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bv = lane < nwarps ? red_v[lane] : -CUDART_INF_F;
        bi = lane < nwarps ? red_i[lane] : kP2NoIndex;
        p2_warp_argmax(bv, bi);
        if (lane == 0) s_last = bi;
      }
      __syncthreads();
      last = s_last;
    } else if constexpr (kKind == 2) {
      const int slot = j & 1;
      if (threadIdx.x == 0) {
        cand[slot].v = probe_value(j, last);
        cand[slot].i = rank;
        cand[slot].x = cand[slot].y = cand[slot].z = static_cast<float>(rank);
      }
      cg::this_cluster().sync();
      float cv = -CUDART_INF_F, cx = 0.f, cy = 0.f, cz = 0.f;
      int ci = kP2NoIndex;
      if (lane < csize) {
        const auto* c = cg::this_cluster().map_shared_rank(&cand[slot], lane);
        cv = c->v;
        ci = c->i;
        cx = c->x;
        cy = c->y;
        cz = c->z;
      }
      float wv = cv;
      int wi = ci;
      p2_warp_argmax_all(wv, wi);
      const int from = __ffs(__ballot_sync(0xffffffffu, lane < csize && ci == wi)) - 1;
      const float px = __shfl_sync(0xffffffffu, cx, from);
      const float py = __shfl_sync(0xffffffffu, cy, from);
      const float pz = __shfl_sync(0xffffffffu, cz, from);
      last = wi + (px + py + pz > 1e30f);
    } else if constexpr (kKind == 6) {
      const int me = rank * nwarps + warp;
      Best<float> c = Best<float>::make(
          probe_value(j, last), (rank * blockDim.x + threadIdx.x) << kP2SlotBits | me);
      c.warp_reduce();
      const int l = (c.index() >> kP2SlotBits) & (n - 1);
      p2_push(xslots, j & 1, me, c, P2Point<float>{sx[l], sy[l], sz[l]}, csize);
      p2_cluster_barrier();
      P2Point<float> p;
      const int tag = p2_pick(xslots, j & 1, csize * nwarps, p);
      last = ((tag >> kP2SlotBits) + (p.x + p.y + p.z > 1e30f)) & (n - 1);
    } else if constexpr (kKind == 9 || kKind == 10) {
      const int buf = j & 1;
      Best<float> c = Best<float>::make(
          probe_value(j, last), (rank * blockDim.x + threadIdx.x) << kP2SlotBits | rank);
      c.warp_reduce();
      if (lane == 0) slots[buf][warp] = c;
      __syncthreads();
      Best<float> w = lane < nwarps ? slots[buf][lane] : Best<float>::none();
      w.warp_reduce();
      P2Point<float> p;
      int tag;
      if constexpr (kKind == 9) {
        const int l = (w.index() >> kP2SlotBits) & (n - 1);
        if (warp == 0) p2_push(xslots, buf, rank, w, P2Point<float>{sx[l], sy[l], sz[l]}, csize);
        p2_cluster_barrier();
        tag = p2_pick(xslots, buf, csize, p);
      } else {
        P2Vec4<float> q;
        tag = p2_exchange(ex, j, rank, csize, w, sx, sy, sz, rank * blockDim.x, q);
        p = P2Point<float>{q.x, q.y, q.z};
      }
      last = ((tag >> kP2SlotBits) + (p.x + p.y + p.z > 1e30f)) & (n - 1);
    } else if constexpr (kKind == 8) {
      const int buf = j & 1;
      const unsigned mark = static_cast<unsigned>(j & 127) << 25;
      Best<float> c = Best<float>::make(
          probe_value(j, last), (rank * blockDim.x + threadIdx.x) << kP2SlotBits | rank);
      c.warp_reduce();
      if (lane == 0) slots[buf][warp] = c;
      __syncthreads();
      Best<float> w = lane < nwarps ? slots[buf][lane] : Best<float>::none();
      w.warp_reduce();
      if (warp == 0 && lane < csize) {
        const int l = (w.index() >> kP2SlotBits) & (n - 1);
        p2_st_cluster(p2_mapa(p2_smem(&cpt[buf][rank]), lane), make_float4(sx[l], sy[l], sz[l], 0.f));
        p2_st_release(p2_mapa(p2_smem(&ckey[buf][rank]), lane),
                      static_cast<unsigned long long>(w.hi) << 32 | (w.lo & 0x01ffffffu) | mark);
      }
      Best<float> k = Best<float>::none();
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < csize) {
        unsigned long long v = 0;
        for (int spin = 0; spin < (1 << 16); ++spin) {  // a bound: no hang on a fault
          v = p2_ld_acquire(p2_smem(&ckey[buf][lane]));
          if ((static_cast<unsigned>(v) & 0xfe000000u) == mark) break;
        }
        k = Best<float>{static_cast<unsigned>(v >> 32), static_cast<unsigned>(v) | 0xfe000000u};
        q = cpt[buf][lane];
      }
      k.warp_reduce();
      const int from = k.index() & ((1 << kP2SlotBits) - 1);
      const float px = __shfl_sync(0xffffffffu, q.x, from);
      const float py = __shfl_sync(0xffffffffu, q.y, from);
      const float pz = __shfl_sync(0xffffffffu, q.z, from);
      last = ((k.index() >> kP2SlotBits) + (px + py + pz > 1e30f)) & (n - 1);
    } else {  // 4, 5, 7
      Best<float> c = Best<float>::make(probe_value(j, last), rank * blockDim.x + threadIdx.x);
      if constexpr (kKind == 4 || kKind == 7) {
        c.warp_reduce();
        if (lane == 0) slots[j & 1][warp] = c;
        if constexpr (kKind == 4) {
          __syncthreads();
        } else {
          p2_cluster_barrier();
        }
      } else {  // the warp's key, pushed after its reduction
        Best<float>* slot = &slots[j & 1][rank * nwarps + warp];
        if (lane < csize) *cg::this_cluster().map_shared_rank(slot, lane) = c;
        cg::this_cluster().sync();
      }
      Best<float> w = lane < csize * nwarps ? slots[j & 1][lane] : Best<float>::none();
      w.warp_reduce();
      last = w.index() & (n - 1);
    }
    if (rank == 0 && threadIdx.x == 0) dst[j] = last;
  }
  if constexpr (kKind == 2 || kKind == 6 || kKind >= 8) cg::this_cluster().sync();
}

template <int kKind>
cudaError_t launch(const float* xyz, int B, int npoint, int cluster, int threads, int* out,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(threads) * kPPT * 3 * sizeof(float);
  static int allowed[kP2MaxDevices] = {};
  cudaError_t err = p2_allow_smem(probe_kernel<kKind>, smem, allowed);
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
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, probe_kernel<kKind>, xyz, npoint, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// kind 0-10 (above); xyz (B, threads * 8, 3) float32: every block of a
// cluster reads its batch row's points; cluster 1 for kinds 0, 1, 3, 4 and
// 7, 1-8 for 2, 6, 8, 9 and 10, 1-4 for 5 (at most 32 warps in all); out
// (B, npoint) int32.
extern "C" int p2_fps_probe(int kind, const float* xyz, int B, int npoint, int cluster,
                            int threads, int* out, void* stream) {
  if (B <= 0 || npoint <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      cluster < 1 || cluster > 8 || (cluster > 1 && (kind < 5 || kind == 7) && kind != 2) ||
      (kind == 5 && cluster * threads > 1024)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(launch<0>(xyz, B, npoint, cluster, threads, out, s));
    case 1: return static_cast<int>(launch<1>(xyz, B, npoint, cluster, threads, out, s));
    case 2: return static_cast<int>(launch<2>(xyz, B, npoint, cluster, threads, out, s));
    case 3: return static_cast<int>(launch<3>(xyz, B, npoint, cluster, threads, out, s));
    case 4: return static_cast<int>(launch<4>(xyz, B, npoint, cluster, threads, out, s));
    case 5: return static_cast<int>(launch<5>(xyz, B, npoint, cluster, threads, out, s));
    case 6: return static_cast<int>(launch<6>(xyz, B, npoint, cluster, threads, out, s));
    case 7: return static_cast<int>(launch<7>(xyz, B, npoint, cluster, threads, out, s));
    case 8: return static_cast<int>(launch<8>(xyz, B, npoint, cluster, threads, out, s));
    case 9: return static_cast<int>(launch<9>(xyz, B, npoint, cluster, threads, out, s));
    case 10: return static_cast<int>(launch<10>(xyz, B, npoint, cluster, threads, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
