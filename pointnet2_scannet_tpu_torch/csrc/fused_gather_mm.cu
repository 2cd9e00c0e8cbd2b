// Row gather fused with the layer-0 matrix product:
// out[b, j, f] = sum over c of w[c, f] * src[b, idx[b, j], c].
//
// Replaces scripts/bench_fused_sa.py:69 (fused_gather_mm), the experiment
// that fuses SA1's layer-0 matmul into the chunk-select VMEM gather. The TPU
// kernel rebuilds each gathered (C, S, 128) tile out of 128-lane selects over
// all N / 128 source chunks, because the TPU has no general gather, then
// runs the C x F multiply-adds on the VPU. This kernel computes the
// function, not that method: the card loads any address.
//
// Bound on the card: bytes. At the script's shape (B 32, N 8192, J 32768,
// C 9, F 32) the output alone is 134 MB, the distinct source rows 9.3 MB and
// the indices 4.2 MB; the 6e8 operations take a fifth of the bytes' time.
// Each index and source word is read from device memory once (the source
// rows of a batch stay in L2), and each output word is written once.
//
// Two routes, which the wrapper's plan() picks:
// - fixed (C and F compiled in: bench_fused_sa's C 9, F 32). Each thread
//   keeps the same 4 output columns for its whole life, so its C x 4 slice
//   of w sits in registers, loaded once: no shared-memory load and no column
//   predicate per output. A tile is 128 rows of one batch row: 32 rows a
//   step (8 threads a row), 4 steps, all the tile's index and source loads
//   issued before its multiply-adds. The 8 threads of a row load its first 8
//   words between them (2 load instructions a warp for 4 rows, not 9) and
//   pass them on by shuffles. A persistent grid (3 blocks an SM, registers
//   capped to fit) walks the B x ceil(J / 128) tiles; offsets are 32-bit
//   within a batch row, and only a batch row's last tile is predicated.
//   Outputs leave in 16-byte stores marked evict-first (st.global.cs): the
//   134 MB stream would otherwise push the source rows out of L2.
// - general (any C x F up to 200 KiB of w): w in shared memory, a grid-stride
//   loop over items of 4 consecutive outputs of a row, one 16-byte store an
//   item where F % 4 == 0 and the output is 16-byte aligned.
//
// Rounding: each output starts at 0 and adds w[c, f] * g[c] for c
// ascending, every multiply and add rounded on its own (__fmul_rn,
// __fadd_rn; the library also builds with -fmad=false). The plain PyTorch
// version adds in the same order, so the two are equal bit for bit (-0.0
// included: 0 + -0 is +0 in both).
#include <cuda_runtime.h>

#include <cstdint>

#include "on_device.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;    // output columns a thread keeps: one 16-byte store
constexpr int kSteps = 4;   // row steps of a fixed-route tile, loaded together
constexpr int kMinBlocks = 3;  // fixed-route blocks resident on an SM
constexpr int kMaxSmemBytes = 200 * 1024;
enum Route { kGeneral = 0, kFixed = 1 };

// One tile of kTile rows of batch row b: rows r0 + u * kStep (u < kSteps)
// for this thread's row lane, its slice of w in wr. kFull: every row of the
// tile lies below J (all but a batch row's last tile), so the index and
// output offsets are immediates and nothing is predicated.
template <int C, int F, bool kVec, bool kFull>
__device__ __forceinline__ void fixed_tile(const float* __restrict__ sb, const int* __restrict__ ib,
                                           float* __restrict__ ob, int r0, int J,
                                           const float (&wr)[C][kCols], int slice) {
  constexpr int kSlices = F / kCols;
  constexpr int kStep = kThreads / kSlices;
  const float* row[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int r = kFull ? r0 + u * kStep : min(r0 + u * kStep, J - 1);
    row[u] = sb + __ldcs(ib + r) * C;
  }
  // the kSlices threads of a row load its first kSlices words between them
  // (one word each) and pass them on by shuffles; the words past them, every
  // thread loads itself
  float mine[kSteps];
  float rest[kSteps][C > kSlices ? C - kSlices : 1];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    mine[u] = kSlices <= C || slice < C ? __ldg(row[u] + slice) : 0.0f;
#pragma unroll
    for (int c = kSlices; c < C; ++c) rest[u][c - kSlices] = __ldg(row[u] + c);
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    float o[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float g = c < kSlices ? __shfl_sync(0xffffffffu, mine[u], c, kSlices) : rest[u][c - kSlices];
#pragma unroll
      for (int k = 0; k < kCols; ++k) o[k] = __fadd_rn(o[k], __fmul_rn(wr[c][k], g));
    }
    if (!kFull && r0 + u * kStep >= J) continue;
    float* dst = ob + (r0 + u * kStep) * F;
    if constexpr (kVec) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) __stcs(dst + k, o[k]);
    }
  }
}

// The fixed route: a persistent grid walks the B x tiles tiles in order,
// each block gridDim.x tiles apart; kMinBlocks blocks fit an SM (registers
// capped at 65536 / (kMinBlocks * kThreads)).
template <int C, int F, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fixed_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                 const float* __restrict__ w, int B, int N, int J, float* __restrict__ out) {
  constexpr int kSlices = F / kCols;  // threads of one output row
  constexpr int kTile = kThreads / kSlices * kSteps;
  static_assert(F % kCols == 0 && 32 % kSlices == 0, "a row's threads lie in one warp");
  const int slice = threadIdx.x % kSlices;
  const int lane_row = threadIdx.x / kSlices;
  float wr[C][kCols];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) wr[c][k] = __ldg(w + c * F + slice * kCols + k);
  }
  const int tiles = (J + kTile - 1) / kTile;
  const int step_b = gridDim.x / tiles, step_t = gridDim.x % tiles;
  int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  while (b < B) {
    const float* sb = src + static_cast<size_t>(b) * N * C;
    const int* ib = idx + static_cast<size_t>(b) * J;
    float* ob = out + static_cast<size_t>(b) * J * F + slice * kCols;
    const int r0 = t * kTile + lane_row;
    if ((t + 1) * kTile <= J) {
      fixed_tile<C, F, kVec, true>(sb, ib, ob, r0, J, wr, slice);
    } else {
      fixed_tile<C, F, kVec, false>(sb, ib, ob, r0, J, wr, slice);
    }
    t += step_t;
    b += step_b;
    if (t >= tiles) {
      t -= tiles;
      ++b;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    general_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                   const float* __restrict__ w, int N, int J, int C, int F, long long items,
                   bool vec, float* __restrict__ out) {
  extern __shared__ float ws[];  // (C, F)
  for (int t = threadIdx.x; t < C * F; t += kThreads) ws[t] = w[t];
  __syncthreads();

  const int slices = (F + kCols - 1) / kCols;  // items of an output row
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       t < items; t += stride) {
    const long long row = t / slices;  // b * J + j
    const int f0 = static_cast<int>(t - row * slices) * kCols;
    const long long b = row / J;
    const float* g = src + (b * N + idx[row]) * C;
    float o[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < C; ++c) {
      const float gc = g[c];
      const float* wc = ws + c * F + f0;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (f0 + k < F) o[k] = __fadd_rn(o[k], __fmul_rn(wc[k], gc));
      }
    }
    float* dst = out + row * F + f0;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
    } else {
      for (int k = 0; k < kCols && f0 + k < F; ++k) __stcs(dst + k, o[k]);
    }
  }
}

int smem_allowed[kP2MaxDevices];

}  // namespace

// src (B, N, C), w (C, F) and out (B, J, F) float32; idx (B, J) int32
// indices that the caller guarantees lie in [0, N). route 0 (general):
// blocks of a grid-stride loop, C * F * 4 <= 200 KiB; route 1 (fixed): C 9
// and F 32 only, N * C, J * F and B * ceil(J / 128) below 2^31, blocks of a
// persistent grid (at most kMinBlocks an SM stay resident). On card
// `device`, made current for the launch.
extern "C" int p2_fused_gather_mm(const float* src, const int* idx, const float* w, int B, int N,
                                  int J, int C, int F, int route, int blocks, float* out, int device,
                                  void* stream) {
  if (B <= 0 || J <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || C <= 0 || blocks <= 0 || (route != kGeneral && route != kFixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = F % kCols == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == kGeneral) {
    const long long smem = static_cast<long long>(C) * F * sizeof(float);
    if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
    const long long items = static_cast<long long>(B) * J * ((F + kCols - 1) / kCols);
    return static_cast<int>(p2_on_device(device, [&] {
      cudaError_t err = p2_allow_smem(general_kernel, smem, smem_allowed);
      if (err != cudaSuccess) return err;
      general_kernel<<<blocks, kThreads, smem, s>>>(src, idx, w, N, J, C, F, items, vec, out);
      return cudaGetLastError();
    }));
  }
  const long long tiles = (J + 127LL) / 128;
  if (C != 9 || F != 32 || static_cast<long long>(N) * C > INT32_MAX ||
      static_cast<long long>(J) * F > INT32_MAX || B * tiles > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(p2_on_device(device, [&] {
    if (vec) {
      fixed_kernel<9, 32, true><<<blocks, kThreads, 0, s>>>(src, idx, w, B, N, J, out);
    } else {
      fixed_kernel<9, 32, false><<<blocks, kThreads, 0, s>>>(src, idx, w, B, N, J, out);
    }
    return cudaGetLastError();
  }));
}
