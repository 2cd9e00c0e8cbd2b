// Squared distance in the exact difference form shared by every point op:
// ((dx*dx + dy*dy) + dz*dz), each operation rounded on its own. The explicit
// __f*_rn intrinsics keep nvcc from contracting a*b+c into an fma, which
// would move d^2 by an ulp and flip radius membership and argmin/argmax ties
// against the plain PyTorch versions and the JAX package. The build also
// passes -fmad=false, so plain float arithmetic in these sources never fuses.
#pragma once

__device__ __forceinline__ float p2_sqdist(float ax, float ay, float az,
                                           float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float p2_sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}
