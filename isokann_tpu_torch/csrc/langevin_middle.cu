// Whole LangevinMiddle trajectories for small vacuum systems, one CUDA
// thread per walker.
//
// Replaces the TPU kernel isokann_tpu/md/pallas_md.py:langevin_middle_fused
// (with its forces from make_force_parts and the polynomial _atan2).  It
// computes what that kernel computes -- each step a kick F/m, a half drift,
// an O-step a = exp(-gamma dt) with Gaussian noise, and a half drift, with
// harmonic bonds, harmonic angles, periodic torsions and all-pairs LJ +
// Coulomb (exclusion / 1-4 scales folded into the pair table, reaction field
// inside the cutoff for unscaled pairs, minimum image when periodic) -- but
// not how: the TPU version turned every term into difference-operator
// matmuls (D @ X, D^T g) for its matrix unit.  Here each term is evaluated
// directly, by compute_forces in md_forces.cuh (shared with the Girsanov
// kernel, aboba_girsanov.cu).
//
// Layout.  One thread owns one walker for the whole trajectory; a block is
// one warp of 32 walkers.  Positions, velocities and forces live in dynamic
// shared memory as [coordinate][walker-in-block], so the 32 lanes touch 32
// consecutive words (no bank conflicts) and every term's table entry is the
// same address across the warp (a broadcast load).  Forces accumulate in a
// fixed loop order, so a seed gives the same bits on every run -- no atomics.
// Blocks of one warp spread a 512-walker batch over 16 SMs; 32-walker
// blocks at 25 KB of shared memory each (22 atoms) let 9 blocks share an SM.
//
// Noise: curand's Philox4x32-10, keyed by (seed, walker, step): each step
// re-initialises the counter at (subsequence = walker, offset = step * 4 *
// ceil(3N/4)) and draws ceil(3N/4) normal4's.  noise == 0 runs the noiseless
// recursion (the parity mode of the TPU kernel's interpret run).
//
// Bound on this card: operations.  Per walker-step the force field costs
// about 18.7k float operations for alanine dipeptide (the vector part of
// isokann_tpu/utils/flops.py:fused_md_flops, copied as step_ops() in
// langevin_kernel.py) and touches only on-chip state; device memory sees
// x and v once per launch.  So the least time is ops / the FP32 non-tensor
// peak (67 TFLOP/s on an H100 SXM).  This first version is latency-bound
// (few warps per SM at B = 512); occupancy and shared term tables are for
// later work.

#include <curand_kernel.h>

#include "md_forces.cuh"

namespace {

__global__ void forces_kernel(const float* __restrict__ x,
                              float* __restrict__ f, int B, Tables t) {
  extern __shared__ float smem[];
  const int A3 = 3 * t.natoms;
  const int lane = threadIdx.x;
  const int w = blockIdx.x * kBlock + lane;
  if (w >= B) return;  // no block-wide barrier follows
  float* sx = smem;
  float* sf = sx + A3 * kBlock;
  for (int c = 0; c < A3; ++c) *at(sx, c, lane) = x[(size_t)w * A3 + c];
  compute_forces(t, sx, sf, lane);
  for (int c = 0; c < A3; ++c) f[(size_t)w * A3 + c] = *at(sf, c, lane);
}

__global__ void langevin_middle_kernel(float* __restrict__ x,
                                       float* __restrict__ v, int B,
                                       Tables t, int nsteps,
                                       unsigned long long seed, int noise,
                                       float dt, float a, float b) {
  extern __shared__ float smem[];
  const int A3 = 3 * t.natoms;
  const int lane = threadIdx.x;
  const int w = blockIdx.x * kBlock + lane;
  if (w >= B) return;  // no block-wide barrier follows
  float* sx = smem;
  float* sv = sx + A3 * kBlock;
  float* sf = sv + A3 * kBlock;
  for (int c = 0; c < A3; ++c) {
    *at(sx, c, lane) = x[(size_t)w * A3 + c];
    *at(sv, c, lane) = v[(size_t)w * A3 + c];
  }
  const float* minv = t.ftab + minv_offset(t);
  const float* vstd = minv + A3;
  const float h = 0.5f * dt;
  const int nq = (A3 + 3) / 4;
  for (int s = 0; s < nsteps; ++s) {
    compute_forces(t, sx, sf, lane);
    curandStatePhilox4_32_10_t st;
    if (noise)
      curand_init(seed, (unsigned long long)w,
                  (unsigned long long)s * 4ull * nq, &st);
    for (int c0 = 0; c0 < A3; c0 += 4) {
      const float4 z4 =
          noise ? curand_normal4(&st) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
      for (int q = 0; q < 4 && c0 + q < A3; ++q) {
        const int c = c0 + q;
        float vi = *at(sv, c, lane) + dt * *at(sf, c, lane) * __ldg(minv + c);
        float xi = *at(sx, c, lane) + h * vi;
        vi = a * vi + b * __ldg(vstd + c) * z[q];
        *at(sx, c, lane) = xi + h * vi;
        *at(sv, c, lane) = vi;
      }
    }
  }
  for (int c = 0; c < A3; ++c) {
    x[(size_t)w * A3 + c] = *at(sx, c, lane);
    v[(size_t)w * A3 + c] = *at(sv, c, lane);
  }
}

}  // namespace

// x, f: (B, 3N) float32 row-major on the device.  Returns a cudaError_t.
extern "C" int lm_forces(const void* x, void* f, int B, const void* itab,
                         const void* ftab, int natoms, int np, int nb, int na,
                         int nd, int use_rf, float rc, float krf, int periodic,
                         float bx, float by, float bz, void* stream) {
  if (natoms < 1 || natoms > kMaxAtoms || B < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * 3 * natoms * kBlock;
  cudaError_t err = prepare(forces_kernel, smem);
  if (err != cudaSuccess) return err;
  const Tables t = make_tables(itab, ftab, natoms, np, nb, na, nd, use_rf, rc,
                               krf, periodic, bx, by, bz);
  forces_kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(f), B, t);
  return cudaGetLastError();
}

// x, v: (B, 3N) float32 row-major on the device, advanced in place by
// nsteps LangevinMiddle steps.  Returns a cudaError_t.
extern "C" int lm_langevin_middle(void* x, void* v, int B, const void* itab,
                                  const void* ftab, int natoms, int np, int nb,
                                  int na, int nd, int use_rf, float rc,
                                  float krf, int periodic, float bx, float by,
                                  float bz, int nsteps,
                                  unsigned long long seed, int noise,
                                  float dt, float a, float b, void* stream) {
  if (natoms < 1 || natoms > kMaxAtoms || B < 1 || nsteps < 0)
    return cudaErrorInvalidValue;
  const size_t smem = 3 * sizeof(float) * 3 * natoms * kBlock;
  cudaError_t err = prepare(langevin_middle_kernel, smem);
  if (err != cudaSuccess) return err;
  const Tables t = make_tables(itab, ftab, natoms, np, nb, na, nd, use_rf, rc,
                               krf, periodic, bx, by, bz);
  langevin_middle_kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(v), B, t, nsteps, seed,
      noise, dt, a, b);
  return cudaGetLastError();
}
