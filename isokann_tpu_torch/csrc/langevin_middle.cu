// Whole LangevinMiddle trajectories for small vacuum systems, one warp per
// walker.
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
// directly.
//
// Bound on this card: operations.  Per walker-step the force field costs
// about 18.7k float operations for alanine dipeptide (the vector part of
// isokann_tpu/utils/flops.py:fused_md_flops, copied as step_ops() in
// langevin_kernel.py) and touches only on-chip state; device memory sees
// x and v once per launch.  So the least time is ops / the FP32 non-tensor
// peak (67 TFLOP/s on an H100 SXM).  What keeps a kernel from it is the
// chain of dependent steps: a trajectory is sequential, so the time of a
// step is the latency of its longest lane, and at B = 1 (randx0) a single
// walker is all the work there is.
//
// Layout.  A warp owns a walker, a block holds kWarps walkers, so a step's
// work spreads over 32 lanes instead of one thread: lane l owns atoms l and
// l + 32 (N <= 64).  The force tables are staged in shared memory once per
// block: a dense N x N pair table of (qq, eps, rmin, full) stored [j][i],
// so that at partner j the lanes read consecutive float4s, the bonded
// indices and parameters, and each atom's list of bonded contribution slots
// (LangevinPlan.atom_slots); the force routine (stage, warp_forces) lives
// in warp_forces.cuh, shared with kernel B.  A step runs in three phases
// separated by __syncwarp:
//   1. each lane writes its atoms' positions to the warp's shared row;
//   2. the nonbonded force on a lane's atom is gathered over all partners j
//      in order (each pair is computed from both sides: twice the pair
//      operations, but 22-32 lanes at once and no scatter); one lane per
//      bonded term writes that term's per-atom contributions to its own
//      shared slots; lanes 0..ceil(3N/4)-1 draw the noise;
//   3. each lane adds its atoms' slots in the fixed order of their lists
//      and integrates its atoms' coordinates.
// No atomics and fixed orders: a seed gives the same bits on every run.
//
// Noise: curand's Philox4x32-10, keyed by (seed, walker, step).  The 4
// coordinates 4q..4q+3 of step s take the normal4 at offset s * 4 *
// ceil(3N/4) + 4q of subsequence walker_offset + w (w the walker within the
// launch, walker_offset the global index of the launch's first walker),
// drawn by lane q mod 32: a walker's noise depends on neither the batch, nor
// the block layout, nor how a walker-sharded batch is cut into launches.
// noise == 0 runs the noiseless recursion (the parity mode of the TPU
// kernel's interpret run).

#include <curand_kernel.h>

#include "warp_forces.cuh"

namespace {

__global__ void __launch_bounds__(32 * kWarps)
    forces_kernel(const float* __restrict__ x, float* __restrict__ f, int B,
                  Geometry g, const int* __restrict__ itab,
                  const float* __restrict__ ftab,
                  const float4* __restrict__ dense,
                  const int* __restrict__ aslots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(g);
  stage(g, L, itab, ftab, dense, aslots, smem);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;  // no block-wide barrier follows
  const int N = g.natoms, A3 = 3 * N;
  float* wx = warp_rows(L, smem, warp, N, lane);
  float* wc = wx + ((A3 + 3) & ~3) + 4 * L.nq;
  for (int c = lane; c < A3; c += 32) wx[c] = x[(size_t)w * A3 + c];
  __syncwarp();
  float fr[kPer][3];
  warp_forces(g, L, smem, wx, wc, lane, fr);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int a = lane + 32 * u;
    if (a < N)
#pragma unroll
      for (int k = 0; k < 3; ++k) f[(size_t)w * A3 + 3 * a + k] = fr[u][k];
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    langevin_middle_kernel(float* __restrict__ x, float* __restrict__ v,
                           int B, Geometry g, const int* __restrict__ itab,
                           const float* __restrict__ ftab,
                           const float4* __restrict__ dense,
                           const int* __restrict__ aslots, int nsteps,
                           unsigned long long seed,
                           unsigned long long walker_offset, int noise,
                           float dt, float a, float b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(g);
  stage(g, L, itab, ftab, dense, aslots, smem);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;  // no block-wide barrier follows
  const int N = g.natoms, A3 = 3 * N;
  float* wx = warp_rows(L, smem, warp, N, lane);
  float* wz = wx + ((A3 + 3) & ~3);
  float* wc = wz + 4 * L.nq;

  // the lane's atoms: coordinates, velocities, 1/m and sqrt(kT/m)
  const float* minv = ftab + 4 * g.np + 2 * g.nb + 2 * g.na + 3 * g.nd;
  const float* vstd = minv + A3;
  float xr[kPer][3], vr[kPer][3], mi[kPer][3], vs[kPer][3];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int at = lane + 32 * u;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = 3 * at + k;
      const bool own = at < N;
      xr[u][k] = own ? x[(size_t)w * A3 + c] : 0.f;
      vr[u][k] = own ? v[(size_t)w * A3 + c] : 0.f;
      mi[u][k] = own ? minv[c] : 0.f;
      vs[u][k] = own ? vstd[c] : 0.f;
    }
  }
  const float h = 0.5f * dt;
  for (int s = 0; s < nsteps; ++s) {
    // phase 1: positions to the warp's row
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int at = lane + 32 * u;
      if (at < N)
#pragma unroll
        for (int k = 0; k < 3; ++k) wx[3 * at + k] = xr[u][k];
    }
    __syncwarp();
    // phase 2: noise, then the forces (which end with phase 3's sums)
    if (noise) {
      for (int q = lane; q < L.nq; q += 32) {
        curandStatePhilox4_32_10_t st;
        curand_init(seed, walker_offset + (unsigned long long)w,
                    ((unsigned long long)s * L.nq + q) * 4ull, &st);
        const float4 z4 = curand_normal4(&st);
        wz[4 * q] = z4.x;
        wz[4 * q + 1] = z4.y;
        wz[4 * q + 2] = z4.z;
        wz[4 * q + 3] = z4.w;
      }
    }
    float fr[kPer][3];
    warp_forces(g, L, smem, wx, wc, lane, fr);
    // phase 3: integrate the lane's coordinates
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int at = lane + 32 * u;
      if (at >= N) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float z = noise ? wz[3 * at + k] : 0.f;
        float vi = vr[u][k] + dt * fr[u][k] * mi[u][k];
        const float xi = xr[u][k] + h * vi;
        vi = a * vi + b * vs[u][k] * z;
        xr[u][k] = xi + h * vi;
        vr[u][k] = vi;
      }
    }
    // the next step writes wx (read before phase 2's barrier), and wz and
    // wc only after its own phase-1 barrier, which every lane reaches
    // after this phase
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int at = lane + 32 * u;
    if (at < N)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[(size_t)w * A3 + 3 * at + k] = xr[u][k];
        v[(size_t)w * A3 + 3 * at + k] = vr[u][k];
      }
  }
}

}  // namespace

// x, f: (B, 3N) float32 row-major on the device; dense: (N, N, 4) float32;
// aslots: (N, K) int32.  Returns a cudaError_t.
extern "C" int lm_forces(const void* x, void* f, int B, const void* itab,
                         const void* ftab, const void* dense,
                         const void* aslots, int K, int natoms, int np,
                         int nb, int na, int nd, int use_rf, float rc,
                         float krf, int periodic, float bx, float by,
                         float bz, void* stream) {
  Geometry g;
  size_t smem = 0;
  cudaError_t err = prepare_geometry(g, natoms, np, nb, na, nd, K, use_rf,
                                     rc, krf, periodic, bx, by, bz, smem);
  if (err == cudaSuccess && B < 1) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = allow_smem(forces_kernel, smem);
  if (err != cudaSuccess) return err;
  forces_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(f), B, g,
      static_cast<const int*>(itab), static_cast<const float*>(ftab),
      static_cast<const float4*>(dense), static_cast<const int*>(aslots));
  return cudaGetLastError();
}

// x, v: (B, 3N) float32 row-major on the device, advanced in place by
// nsteps LangevinMiddle steps; walker_offset is the global index of the
// launch's first walker (its noise subsequence).  Returns a cudaError_t.
extern "C" int lm_langevin_middle(void* x, void* v, int B, const void* itab,
                                  const void* ftab, const void* dense,
                                  const void* aslots, int K, int natoms,
                                  int np, int nb, int na, int nd, int use_rf,
                                  float rc, float krf, int periodic, float bx,
                                  float by, float bz, int nsteps,
                                  unsigned long long seed,
                                  unsigned long long walker_offset, int noise,
                                  float dt, float a, float b, void* stream) {
  Geometry g;
  size_t smem = 0;
  cudaError_t err = prepare_geometry(g, natoms, np, nb, na, nd, K, use_rf,
                                     rc, krf, periodic, bx, by, bz, smem);
  if (err == cudaSuccess && (B < 1 || nsteps < 0)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = allow_smem(langevin_middle_kernel, smem);
  if (err != cudaSuccess) return err;
  langevin_middle_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(v), B, g,
      static_cast<const int*>(itab), static_cast<const float*>(ftab),
      static_cast<const float4*>(dense), static_cast<const int*>(aslots),
      nsteps, seed, walker_offset, noise, dt, a, b);
  return cudaGetLastError();
}
