// Cell-list pair sweep of large periodic systems: LJ + reaction-field (or
// Ewald real-space erfc) Coulomb forces of every pair within the cutoff,
// one CUDA block per (cell, walker) and one thread per slot of the cell.
//
// Replaces the TPU kernel isokann_tpu/md/neighbor.py:neighbor_sweep_pallas
// (its body _nb_kernel_body).  It computes that function: for each atom i,
// F_i = sum_j -2 dE/d(r^2)(r_ij) d_ij over the atoms j in different slots
// within the cutoff under minimum image, with the hard (1-2/1-3) exclusions
// masked by the window bitmask of the lower-index atom (bit d-1 for the
// partner d indices above, d <= 32) or the atom's far-partner table, the LJ
// well combined as sqrt(eps_i) sqrt(eps_j), and Coulomb as the reaction
// field or, given alpha, the erfc real-space term through the
// Abramowitz-Stegun erfc.  The caller adds the 1-4 corrections and the
// bonded terms.
//
// Not its layout.  The TPU walked a (walker * cell, stencil) grid in order
// on one core, visiting each Newton offset pair once and returning the
// reaction forces through a static inverse permutation on the XLA side.
// Blocks here run in parallel and in no order, so each block sums the force
// on its own cell's atoms over the full stencil (the self cell and every
// distinct neighbour cell once; offsets that alias on a collapsed axis are
// deduplicated by the plan): each pair is computed twice, once from each
// side, and no two threads write the same output, so there are no atomics
// and the same input gives the same bits.  The wrapper keeps the cell
// table in PyTorch on the card (wrap into the box, cell ids, a stable sort,
// the (cell, slot) table) and hands the kernel per-slot records of 8 words
// in the sorted frame: x, y, z, q, Rmin/2, sqrt(eps), the original atom id
// (-1 for an empty slot) and the exclusion bits.  The block stages one
// neighbour cell's records in shared memory at a time (C * 32 bytes, 22 KB
// at C = 696) and every thread of the block reads the same record in step
// (a shared-memory broadcast).  Each thread writes its atom's force to the
// atom's original index; a slot dropped by an overflowing cell writes
// nothing (the wrapper zeroes the output).
//
// Bound on this card: operations.  Each walker reads 12 bytes and writes
// 12 bytes per atom; the work is the pair math of the ~400 partners each
// atom has within the cutoff at liquid density (neighbor_kernel.step_ops:
// 63 operations an unordered pair in cutoff for the reaction field), so
// the least time is operations / the FP32 non-tensor peak (67 TFLOP/s on an
// H100 SXM).
//
// What is slow about this first design: the plan's grid was chosen by the
// reference's cost model for its TPU (few large cells, C = 696 here), so a
// thread tests every slot of 9 cells, ~28 slots for each partner in range,
// and the full stencil computes each pair twice.  And at B = 1 a force
// call is only ncells blocks.  Smaller cells, a Newton tiling and a batch
// layout for small B are for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // one thread per slot: C <= 1024
constexpr int kMaxFar = 8;         // far-partner table width

struct Params {
  const float4* slots;  // (B, ncells, C, 2) float4 records
  const int* full;      // (ncells, nfull) cells of the full stencil
  const int* far;       // (n + 1, E2) far partners, -1 padded
  float* f;             // (B, 3 n) forces
  int n, ncells, C, nfull, E2, use_erfc;
  float bx, by, bz, ibx, iby, ibz, rc2, krf, coulomb, alpha, alpha2, a_spi;
};

// Abramowitz-Stegun 7.1.26, rounded per operation as the plain version
__device__ __forceinline__ float erfc_approx(float x) {
  const float t = __frcp_rn(__fadd_rn(1.f, __fmul_rn(0.3275911f, x)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  return __fmul_rn(poly, expf(__fmul_rn(-x, x)));
}

__global__ void __launch_bounds__(kMaxThreads)
    neighbor_sweep_kernel(Params p) {
  extern __shared__ float4 sj[];  // 2 C records of the staged cell
  const int cell = blockIdx.x;
  const int b = blockIdx.y;
  const int C = p.C;
  const int slot = threadIdx.x;
  const float4* rec = p.slots + (size_t)b * p.ncells * C * 2;

  // this thread's atom
  const bool live = slot < C;
  float4 ai = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 bi = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    ai = rec[((size_t)cell * C + slot) * 2 + 0];
    bi = rec[((size_t)cell * C + slot) * 2 + 1];
  }
  const int oidi = live ? __float_as_int(bi.z) : -1;
  const unsigned bitsi = __float_as_uint(bi.w);
  int fari[kMaxFar];
#pragma unroll
  for (int e = 0; e < kMaxFar; ++e)
    fari[e] = (oidi >= 0 && e < p.E2) ? p.far[(size_t)oidi * p.E2 + e] : -1;

  // the ~800 pair terms of an atom (~400 partners, cancelling to a few %
  // of the largest) sum in double: the sum is then exact to float32
  // rounding whatever the order, and the kernel agrees with its plain
  // version (which sums in another order) to the pair terms' own rounding
  double fx = 0.0, fy = 0.0, fz = 0.0;
  for (int s = 0; s < p.nfull; ++s) {
    const int cj = p.full[cell * p.nfull + s];
    __syncthreads();  // the previous cell's records are no longer read
    for (int k = threadIdx.x; k < 2 * C; k += blockDim.x)
      sj[k] = rec[(size_t)cj * C * 2 + k];
    __syncthreads();
    if (oidi < 0) continue;
    for (int k = 0; k < C; ++k) {
      // the geometry rounds once per operation (no fused multiply-add),
      // as the plain version's tensor ops do: both then draw the cutoff
      // through the same pairs, bit for bit
      const float4 aj = sj[2 * k];
      float dx = __fsub_rn(ai.x, aj.x);
      float dy = __fsub_rn(ai.y, aj.y);
      float dz = __fsub_rn(ai.z, aj.z);
      dx = __fsub_rn(dx, __fmul_rn(p.bx, rintf(__fmul_rn(dx, p.ibx))));
      dy = __fsub_rn(dy, __fmul_rn(p.by, rintf(__fmul_rn(dy, p.iby))));
      dz = __fsub_rn(dz, __fmul_rn(p.bz, rintf(__fmul_rn(dz, p.ibz))));
      const float r2 = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                    __fmul_rn(dz, dz)),
          1e-12f);
      if (!(r2 < p.rc2)) continue;
      const float4 bj = sj[2 * k + 1];
      const int oidj = __float_as_int(bj.z);
      if (oidj < 0 || oidj == oidi) continue;  // empty slot, same atom
      const int dd = oidj - oidi;
      bool excluded = false;
      if (dd >= 1 && dd <= 32)
        excluded = (bitsi >> (dd - 1)) & 1u;
      else if (dd <= -1 && dd >= -32)
        excluded = (__float_as_uint(bj.w) >> (-dd - 1)) & 1u;
#pragma unroll
      for (int e = 0; e < kMaxFar; ++e) excluded |= (fari[e] == oidj);
      if (excluded) continue;

      // the pair terms round once per operation, in the plain version's
      // order (no fused multiply-add): both give the same bits per pair
      const float inv_r = rsqrtf(r2);
      const float inv_r2 = __fmul_rn(inv_r, inv_r);
      const float qq = __fmul_rn(p.coulomb, __fmul_rn(ai.w, aj.w));
      const float rmin = __fadd_rn(bi.x, bj.x);
      const float epsij = __fmul_rn(bi.y, bj.y);
      float x6 = __fmul_rn(__fmul_rn(rmin, rmin), inv_r2);
      x6 = __fmul_rn(__fmul_rn(x6, x6), x6);
      const float g_lj =
          __fmul_rn(__fmul_rn(__fmul_rn(6.f, epsij),
                              __fsub_rn(x6, __fmul_rn(x6, x6))),
                    inv_r2);
      float g_c;
      if (p.use_erfc) {
        const float er = erfc_approx(__fmul_rn(p.alpha, __fmul_rn(r2, inv_r)));
        const float gauss = expf(__fmul_rn(-p.alpha2, r2));
        g_c = __fmul_rn(
            -qq, __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, er), inv_r2),
                                     inv_r),
                           __fmul_rn(__fmul_rn(p.a_spi, gauss), inv_r2)));
      } else {
        g_c = __fadd_rn(
            __fmul_rn(qq, __fmul_rn(__fmul_rn(-0.5f, inv_r2), inv_r)),
            __fmul_rn(qq, p.krf));
      }
      const float w = __fmul_rn(-2.f, __fadd_rn(g_lj, g_c));
      fx += (double)__fmul_rn(w, dx);
      fy += (double)__fmul_rn(w, dy);
      fz += (double)__fmul_rn(w, dz);
    }
  }
  if (oidi >= 0) {
    float* fo = p.f + (size_t)b * 3 * p.n + 3 * (size_t)oidi;
    fo[0] = (float)fx;
    fo[1] = (float)fy;
    fo[2] = (float)fz;
  }
}

}  // namespace

// slots: (B, ncells, C, 8) float32 records on the device (ids and bits as
// int32 bit patterns); full: (ncells, nfull) int32; far: (n + 1, E2) int32;
// f: (B, 3 n) float32, zeroed by the caller.  Returns a cudaError_t.
extern "C" int neighbor_sweep(const void* slots, const void* full,
                              const void* far, void* f, int B, int n,
                              int ncells, int C, int nfull, int E2,
                              int use_erfc, float bx, float by, float bz,
                              float ibx, float iby, float ibz, float rc2,
                              float krf, float coulomb, float alpha,
                              float alpha2, float a_spi, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxThreads || E2 < 1 ||
      E2 > kMaxFar || nfull < 1 || ncells < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.slots = static_cast<const float4*>(slots);
  p.full = static_cast<const int*>(full);
  p.far = static_cast<const int*>(far);
  p.f = static_cast<float*>(f);
  p.n = n;
  p.ncells = ncells;
  p.C = C;
  p.nfull = nfull;
  p.E2 = E2;
  p.use_erfc = use_erfc;
  p.bx = bx;
  p.by = by;
  p.bz = bz;
  p.ibx = ibx;
  p.iby = iby;
  p.ibz = ibz;
  p.rc2 = rc2;
  p.krf = krf;
  p.coulomb = coulomb;
  p.alpha = alpha;
  p.alpha2 = alpha2;
  p.a_spi = a_spi;
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = 2 * sizeof(float4) * (size_t)C;
  const dim3 grid(ncells, B);
  neighbor_sweep_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
