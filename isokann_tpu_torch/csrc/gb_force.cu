// Nonbonded + OBC2 generalized-Born forces of a medium system (64 < A <= 640
// atoms), one CUDA block per walker and one thread per atom.
//
// Replaces the TPU kernel isokann_tpu/md/pallas_gb.py:gb_force_pallas (its
// inner body _force_one_walker; the opt-in _force_one_walker_tri computes the
// same function in an upper-triangle tiling).  It computes that function:
// all-pairs LJ + Coulomb with the exclusion / 1-4 scales (the LJ scale
// derived from the Coulomb one: 0 -> 0, >= 0.999 -> 1, else 0.5), NoCutoff or
// reaction field inside the cutoff, minimum image when periodic, and the
// OBC2 GBSA force in three passes:
//   1. Born radii: HCT descreening sums I_i = sum_j I_ij, then
//      B_i = 1 / (1/orad_i - tanh(psi - 0.8 psi^2 + 4.85 psi^3) / radius_i);
//   2. dE/dB_i: the self and surface terms plus sum_j of the GB pair term;
//      the chain factor g_i = dE/dB_i dB/dpsi_i orad_i;
//   3. forces: F_i = -sum_j w_ij d_ij + sum_j GdR_ji d_ji, d_ij = x_i - x_j,
//      where w_ij holds LJ + Coulomb, the GB pair-energy derivative and
//      GdR_ij = g_i dI_ij/dr / r, and the second sum is the descreening
//      transpose term that the TPU kernel took from column sums.
// The forms follow the TPU kernel: one rsqrt per distance, 1/(L U) for both
// reciprocals, per-atom 1/B, r^2 / (4 B_i B_j) from per-atom reciprocals.
//
// Not its layout.  The TPU padded the atoms to Ap lanes (pad atoms parked
// 1000 nm away and masked) and cached (L, U, ln(L/U)) and (exp, f^-3) chunks
// across passes in VMEM.  Here thread i loops over the A real atoms j and
// skips j == i (the TPU's off-diagonal mask), and recomputes those
// quantities in registers in each pass that needs them.  Coordinates, the
// per-atom tables and the pass results (B, 1/B, g) live in shared memory
// (12 floats an atom, 30 KB at 640 atoms); the Coulomb scale row of atom i is
// read from a transposed copy in global memory, so a warp's 32 atoms read 32
// consecutive words (590 KB at 313 atoms, resident in L2).  Thread i computes
// the transpose term GdR_ji d_ji itself from j's chain factor: no atomics,
// a fixed loop order, and the same bits for the same input.
//
// Bound on this card: operations.  The function is transcendental-heavy pair
// math (exp, log, rsqrt and divisions for every ordered pair; 153 operations
// a pair with OBC2 as the TPU body computes them, counted by
// gb_kernel.step_ops) on coordinates read once and forces written once, so
// the least time is operations / the FP32 non-tensor peak (67 TFLOP/s on an
// H100 SXM).
//
// What is slow about this first design: a walker is one block, so at B = 1
// (a single-walker trajectory, e.g. randx0's sequential launches) one SM of
// 132 works.  And it repeats work to keep per-atom state in shared memory
// only: the geometry in each pass, the (exp, f^-3) terms in pass 3, and
// dI/dr with its (L, U, ln) terms twice there (for the pair seen from i and
// from j), 250 operations a pair in all (gb_kernel.kernel_ops), 1.63x the
// function's.  Occupancy at small B, and a triangular (Newton-pair) tiling
// that also computes the symmetric terms once per unordered pair, are for
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxAtoms = 640;
constexpr float kSA = (float)(-6.0 * 28.3919551);  // ACE surface-term d/dB

struct Params {
  const float* tab;  // q | Rmin/2 | sqrt(eps) | radius | offset radius |
                     // scaled radius, A each
  const float* qqt;  // (A, A) Coulomb scale, transposed: qqt[j A + i] = s_ij
  int A, use_gb, use_rf, periodic;
  float rc, krf, coulomb, pref, bx, by, bz, ibx, iby, ibz;
};

__device__ __forceinline__ float sgn(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

// d = x_i - x_j (minimum-imaged when periodic), r^2, 1/r, r.
struct Geom {
  float dx, dy, dz, r2, inv_r, r;
};

__device__ __forceinline__ Geom geom(const Params& p, const float* sx,
                                     const float* sy, const float* sz,
                                     float xi, float yi, float zi, int j) {
  Geom g;
  g.dx = xi - sx[j];
  g.dy = yi - sy[j];
  g.dz = zi - sz[j];
  if (p.periodic) {
    g.dx = g.dx - p.bx * rintf(g.dx * p.ibx);
    g.dy = g.dy - p.by * rintf(g.dy * p.iby);
    g.dz = g.dz - p.bz * rintf(g.dz * p.ibz);
  }
  g.r2 = g.dx * g.dx + g.dy * g.dy + g.dz * g.dz;
  g.inv_r = rsqrtf(g.r2);
  g.r = g.r2 * g.inv_r;
  return g;
}

// (L, U) terms of the descreening integral of the sphere of scaled radius
// srj around atom j seen from atom i (offset radius oradi).
struct LU {
  float invL, invU, lnLU;
};

__device__ __forceinline__ LU lu_terms(float r, float srj, float oradi) {
  const float L = fmaxf(fabsf(r - srj), oradi);
  const float U = r + srj;
  const float rLU = 1.f / (L * U);
  LU t;
  t.invL = U * rLU;
  t.invU = L * rLU;
  t.lnLU = logf(L * t.invU);
  return t;
}

__device__ __forceinline__ bool active(float r, float srj, float oradi) {
  return (r + srj > oradi) && (srj > 1e-8f);
}

// dI_ij / dr for the pair at distance r.
__device__ __forceinline__ float dI_dr(const Geom& g, float inv_r2, float srj,
                                       float oradi) {
  const float r = g.r, inv_r = g.inv_r;
  const LU t = lu_terms(r, srj, oradi);
  const float dL = (fabsf(r - srj) > oradi) ? sgn(r - srj) : 0.f;
  const float invL2 = t.invL * t.invL, invU2 = t.invU * t.invU;
  float dI = 0.5f * (-invL2 * dL + invU2 +
                     0.25f * ((1.f + srj * srj * inv_r2) * (invU2 - invL2) +
                              (r - srj * srj * inv_r) *
                                  (-2.f * t.invU * invU2 +
                                   2.f * t.invL * invL2 * dL)) -
                     0.5f * t.lnLU * inv_r2 + 0.5f * (dL * t.invL - t.invU) *
                                                   inv_r);
  if (oradi < srj - r) dI += 2.f * invL2 * dL;
  return dI;
}

__global__ void __launch_bounds__(kMaxAtoms)
    gb_force_kernel(const float* __restrict__ x, float* __restrict__ f,
                    Params p) {
  extern __shared__ float sm[];
  const int A = p.A;
  float* sx = sm;
  float* sy = sx + A;
  float* sz = sy + A;
  float* sq = sz + A;
  float* srmh = sq + A;
  float* sseps = srmh + A;
  float* srad = sseps + A;
  float* sorad = srad + A;
  float* ssr = sorad + A;
  float* sB = ssr + A;
  float* sinvB = sB + A;
  float* sgch = sinvB + A;

  const float* xw = x + (size_t)blockIdx.x * 3 * A;
  for (int k = threadIdx.x; k < A; k += blockDim.x) {
    sx[k] = xw[3 * k + 0];
    sy[k] = xw[3 * k + 1];
    sz[k] = xw[3 * k + 2];
    sq[k] = p.tab[k];
    srmh[k] = p.tab[A + k];
    sseps[k] = p.tab[2 * A + k];
    srad[k] = p.tab[3 * A + k];
    sorad[k] = p.tab[4 * A + k];
    ssr[k] = p.tab[5 * A + k];
  }
  __syncthreads();

  const int i = threadIdx.x;  // blockDim.x >= A: one thread per atom
  const bool own = i < A;
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, oradi = 1.f, sri = 0.f;
  float Bi = 1.f, invBi = 1.f, gi = 0.f;
  if (own) {
    xi = sx[i];
    yi = sy[i];
    zi = sz[i];
    qi = sq[i];
    oradi = sorad[i];
    sri = ssr[i];
  }

  if (p.use_gb) {
    // ---- pass 1: Born radius -------------------------------------------
    float dBdpsi = 0.f;
    if (own) {
      float Ii = 0.f;
      for (int j = 0; j < A; ++j) {
        if (j == i) continue;
        const Geom g = geom(p, sx, sy, sz, xi, yi, zi, j);
        const float srj = ssr[j];
        const LU t = lu_terms(g.r, srj, oradi);
        float I = 0.5f * (t.invL - t.invU +
                          0.25f * (g.r - srj * srj * g.inv_r) *
                              (t.invU * t.invU - t.invL * t.invL) +
                          0.5f * t.lnLU * g.inv_r);
        if (oradi < srj - g.r) I += 2.f * (1.f / oradi - t.invL);
        if (active(g.r, srj, oradi)) Ii += I;
      }
      const float radi = srad[i];
      const float psi = Ii * oradi;
      const float garg = psi - 0.8f * (psi * psi) + 4.85f * (psi * psi * psi);
      const float th = tanhf(garg);
      Bi = 1.f / (1.f / oradi - th / radi);
      Bi = fmaxf(Bi, oradi);
      invBi = 1.f / Bi;
      dBdpsi = Bi * Bi * (1.f - th * th) *
               (1.f - 1.6f * psi + 14.55f * (psi * psi)) / radi;
      sB[i] = Bi;
      sinvB[i] = invBi;
    }
    __syncthreads();

    // ---- pass 2: dE/dB and the chain factor ----------------------------
    if (own) {
      const float radi = srad[i];
      const float ra = radi + 0.14f;
      const float r3 = radi * radi * radi;
      const float iB2 = invBi * invBi;
      float dEdB = p.pref * (-(qi * qi) * invBi * invBi) +
                   kSA * (ra * ra) * (r3 * r3) * (iB2 * iB2 * iB2 * invBi);
      float acc = 0.f;
      for (int j = 0; j < A; ++j) {
        if (j == i) continue;
        const Geom g = geom(p, sx, sy, sz, xi, yi, zi, j);
        const float Bj = sB[j];
        const float t = g.r2 * (0.25f * invBi) * sinvB[j];
        const float expo = expf(-t);
        const float f2 = g.r2 + Bi * Bj * expo;
        const float rsf = rsqrtf(f2);
        const float finv3 = rsf * rsf * rsf;
        const float df2dBi = Bj * expo * (1.f + t);
        acc += p.pref * (qi * sq[j]) * (-0.5f) * finv3 * df2dBi;
      }
      dEdB += 2.f * acc;
      gi = dEdB * dBdpsi * oradi;
      sgch[i] = gi;
    }
    __syncthreads();
  }

  // ---- pass 3: forces ----------------------------------------------------
  if (!own) return;  // no block-wide barrier follows
  const float rmhi = srmh[i], sepsi = sseps[i];
  float fxr = 0.f, fyr = 0.f, fzr = 0.f;  // -sum_j w_ij d_ij
  float fxt = 0.f, fyt = 0.f, fzt = 0.f;  // sum_j GdR_ji d_ji
  for (int j = 0; j < A; ++j) {
    if (j == i) continue;
    const Geom g = geom(p, sx, sy, sz, xi, yi, zi, j);
    const float inv_r2 = g.inv_r * g.inv_r;
    const float rmin = rmhi + srmh[j];
    const float epsij = sepsi * sseps[j];
    float x6 = rmin * rmin * inv_r2;
    x6 = x6 * x6 * x6;
    const float qq = p.coulomb * qi * sq[j];
    const float qsc = __ldg(p.qqt + (size_t)j * A + i);
    const float lsc = (qsc == 0.f) ? 0.f : ((qsc >= 0.999f) ? 1.f : 0.5f);
    const float g_lj = 6.f * epsij * (x6 - x6 * x6) * inv_r2;
    const float g_c_plain = qq * (-0.5f) * inv_r2 * g.inv_r;
    float w;
    if (!p.use_rf) {
      w = 2.f * (lsc * g_lj + qsc * g_c_plain);
    } else {
      const float within = (g.r < p.rc) ? 1.f : 0.f;
      const float full = (qsc >= 0.999f) ? 1.f : 0.f;
      const float one4 = (qsc > 0.f && qsc < 0.999f) ? 1.f : 0.f;
      const float l_full = (lsc >= 0.999f) ? 1.f : 0.f;
      const float l_one4 = (lsc > 0.f && lsc < 0.999f) ? 1.f : 0.f;
      w = 2.f * (g_lj * (l_full * within + l_one4 * lsc) +
                 qq * ((-0.5f * inv_r2 * g.inv_r + p.krf) * within * full) +
                 g_c_plain * one4 * qsc);
    }
    if (p.use_gb) {
      const float Bj = sB[j];
      const float t = g.r2 * (0.25f * invBi) * sinvB[j];
      const float expo = expf(-t);
      const float f2 = g.r2 + Bi * Bj * expo;
      const float rsf = rsqrtf(f2);
      const float finv3 = rsf * rsf * rsf;
      const float dEdr2 =
          2.f * p.pref * (qi * sq[j]) * (-0.5f) * finv3 * (1.f - expo / 4.f);
      w += 2.f * dEdr2;
      const float srj = ssr[j], oradj = sorad[j];
      if (active(g.r, srj, oradi))
        w += gi * dI_dr(g, inv_r2, srj, oradi) * g.inv_r;
      if (active(g.r, sri, oradj)) {
        // the pair seen from j: d_ji = -d_ij
        const float gdr_ji = sgch[j] * dI_dr(g, inv_r2, sri, oradj) * g.inv_r;
        fxt -= gdr_ji * g.dx;
        fyt -= gdr_ji * g.dy;
        fzt -= gdr_ji * g.dz;
      }
    }
    fxr -= w * g.dx;
    fyr -= w * g.dy;
    fzr -= w * g.dz;
  }
  float* fw = f + (size_t)blockIdx.x * 3 * A;
  fw[3 * i + 0] = fxr + fxt;
  fw[3 * i + 1] = fyr + fyt;
  fw[3 * i + 2] = fzr + fzt;
}

}  // namespace

// x, f: (B, 3A) float32 row-major on the device; tab (6, A) and qqt (A, A)
// float32 on the device.  Returns a cudaError_t.
extern "C" int gb_force(const void* x, void* f, int B, int A, const void* tab,
                        const void* qqt, int use_gb, int use_rf, float rc,
                        float krf, float coulomb, float pref, int periodic,
                        float bx, float by, float bz, float ibx, float iby,
                        float ibz, void* stream) {
  if (A < 2 || A > kMaxAtoms || B < 1) return cudaErrorInvalidValue;
  Params p;
  p.tab = static_cast<const float*>(tab);
  p.qqt = static_cast<const float*>(qqt);
  p.A = A;
  p.use_gb = use_gb;
  p.use_rf = use_rf;
  p.periodic = periodic;
  p.rc = rc;
  p.krf = krf;
  p.coulomb = coulomb;
  p.pref = pref;
  p.bx = bx;
  p.by = by;
  p.bz = bz;
  p.ibx = ibx;
  p.iby = iby;
  p.ibz = ibz;
  const int threads = ((A + 31) / 32) * 32;
  const size_t smem = 12 * sizeof(float) * (size_t)A;
  gb_force_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(f), p);
  return cudaGetLastError();
}
