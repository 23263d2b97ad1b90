// Force field of small vacuum systems for the hand-written MD kernels, one
// CUDA thread per walker.  Included by langevin_middle.cu and
// aboba_girsanov.cu (each builds into its own shared library).
//
// It computes what make_force_parts computes for the TPU kernels of
// isokann_tpu/md/pallas_md.py: harmonic bonds, harmonic angles, periodic
// torsions and all-pairs LJ + Coulomb (exclusion / 1-4 scales folded into
// the pair table, reaction field inside the cutoff for unscaled pairs,
// minimum image when periodic), each term evaluated directly rather than
// through the TPU's difference-operator matmuls.
//
// Layout.  A block is one warp of kBlock walkers; per-walker state lives in
// dynamic shared memory as [unit][walker-in-block], so the 32 lanes touch
// 32 consecutive words (no bank conflicts) and every term's table entry is
// the same address across the warp (a broadcast load).  Forces accumulate
// in a fixed loop order, so a seed gives the same bits on every run.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;      // walkers per block
constexpr int kMaxAtoms = 64;

struct Tables {
  // pairs (2 np) | bonds (2 nb) | angles (3 na) | torsions (4 nd)
  const int* itab;
  // qq eps rmin full (np each) | bk br0 | ak at0 | pk phase n | minv (3N)
  // | vstd (3N)
  const float* ftab;
  int natoms, np, nb, na, nd;
  int use_rf, periodic;
  float rc, krf, bx, by, bz;
};

__device__ __forceinline__ float* at(float* s, int c, int lane) {
  return s + c * kBlock + lane;
}

__device__ __forceinline__ void load3(const float* s, int a, int lane,
                                      float& x, float& y, float& z) {
  x = s[(3 * a + 0) * kBlock + lane];
  y = s[(3 * a + 1) * kBlock + lane];
  z = s[(3 * a + 2) * kBlock + lane];
}

__device__ __forceinline__ void add3(float* s, int a, int lane,
                                     float x, float y, float z) {
  s[(3 * a + 0) * kBlock + lane] += x;
  s[(3 * a + 1) * kBlock + lane] += y;
  s[(3 * a + 2) * kBlock + lane] += z;
}

// sf <- forces at sx (both [3N][kBlock]) for the walker in column `lane`.
__device__ void compute_forces(const Tables& t, const float* sx, float* sf,
                               int lane) {
  const int A3 = 3 * t.natoms;
  for (int c = 0; c < A3; ++c) *at(sf, c, lane) = 0.f;

  const int* ip = t.itab;
  const int* ib = ip + 2 * t.np;
  const int* ia = ib + 2 * t.nb;
  const int* id = ia + 3 * t.na;
  const float* qq = t.ftab;
  const float* eps = qq + t.np;
  const float* rmin = eps + t.np;
  const float* full = rmin + t.np;
  const float* bk = full + t.np;
  const float* br0 = bk + t.nb;
  const float* ak = br0 + t.nb;
  const float* at0 = ak + t.na;
  const float* pk = at0 + t.na;
  const float* phase = pk + t.nd;
  const float* dn = phase + t.nd;

  // ---- nonbonded pairs i < j: dE/dd = 2 g d with d = x_i - x_j ----------
  const float ibx = 1.f / t.bx, iby = 1.f / t.by, ibz = 1.f / t.bz;
  for (int p = 0; p < t.np; ++p) {
    const int i = __ldg(ip + 2 * p), j = __ldg(ip + 2 * p + 1);
    float xi, yi, zi, xj, yj, zj;
    load3(sx, i, lane, xi, yi, zi);
    load3(sx, j, lane, xj, yj, zj);
    float dx = xi - xj, dy = yi - yj, dz = zi - zj;
    if (t.periodic) {
      dx -= t.bx * rintf(dx * ibx);
      dy -= t.by * rintf(dy * iby);
      dz -= t.bz * rintf(dz * ibz);
    }
    const float r2 = dx * dx + dy * dy + dz * dz + 1e-12f;
    const float inv_r2 = 1.f / r2;
    const float r = sqrtf(r2);
    const float rm = __ldg(rmin + p);
    const float s2 = rm * rm * inv_r2;
    const float x6 = s2 * s2 * s2;
    const float q = __ldg(qq + p);
    float g_lj = 6.f * __ldg(eps + p) * (x6 - x6 * x6) * inv_r2;
    float g_c = q * (-0.5f * inv_r2 / r);
    if (t.use_rf && __ldg(full + p) > 0.f) {
      const float w = r < t.rc ? 1.f : 0.f;
      g_c = (g_c + q * t.krf) * w;
      g_lj *= w;
    }
    const float g = 2.f * (g_lj + g_c);
    add3(sf, i, lane, -g * dx, -g * dy, -g * dz);
    add3(sf, j, lane, g * dx, g * dy, g * dz);
  }

  // ---- bonds: E = k (r - r0)^2, d = x_a - x_b ---------------------------
  for (int k = 0; k < t.nb; ++k) {
    const int a = __ldg(ib + 2 * k), b = __ldg(ib + 2 * k + 1);
    float xa, ya, za, xb, yb, zb;
    load3(sx, a, lane, xa, ya, za);
    load3(sx, b, lane, xb, yb, zb);
    const float dx = xa - xb, dy = ya - yb, dz = za - zb;
    const float r = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
    const float g = 2.f * __ldg(bk + k) * (r - __ldg(br0 + k)) / r;
    add3(sf, a, lane, -g * dx, -g * dy, -g * dz);
    add3(sf, b, lane, g * dx, g * dy, g * dz);
  }

  // ---- angles: E = k (theta - theta0)^2, u = x_a - x_b, v = x_c - x_b ---
  for (int k = 0; k < t.na; ++k) {
    const int a = __ldg(ia + 3 * k), b = __ldg(ia + 3 * k + 1),
              c = __ldg(ia + 3 * k + 2);
    float xa, ya, za, xb, yb, zb, xc, yc, zc;
    load3(sx, a, lane, xa, ya, za);
    load3(sx, b, lane, xb, yb, zb);
    load3(sx, c, lane, xc, yc, zc);
    const float ux = xa - xb, uy = ya - yb, uz = za - zb;
    const float vx = xc - xb, vy = yc - yb, vz = zc - zb;
    const float uu = ux * ux + uy * uy + uz * uz + 1e-12f;
    const float vv = vx * vx + vy * vy + vz * vz + 1e-12f;
    const float uv = ux * vx + uy * vy + uz * vz;
    const float inv_norm = rsqrtf(uu * vv);
    const float cs = fminf(fmaxf(uv * inv_norm, -1.f + 1e-7f), 1.f - 1e-7f);
    const float sn = sqrtf(1.f - cs * cs);
    const float theta = acosf(cs);
    const float coef = -2.f * __ldg(ak + k) * (theta - __ldg(at0 + k)) / sn;
    const float cu = coef * inv_norm;
    const float cuu = coef * cs / uu;
    const float cvv = coef * cs / vv;
    const float gux = cu * vx - cuu * ux, guy = cu * vy - cuu * uy,
                guz = cu * vz - cuu * uz;
    const float gvx = cu * ux - cvv * vx, gvy = cu * uy - cvv * vy,
                gvz = cu * uz - cvv * vz;
    add3(sf, a, lane, -gux, -guy, -guz);
    add3(sf, c, lane, -gvx, -gvy, -gvz);
    add3(sf, b, lane, gux + gvx, guy + gvy, guz + gvz);
  }

  // ---- torsions: E = pk (1 + cos(n phi - phase)) ------------------------
  // b1 = x_j - x_i, b2 = x_k - x_j, b3 = x_l - x_k;
  // dphi/db1 = -(|b2|/|n1|^2) n1, dphi/db3 = -(|b2|/|n2|^2) n2,
  // dphi/db2 = -(b1.b2/|b2|^2) dphi/db1 - (b3.b2/|b2|^2) dphi/db3.
  for (int k = 0; k < t.nd; ++k) {
    const int i = __ldg(id + 4 * k), j = __ldg(id + 4 * k + 1),
              m = __ldg(id + 4 * k + 2), l = __ldg(id + 4 * k + 3);
    float xi, yi, zi, xj, yj, zj, xm, ym, zm, xl, yl, zl;
    load3(sx, i, lane, xi, yi, zi);
    load3(sx, j, lane, xj, yj, zj);
    load3(sx, m, lane, xm, ym, zm);
    load3(sx, l, lane, xl, yl, zl);
    const float b1x = xj - xi, b1y = yj - yi, b1z = zj - zi;
    const float b2x = xm - xj, b2y = ym - yj, b2z = zm - zj;
    const float b3x = xl - xm, b3y = yl - ym, b3z = zl - zm;
    const float n1x = b1y * b2z - b1z * b2y;
    const float n1y = b1z * b2x - b1x * b2z;
    const float n1z = b1x * b2y - b1y * b2x;
    const float n2x = b2y * b3z - b2z * b3y;
    const float n2y = b2z * b3x - b2x * b3z;
    const float n2z = b2x * b3y - b2y * b3x;
    const float n1sq = n1x * n1x + n1y * n1y + n1z * n1z + 1e-12f;
    const float n2sq = n2x * n2x + n2y * n2y + n2z * n2z + 1e-12f;
    const float b2sq = b2x * b2x + b2y * b2y + b2z * b2z + 1e-12f;
    const float b2n = sqrtf(b2sq);
    const float m1x = (n1y * b2z - n1z * b2y) / b2n;
    const float m1y = (n1z * b2x - n1x * b2z) / b2n;
    const float m1z = (n1x * b2y - n1y * b2x) / b2n;
    const float yy = m1x * n2x + m1y * n2y + m1z * n2z;
    const float xx = n1x * n2x + n1y * n2y + n1z * n2z;
    const float phi = atan2f(yy, xx);
    const float nn = __ldg(dn + k);
    const float dE = -__ldg(pk + k) * nn * sinf(nn * phi - __ldg(phase + k));
    const float c1 = -b2n / n1sq * dE;
    const float c3 = -b2n / n2sq * dE;
    const float p12 = (b1x * b2x + b1y * b2y + b1z * b2z) / b2sq;
    const float p32 = (b3x * b2x + b3y * b2y + b3z * b2z) / b2sq;
    const float g1x = c1 * n1x, g1y = c1 * n1y, g1z = c1 * n1z;
    const float g3x = c3 * n2x, g3y = c3 * n2y, g3z = c3 * n2z;
    const float g2x = -p12 * g1x - p32 * g3x;
    const float g2y = -p12 * g1y - p32 * g3y;
    const float g2z = -p12 * g1z - p32 * g3z;
    add3(sf, i, lane, g1x, g1y, g1z);
    add3(sf, j, lane, g2x - g1x, g2y - g1y, g2z - g1z);
    add3(sf, m, lane, g3x - g2x, g3y - g2y, g3z - g2z);
    add3(sf, l, lane, -g3x, -g3y, -g3z);
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

Tables make_tables(const void* itab, const void* ftab, int natoms, int np,
                   int nb, int na, int nd, int use_rf, float rc, float krf,
                   int periodic, float bx, float by, float bz) {
  Tables t;
  t.itab = static_cast<const int*>(itab);
  t.ftab = static_cast<const float*>(ftab);
  t.natoms = natoms; t.np = np; t.nb = nb; t.na = na; t.nd = nd;
  t.use_rf = use_rf; t.periodic = periodic;
  t.rc = rc; t.krf = krf; t.bx = bx; t.by = by; t.bz = bz;
  return t;
}

// Offset of minv (3N) in ftab; vstd (3N) follows it.
__host__ __device__ inline int minv_offset(const Tables& t) {
  return 4 * t.np + 2 * t.nb + 2 * t.na + 3 * t.nd;
}

}  // namespace
