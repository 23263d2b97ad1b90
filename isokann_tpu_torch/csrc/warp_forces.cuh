// Force field of small vacuum systems for the hand-written MD kernels, one
// warp per walker.  Included by langevin_middle.cu (kernel A) and
// aboba_girsanov.cu (kernel B); each builds into its own shared library.
//
// It computes what make_force_parts computes for the TPU kernels of
// isokann_tpu/md/pallas_md.py: harmonic bonds, harmonic angles, periodic
// torsions and all-pairs LJ + Coulomb (exclusion / 1-4 scales folded into
// the pair table, reaction field inside the cutoff for unscaled pairs,
// minimum image when periodic), each term evaluated directly rather than
// through the TPU's difference-operator matmuls.
//
// Layout.  A warp owns a walker, a block holds kWarps walkers: lane l owns
// atoms l and l + 32 (N <= 64).  The force tables are staged in shared
// memory once per block (stage): a dense N x N pair table of (qq, eps,
// rmin, full) stored [j][i], so that at partner j the lanes read
// consecutive float4s, the bonded indices and parameters, and each atom's
// list of bonded contribution slots (LangevinPlan.atom_slots).  warp_forces
// gathers the nonbonded force on a lane's atoms over all partners j in
// order (each pair is computed from both sides: twice the pair operations,
// but 22-32 lanes at once and no scatter), lets one lane per bonded term
// write that term's per-atom contributions to its own shared slots, and
// after a __syncwarp adds each atom's slots in the fixed order of its list.
// No atomics and fixed orders: the same positions give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;       // walkers per block, one warp each
constexpr int kMaxAtoms = 64;   // two atoms per lane
constexpr int kPer = 2;         // atoms per lane

struct Geometry {
  int natoms, np, nb, na, nd, K;
  int use_rf, periodic;
  float rc, krf, bx, by, bz;
  float rc2;  // the largest r^2 whose float sqrt rounds below rc
};

// Byte offsets into a block's dynamic shared memory (16-byte aligned):
// the tables, then kWarps per-walker regions of x (3N) | noise (4 nq) |
// bonded slots (3 (nslot + 1), the last slot zero).
struct Layout {
  int pair, idx, par, slots, warp, warp_bytes, total, nslot, nq;
};

__host__ __device__ inline int take(int& o, int bytes) {
  const int r = o;
  o += (bytes + 15) & ~15;
  return r;
}

__host__ __device__ inline Layout layout(const Geometry& g) {
  Layout L;
  const int N = g.natoms;
  int o = 0;
  L.nslot = 2 * g.nb + 3 * g.na + 4 * g.nd;
  L.nq = (3 * N + 3) / 4;
  L.pair = take(o, 16 * N * N);
  L.idx = take(o, 4 * L.nslot);
  L.par = take(o, 4 * (2 * g.nb + 2 * g.na + 3 * g.nd));
  L.slots = take(o, 4 * N * g.K);
  L.warp = o;
  int w = 0;
  take(w, 4 * 3 * N);
  take(w, 4 * 4 * L.nq);
  take(w, 4 * 3 * (L.nslot + 1));
  L.warp_bytes = w;
  L.total = o + kWarps * w;
  return L;
}

// Copies the tables into shared memory (all threads of the block).
__device__ void stage(const Geometry& g, const Layout& L, const int* itab,
                      const float* ftab, const float4* dense,
                      const int* aslots, unsigned char* smem) {
  const int N = g.natoms;
  float4* pair = reinterpret_cast<float4*>(smem + L.pair);
  int* idx = reinterpret_cast<int*>(smem + L.idx);
  float* par = reinterpret_cast<float*>(smem + L.par);
  int* slots = reinterpret_cast<int*>(smem + L.slots);
  const int npar = 2 * g.nb + 2 * g.na + 3 * g.nd;
  for (int k = threadIdx.x; k < N * N; k += blockDim.x) pair[k] = dense[k];
  // itab: pairs (2 np) | bonds | angles | torsions
  for (int k = threadIdx.x; k < L.nslot; k += blockDim.x)
    idx[k] = itab[2 * g.np + k];
  // ftab: qq eps rmin full (np each) | bk br0 | ak at0 | pk phase n | ...
  for (int k = threadIdx.x; k < npar; k += blockDim.x)
    par[k] = ftab[4 * g.np + k];
  for (int k = threadIdx.x; k < N * g.K; k += blockDim.x)
    slots[k] = aslots[k];
}

__device__ __forceinline__ void put3(float* c, int s, float x, float y,
                                     float z) {
  c[3 * s + 0] = x;
  c[3 * s + 1] = y;
  c[3 * s + 2] = z;
}

// Forces on the lane's atoms (f[u] for atom lane + 32 u) at the positions
// in wx, with wc the warp's bonded slots: phase 2, a __syncwarp, and phase
// 3's sums.  wx is read only before that barrier.
__device__ __forceinline__ void warp_forces(const Geometry& g, const Layout& L,
                            const unsigned char* smem, const float* wx,
                            float* wc, int lane, float f[kPer][3]) {
  const int N = g.natoms;
  const float4* pair = reinterpret_cast<const float4*>(smem + L.pair);
  const int* ib = reinterpret_cast<const int*>(smem + L.idx);
  const int* ia = ib + 2 * g.nb;
  const int* id = ia + 3 * g.na;
  const float* bk = reinterpret_cast<const float*>(smem + L.par);
  const float* br0 = bk + g.nb;
  const float* ak = br0 + g.nb;
  const float* at0 = ak + g.na;
  const float* pk = at0 + g.na;
  const float* phase = pk + g.nd;
  const float* dn = phase + g.nd;
  const int* slots = reinterpret_cast<const int*>(smem + L.slots);

  // ---- bonds: E = k (r - r0)^2, d = x_a - x_b; slots a, b --------------
  for (int k = lane; k < g.nb; k += 32) {
    const int a = ib[2 * k], b = ib[2 * k + 1];
    const float dx = wx[3 * a] - wx[3 * b], dy = wx[3 * a + 1] - wx[3 * b + 1],
                dz = wx[3 * a + 2] - wx[3 * b + 2];
    const float r = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
    const float gg = 2.f * bk[k] * (r - br0[k]) / r;
    put3(wc, 2 * k, -gg * dx, -gg * dy, -gg * dz);
    put3(wc, 2 * k + 1, gg * dx, gg * dy, gg * dz);
  }

  // ---- angles: E = k (theta - theta0)^2, u = x_a - x_b, v = x_c - x_b;
  // slots a, b, c
  const int s_ang = 2 * g.nb;
  for (int k = lane; k < g.na; k += 32) {
    const int a = ia[3 * k], b = ia[3 * k + 1], c = ia[3 * k + 2];
    const float ux = wx[3 * a] - wx[3 * b], uy = wx[3 * a + 1] - wx[3 * b + 1],
                uz = wx[3 * a + 2] - wx[3 * b + 2];
    const float vx = wx[3 * c] - wx[3 * b], vy = wx[3 * c + 1] - wx[3 * b + 1],
                vz = wx[3 * c + 2] - wx[3 * b + 2];
    const float uu = ux * ux + uy * uy + uz * uz + 1e-12f;
    const float vv = vx * vx + vy * vy + vz * vz + 1e-12f;
    const float uv = ux * vx + uy * vy + uz * vz;
    const float inv_norm = rsqrtf(uu * vv);
    const float cs = fminf(fmaxf(uv * inv_norm, -1.f + 1e-7f), 1.f - 1e-7f);
    const float sn = sqrtf(1.f - cs * cs);
    const float theta = acosf(cs);
    const float coef = -2.f * ak[k] * (theta - at0[k]) / sn;
    const float cu = coef * inv_norm;
    const float cuu = coef * cs / uu;
    const float cvv = coef * cs / vv;
    const float gux = cu * vx - cuu * ux, guy = cu * vy - cuu * uy,
                guz = cu * vz - cuu * uz;
    const float gvx = cu * ux - cvv * vx, gvy = cu * uy - cvv * vy,
                gvz = cu * uz - cvv * vz;
    put3(wc, s_ang + 3 * k, -gux, -guy, -guz);
    put3(wc, s_ang + 3 * k + 1, gux + gvx, guy + gvy, guz + gvz);
    put3(wc, s_ang + 3 * k + 2, -gvx, -gvy, -gvz);
  }

  // ---- torsions: E = pk (1 + cos(n phi - phase)); slots i, j, m, l -----
  // b1 = x_j - x_i, b2 = x_m - x_j, b3 = x_l - x_m;
  // dphi/db1 = -(|b2|/|n1|^2) n1, dphi/db3 = -(|b2|/|n2|^2) n2,
  // dphi/db2 = -(b1.b2/|b2|^2) dphi/db1 - (b3.b2/|b2|^2) dphi/db3.
  const int s_tor = s_ang + 3 * g.na;
  for (int k = lane; k < g.nd; k += 32) {
    const int i = id[4 * k], j = id[4 * k + 1], m = id[4 * k + 2],
              l = id[4 * k + 3];
    const float b1x = wx[3 * j] - wx[3 * i], b1y = wx[3 * j + 1] - wx[3 * i + 1],
                b1z = wx[3 * j + 2] - wx[3 * i + 2];
    const float b2x = wx[3 * m] - wx[3 * j], b2y = wx[3 * m + 1] - wx[3 * j + 1],
                b2z = wx[3 * m + 2] - wx[3 * j + 2];
    const float b3x = wx[3 * l] - wx[3 * m], b3y = wx[3 * l + 1] - wx[3 * m + 1],
                b3z = wx[3 * l + 2] - wx[3 * m + 2];
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
    const float nn = dn[k];
    const float dE = -pk[k] * nn * sinf(nn * phi - phase[k]);
    const float c1 = -b2n / n1sq * dE;
    const float c3 = -b2n / n2sq * dE;
    const float p12 = (b1x * b2x + b1y * b2y + b1z * b2z) / b2sq;
    const float p32 = (b3x * b2x + b3y * b2y + b3z * b2z) / b2sq;
    const float g1x = c1 * n1x, g1y = c1 * n1y, g1z = c1 * n1z;
    const float g3x = c3 * n2x, g3y = c3 * n2y, g3z = c3 * n2z;
    const float g2x = -p12 * g1x - p32 * g3x;
    const float g2y = -p12 * g1y - p32 * g3y;
    const float g2z = -p12 * g1z - p32 * g3z;
    put3(wc, s_tor + 4 * k, g1x, g1y, g1z);
    put3(wc, s_tor + 4 * k + 1, g2x - g1x, g2y - g1y, g2z - g1z);
    put3(wc, s_tor + 4 * k + 2, g3x - g2x, g3y - g2y, g3z - g2z);
    put3(wc, s_tor + 4 * k + 3, -g3x, -g3y, -g3z);
  }

  // ---- nonbonded, gathered: the force on atom a over partners j in
  // order, dE/dd = 2 g d with d = x_a - x_j -----------------------------
  const float ibx = 1.f / g.bx, iby = 1.f / g.by, ibz = 1.f / g.bz;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int a = lane + 32 * u;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if (a < N) {
      const float xi = wx[3 * a], yi = wx[3 * a + 1], zi = wx[3 * a + 2];
      // j == a adds an exact zero (its table row is zero and d = 0), so
      // the loop has no branch and unrolls
#pragma unroll 2
      for (int j = 0; j < N; ++j) {
        const float4 pp = pair[j * N + a];  // qq, eps, rmin, full
        float dx = xi - wx[3 * j], dy = yi - wx[3 * j + 1],
              dz = zi - wx[3 * j + 2];
        if (g.periodic) {
          dx -= g.bx * rintf(dx * ibx);
          dy -= g.by * rintf(dy * iby);
          dz -= g.bz * rintf(dz * ibz);
        }
        const float r2 = dx * dx + dy * dy + dz * dz + 1e-12f;
        // 1/r from rsqrtf (2 ulp) where the plain version divides and
        // takes sqrt: a step of one walker is ~30% shorter on an H100,
        // and the forces stay within ~4e-7 of the plain version's largest
        const float inv_r = rsqrtf(r2);
        const float inv_r2 = inv_r * inv_r;
        const float s2 = pp.z * pp.z * inv_r2;
        const float x6 = s2 * s2 * s2;
        float g_lj = 6.f * pp.y * (x6 - x6 * x6) * inv_r2;
        float g_c = pp.x * (-0.5f * inv_r2 * inv_r);
        if (g.use_rf && pp.w > 0.f) {
          // the plain version's cutoff, sqrt(r2) < rc in float32, as one
          // comparison on r2 (not on the approximate 1/r above)
          const float w = r2 <= g.rc2 ? 1.f : 0.f;
          g_c = (g_c + pp.x * g.krf) * w;
          g_lj *= w;
        }
        const float gg = 2.f * (g_lj + g_c);
        fx -= gg * dx;
        fy -= gg * dy;
        fz -= gg * dz;
      }
    }
    f[u][0] = fx;
    f[u][1] = fy;
    f[u][2] = fz;
  }
  __syncwarp();  // every lane's bonded slots are written

  // ---- each atom's bonded slots, in the order of its list -------------
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int a = lane + 32 * u;
    if (a >= N) continue;
#pragma unroll 4
    for (int k = 0; k < g.K; ++k) {
      const int s = slots[a * g.K + k];
      f[u][0] += wc[3 * s];
      f[u][1] += wc[3 * s + 1];
      f[u][2] += wc[3 * s + 2];
    }
  }
}

// The warp's shared rows and its zeroed padding slot.
__device__ __forceinline__ float* warp_rows(const Layout& L,
                                            unsigned char* smem, int warp,
                                            int N, int lane) {
  float* wx = reinterpret_cast<float*>(smem + L.warp + warp * L.warp_bytes);
  float* wc = wx + ((3 * N + 3) & ~3) + 4 * L.nq;
  if (lane < 3) wc[3 * L.nslot + lane] = 0.f;
  return wx;
}

cudaError_t prepare_geometry(Geometry& g, int natoms, int np, int nb, int na,
                             int nd, int K, int use_rf, float rc, float krf,
                             int periodic, float bx, float by, float bz,
                             size_t& smem) {
  g.natoms = natoms; g.np = np; g.nb = nb; g.na = na; g.nd = nd; g.K = K;
  g.use_rf = use_rf; g.periodic = periodic;
  g.rc = rc; g.krf = krf; g.bx = bx; g.by = by; g.bz = bz;
  // sqrtf rounds correctly and is monotone, so sqrtf(r2) < rc holds
  // exactly for r2 <= g.rc2
  g.rc2 = rc * rc;
  while (g.rc2 > 0.f && std::sqrt(g.rc2) >= rc)
    g.rc2 = std::nextafter(g.rc2, 0.f);
  while (std::sqrt(std::nextafter(g.rc2, HUGE_VALF)) < rc)
    g.rc2 = std::nextafter(g.rc2, HUGE_VALF);
  if (natoms < 1 || natoms > kMaxAtoms || K < 0) return cudaErrorInvalidValue;
  smem = (size_t)layout(g).total;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace
