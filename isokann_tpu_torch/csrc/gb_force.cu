// Nonbonded + OBC2 generalized-Born forces of a medium system (64 < A <= 640
// atoms): one thread-block cluster per walker, each unordered pair visited
// once, as a 32 x 32 tile pair.
//
// Replaces the TPU kernel isokann_tpu/md/pallas_gb.py:gb_force_pallas (its
// inner body _force_one_walker, and the same function in the upper-triangle
// tiling of _force_one_walker_tri, whose algebra this kernel follows).  It
// computes that function: all-pairs LJ + Coulomb with the exclusion / 1-4
// scales (the LJ scale derived from the Coulomb one: 0 -> 0, >= 0.999 -> 1,
// else 0.5), NoCutoff or reaction field inside the cutoff, minimum image
// when periodic, and the OBC2 GBSA force in three passes:
//   1. Born radii: HCT descreening sums I_i = sum_j I_ij, then
//      B_i = 1 / (1/orad_i - tanh(psi - 0.8 psi^2 + 4.85 psi^3) / radius_i);
//   2. dE/dB_i: the self and surface terms plus sum_j of the GB pair term;
//      the chain factor g_i = dE/dB_i dB/dpsi_i orad_i;
//   3. forces: F_i = -sum_j c_ij d_ij, d_ij = x_i - x_j, with the symmetric
//      coefficient c_ij = c_ji = w_ij + 2 dE/dr^2_ij + GdR_ij + GdR_ji, where
//      w holds LJ + Coulomb, GdR_ij = g_i dI_ij/dr / r; so atom j gets
//      +c_ij d_ij from the same pair.
// The forms follow the TPU kernel: one rsqrt per distance, 1/(L U) for both
// reciprocals, per-atom 1/B, r^2 / (4 B_i B_j) from per-atom reciprocals.
//
// Layout.  The atoms go into 32-atom tiles; the work is the nt (nt + 1) / 2
// tile pairs (I, J), J >= I, strict upper on the diagonal tiles (pair
// (i, j) with i < j only).  A walker is one cluster of `cluster` blocks of
// `warps` warps (gb_kernel.launch_shape: 8 warps, and 8 blocks where the
// block's shared memory fits, else 16 above the portable 8), so a single
// walker spreads over 8-16 SMs; tile pair t goes to block t mod cluster,
// and within it to warp (t / cluster) mod warps.  In a tile pair, lane l
// owns row atom 32 I + l; at step k = 0..31 it meets column atom
// 32 J + (l + k) mod 32, so the 32 lanes touch 32 distinct columns, and the
// column sums travel with their columns by one __shfl_sync a step (after 32
// steps column c's sum is back at lane c).  Per unordered pair the kernel
// computes once: the geometry, the LJ / Coulomb / RF coefficient, the GB
// exp and f^-3 terms and dE/dr^2; and once in each direction: I_ij and
// I_ji with their (L, U, ln) terms (pass 1), the two df^2/dB terms (pass
// 2), dI_ij/dr and dI_ji/dr (pass 1, from the same (L, U, ln) terms).
// What pass 3 needs of a pair
// stays in the block's shared memory between the passes (the pair cache,
// 12 KB a tile pair: dI_ij/dr / r, dI_ji/dr / r, and w + 2 dE/dr^2), so pass
// 2 recomputes only r^2 and pass 3 only d.
//
// Sums.  Each tile pair writes its row and column partial sums to its
// block's shared memory.  After cluster.sync(), the atoms of tile T are
// summed by one warp (block T mod cluster) over the partials of the tile
// pairs that hold T, read through distributed shared memory in ascending
// order of the other tile (its row and then its column partial for the
// diagonal tile pair).  That warp computes the per-atom results (B, 1/B and
// dB/dpsi after pass 1, g after pass 2, the force after pass 3) and writes
// B, 1/B and g into every block of the cluster; a cluster.sync() orders
// them before the next pass.  No atomics: the order of every sum is fixed by
// the tile indices, not by B, the cluster size or the block that ran a tile
// pair, so a walker's forces are the same bits at every batch size.
//
// Bound on this card: operations.  The function is transcendental-heavy pair
// math (exp, log, rsqrt and divisions; 227 operations an unordered pair with
// OBC2, counted by gb_kernel.step_ops) on coordinates read once and forces
// written once, so the least time is operations / the FP32 non-tensor peak
// (67 TFLOP/s on an H100 SXM).  The kernel executes 11 more an unordered
// pair (the distances of passes 2 and 3, gb_kernel.kernel_ops).  At a small
// batch a walker's time is the latency of its passes, spread over 8-16 SMs.
// At a large batch the throughput is the clusters the card holds at once
// times that latency: a walker's shared memory (the pair caches and each
// block's per-atom rows, ~0.8 MB for 313 atoms) lets about 30 clusters
// reside on an H100.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;
constexpr int kMaxAtoms = 640;
constexpr int kMaxTiles = kMaxAtoms / kTile;
constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 16;
constexpr int kRows = 13;       // per-atom rows in shared memory
constexpr int kPart = 3 * 64;   // partial sums of a tile pair: 3 x (row, col)
constexpr int kCache = 3 * kTile * kTile;  // pair cache of a tile pair
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSA = (float)(-6.0 * 28.3919551);  // ACE surface-term d/dB

struct Params {
  const float* tab;  // q | Rmin/2 | sqrt(eps) | radius | offset radius |
                     // scaled radius, A each
  const float* qq;   // (A, A) Coulomb scale grid (symmetric)
  int A, nt, ntp, nslot, use_gb, use_rf, periodic;
  float rc, krf, coulomb, pref, bx, by, bz, ibx, iby, ibz;
};

// A block's shared memory: the per-atom rows (32 nt each), the partial sums
// of its tile pairs, and with OBC2 their pair caches.
struct Smem {
  float *x, *y, *z, *q, *rmh, *seps, *rad, *orad, *sr, *B, *invB, *g, *dBdpsi;
  float *part, *cache;
};

__device__ __forceinline__ Smem carve(float* sm, const Params& p) {
  const int Ap = p.nt * kTile;
  float* r[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) r[k] = sm + k * Ap;
  Smem s{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10],
         r[11], r[12], sm + kRows * Ap, sm + kRows * Ap + p.nslot * kPart};
  return s;
}

size_t smem_bytes(int nt, int nslot, int use_gb) {
  return sizeof(float) * ((size_t)kRows * nt * kTile + (size_t)nslot * kPart +
                          (use_gb ? (size_t)nslot * kCache : 0));
}

// Tile pair t <-> (I, J), J >= I, in row-major order of the upper triangle.
__device__ __forceinline__ int tp_index(int I, int J, int nt) {
  return I * nt - I * (I - 1) / 2 + (J - I);
}

__device__ __forceinline__ void tp_tiles(int t, int nt, int& I, int& J) {
  I = 0;
  while (t >= nt - I) {
    t -= nt - I;
    ++I;
  }
  J = I + t;
}

__device__ __forceinline__ float sgn(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

// d = x_i - x_j, minimum-imaged when periodic.
__device__ __forceinline__ void delta(const Params& p, float xi, float yi,
                                      float zi, const Smem& s, int j,
                                      float& dx, float& dy, float& dz) {
  dx = xi - s.x[j];
  dy = yi - s.y[j];
  dz = zi - s.z[j];
  if (p.periodic) {
    dx = dx - p.bx * rintf(dx * p.ibx);
    dy = dy - p.by * rintf(dy * p.iby);
    dz = dz - p.bz * rintf(dz * p.ibz);
  }
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

// I_ij, the descreening of atom i by atom j.
__device__ __forceinline__ float descreen(const LU& t, float r, float inv_r,
                                          float srj, float oradi) {
  float I = 0.5f * (t.invL - t.invU +
                    0.25f * (r - srj * srj * inv_r) *
                        (t.invU * t.invU - t.invL * t.invL) +
                    0.5f * t.lnLU * inv_r);
  if (oradi < srj - r) I += 2.f * (1.f / oradi - t.invL);
  return I;
}

// dI_ij / dr for the pair at distance r.
__device__ __forceinline__ float dI_dr(const LU& t, float r, float inv_r,
                                       float inv_r2, float srj, float oradi) {
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

// LJ + Coulomb (+ reaction field) coefficient w of the pair.
__device__ __forceinline__ float pair_w(const Params& p, float r, float inv_r,
                                        float inv_r2, float qi, float qj,
                                        float rmin, float epsij, float qsc) {
  float x6 = rmin * rmin * inv_r2;
  x6 = x6 * x6 * x6;
  const float qq = p.coulomb * qi * qj;
  const float lsc = (qsc == 0.f) ? 0.f : ((qsc >= 0.999f) ? 1.f : 0.5f);
  const float g_lj = 6.f * epsij * (x6 - x6 * x6) * inv_r2;
  const float g_c_plain = qq * (-0.5f) * inv_r2 * inv_r;
  if (!p.use_rf) return 2.f * (lsc * g_lj + qsc * g_c_plain);
  const float within = (r < p.rc) ? 1.f : 0.f;
  const float full = (qsc >= 0.999f) ? 1.f : 0.f;
  const float one4 = (qsc > 0.f && qsc < 0.999f) ? 1.f : 0.f;
  const float l_full = (lsc >= 0.999f) ? 1.f : 0.f;
  const float l_one4 = (lsc > 0.f && lsc < 0.999f) ? 1.f : 0.f;
  return 2.f * (g_lj * (l_full * within + l_one4 * lsc) +
                qq * ((-0.5f * inv_r2 * inv_r + p.krf) * within * full) +
                g_c_plain * one4 * qsc);
}

// The tile pair's row atom and where lane meets column c: the row atom i,
// the column atom j and whether the pair counts.
struct TilePair {
  int I, J, i;
  bool diag, rowok;
};

__device__ __forceinline__ TilePair tile_pair(const Params& p, int t,
                                              int lane) {
  TilePair tp;
  tp_tiles(t, p.nt, tp.I, tp.J);
  tp.diag = tp.I == tp.J;
  tp.i = tp.I * kTile + lane;
  tp.rowok = tp.i < p.A;
  return tp;
}

__device__ __forceinline__ bool counts(const Params& p, const TilePair& tp,
                                       int c, int lane, int j) {
  return tp.rowok && j < p.A && (!tp.diag || c > lane);
}

// Pass 1 of a tile pair (OBC2): the row and column descreening sums, and the
// pair cache: dI_ij/dr / r, dI_ji/dr / r (0 where inactive) and w.
__device__ void born_tile(const Params& p, const Smem& s, int t, int slot,
                          int lane) {
  const TilePair tp = tile_pair(p, t, lane);
  const int i = tp.i;
  const float xi = s.x[i], yi = s.y[i], zi = s.z[i], qi = s.q[i];
  const float rmhi = s.rmh[i], sepsi = s.seps[i];
  const float oradi = s.orad[i], sri = s.sr[i];
  const float* qrow = p.qq + (size_t)(tp.rowok ? i : 0) * p.A + tp.J * kTile;
  float* cache = s.cache + (size_t)slot * kCache;
  float row = 0.f, col = 0.f;
  for (int k = 0; k < kTile; ++k) {
    const int c = (lane + k) & (kTile - 1), j = tp.J * kTile + c;
    float Iij = 0.f, Iji = 0.f, Dij = 0.f, Dji = 0.f, w = 0.f;
    if (counts(p, tp, c, lane, j)) {
      float dx, dy, dz;
      delta(p, xi, yi, zi, s, j, dx, dy, dz);
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float inv_r = rsqrtf(r2), r = r2 * inv_r, inv_r2 = inv_r * inv_r;
      w = pair_w(p, r, inv_r, inv_r2, qi, s.q[j], rmhi + s.rmh[j],
                 sepsi * s.seps[j], __ldg(qrow + c));
      const float srj = s.sr[j], oradj = s.orad[j];
      if (active(r, srj, oradi)) {
        const LU lu = lu_terms(r, srj, oradi);
        Iij = descreen(lu, r, inv_r, srj, oradi);
        Dij = dI_dr(lu, r, inv_r, inv_r2, srj, oradi) * inv_r;
      }
      if (active(r, sri, oradj)) {
        const LU lu = lu_terms(r, sri, oradj);
        Iji = descreen(lu, r, inv_r, sri, oradj);
        Dji = dI_dr(lu, r, inv_r, inv_r2, sri, oradj) * inv_r;
      }
    }
    row += Iij;
    col += Iji;
    cache[k * kTile + lane] = Dij;
    cache[kTile * kTile + k * kTile + lane] = Dji;
    cache[2 * kTile * kTile + k * kTile + lane] = w;
    col = __shfl_sync(kFull, col, (lane + 1) & (kTile - 1));
  }
  float* part = s.part + slot * kPart;
  part[lane] = row;
  part[kTile + lane] = col;
}

// Pass 2 of a tile pair: the sums of the GB pair term of dE/dB_i (row) and
// dE/dB_j (column), without their factor 2; w + 2 dE/dr^2 into the cache.
__device__ void gb_pair_tile(const Params& p, const Smem& s, int t, int slot,
                             int lane) {
  const TilePair tp = tile_pair(p, t, lane);
  const int i = tp.i;
  const float xi = s.x[i], yi = s.y[i], zi = s.z[i], qi = s.q[i];
  const float Bi = s.B[i], invBi = s.invB[i];
  float* wc = s.cache + (size_t)slot * kCache + 2 * kTile * kTile;
  float row = 0.f, col = 0.f;
  for (int k = 0; k < kTile; ++k) {
    const int c = (lane + k) & (kTile - 1), j = tp.J * kTile + c;
    float bj = 0.f, bi = 0.f;
    if (counts(p, tp, c, lane, j)) {
      float dx, dy, dz;
      delta(p, xi, yi, zi, s, j, dx, dy, dz);
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float Bj = s.B[j];
      const float tt = r2 * (0.25f * invBi) * s.invB[j];
      const float expo = expf(-tt);
      const float f2 = r2 + Bi * Bj * expo;
      const float rsf = rsqrtf(f2);
      const float finv3 = rsf * rsf * rsf;
      const float pq = p.pref * (qi * s.q[j]) * (-0.5f) * finv3;
      const float base = pq * expo * (1.f + tt);
      wc[k * kTile + lane] += 2.f * (2.f * pq * (1.f - expo / 4.f));
      bj = base * Bj;
      bi = base * Bi;
    }
    row += bj;
    col += bi;
    col = __shfl_sync(kFull, col, (lane + 1) & (kTile - 1));
  }
  float* part = s.part + slot * kPart;
  part[lane] = row;
  part[kTile + lane] = col;
}

// The force pass of a tile pair: -c d into the row sums, +c d into the
// column sums.  With OBC2, c = (w + 2 dE/dr^2) + g_i dI_ij/dr / r +
// g_j dI_ji/dr / r from the cache; without, c = w computed here.
__device__ void force_tile(const Params& p, const Smem& s, int t, int slot,
                           int lane) {
  const TilePair tp = tile_pair(p, t, lane);
  const int i = tp.i;
  const float xi = s.x[i], yi = s.y[i], zi = s.z[i], qi = s.q[i];
  const float rmhi = s.rmh[i], sepsi = s.seps[i], gi = s.g[i];
  const float* qrow = p.qq + (size_t)(tp.rowok ? i : 0) * p.A + tp.J * kTile;
  const float* cache = s.cache + (size_t)slot * kCache;
  float rx = 0.f, ry = 0.f, rz = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
  for (int k = 0; k < kTile; ++k) {
    const int c = (lane + k) & (kTile - 1), j = tp.J * kTile + c;
    float ex = 0.f, ey = 0.f, ez = 0.f;
    if (counts(p, tp, c, lane, j)) {
      float dx, dy, dz;
      delta(p, xi, yi, zi, s, j, dx, dy, dz);
      float cc;
      if (p.use_gb) {
        const int e = k * kTile + lane;
        cc = cache[2 * kTile * kTile + e] + gi * cache[e] +
             s.g[j] * cache[kTile * kTile + e];
      } else {
        const float r2 = dx * dx + dy * dy + dz * dz;
        const float inv_r = rsqrtf(r2), r = r2 * inv_r;
        cc = pair_w(p, r, inv_r, inv_r * inv_r, qi, s.q[j], rmhi + s.rmh[j],
                    sepsi * s.seps[j], __ldg(qrow + c));
      }
      ex = cc * dx;
      ey = cc * dy;
      ez = cc * dz;
    }
    rx -= ex;
    ry -= ey;
    rz -= ez;
    cx += ex;
    cy += ey;
    cz += ez;
    const int src = (lane + 1) & (kTile - 1);
    cx = __shfl_sync(kFull, cx, src);
    cy = __shfl_sync(kFull, cy, src);
    cz = __shfl_sync(kFull, cz, src);
  }
  float* part = s.part + slot * kPart;
  part[lane] = rx;
  part[kTile + lane] = cx;
  part[64 + lane] = ry;
  part[64 + kTile + lane] = cy;
  part[128 + lane] = rz;
  part[128 + kTile + lane] = cz;
}

// The sums of NQ quantities for atom 32 T + lane over the tile pairs that
// hold tile T, in ascending order of the other tile U: the column partial
// of (U, T) for U < T, the row and then the column partial of (T, T), the
// row partial of (T, U) for U > T.  The partials are read from the block
// that ran each tile pair, through distributed shared memory; all loads are
// issued before the additions.
template <int NQ>
__device__ __forceinline__ void gather(const Params& p, cg::cluster_group& cl,
                                       const Smem& s, int T, int lane,
                                       float out[NQ]) {
  const int CL = (int)cl.num_blocks();
  float v[kMaxTiles][NQ], dcol[NQ];
#pragma unroll
  for (int U = 0; U < kMaxTiles; ++U) {
    if (U < p.nt) {
      const int t = U < T ? tp_index(U, T, p.nt) : tp_index(T, U, p.nt);
      const float* pr =
          cl.map_shared_rank(s.part, t % CL) + (t / CL) * kPart + lane;
      const int side = U < T ? kTile : 0;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        v[U][q] = pr[q * 64 + side];
        if (U == T) dcol[q] = pr[q * 64 + kTile];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) out[q] = 0.f;
#pragma unroll
  for (int U = 0; U < kMaxTiles; ++U) {
    if (U < p.nt) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        out[q] += v[U][q];
        if (U == T) out[q] += dcol[q];
      }
    }
  }
}

// Writes v to element a of the row `dst` in every block of the cluster.
__device__ __forceinline__ void broadcast(cg::cluster_group& cl, float* dst,
                                          int a, float v) {
  const int CL = (int)cl.num_blocks();
  for (int r = 0; r < CL; ++r) cl.map_shared_rank(dst, r)[a] = v;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    gb_force_kernel(const float* __restrict__ x, float* __restrict__ f,
                    Params p) {
  cg::cluster_group cl = cg::this_cluster();
  const int CL = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int walker = blockIdx.x / CL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  extern __shared__ float sm[];
  const Smem s = carve(sm, p);
  const int A = p.A, Ap = p.nt * kTile;

  // every block stages the whole walker; pad atoms get harmless values
  const float* xw = x + (size_t)walker * 3 * A;
  for (int k = threadIdx.x; k < Ap; k += blockDim.x) {
    const bool own = k < A;
    s.x[k] = own ? xw[3 * k + 0] : 0.f;
    s.y[k] = own ? xw[3 * k + 1] : 0.f;
    s.z[k] = own ? xw[3 * k + 2] : 0.f;
    s.q[k] = own ? p.tab[k] : 0.f;
    s.rmh[k] = own ? p.tab[A + k] : 0.f;
    s.seps[k] = own ? p.tab[2 * A + k] : 0.f;
    s.rad[k] = own ? p.tab[3 * A + k] : 1.f;
    s.orad[k] = own ? p.tab[4 * A + k] : 1.f;
    s.sr[k] = own ? p.tab[5 * A + k] : 0.f;
    s.B[k] = 1.f;
    s.invB[k] = 1.f;
    s.g[k] = 0.f;
    s.dBdpsi[k] = 0.f;
  }
  // the block's tile pairs are t = rank + CL * slot
  const int nslot = (p.ntp - rank + CL - 1) / CL;
  cl.sync();  // every block's rows are staged before any remote write

  if (p.use_gb) {
    // ---- pass 1: Born radius -------------------------------------------
    for (int sl = warp; sl < nslot; sl += W)
      born_tile(p, s, rank + CL * sl, sl, lane);
    cl.sync();
    for (int T = rank + CL * warp; T < p.nt; T += CL * W) {
      float Ii[1];
      gather<1>(p, cl, s, T, lane, Ii);
      const int a = T * kTile + lane;
      if (a < A) {
        const float oradi = s.orad[a], radi = s.rad[a];
        const float psi = Ii[0] * oradi;
        const float garg =
            psi - 0.8f * (psi * psi) + 4.85f * (psi * psi * psi);
        const float th = tanhf(garg);
        float Bi = 1.f / (1.f / oradi - th / radi);
        Bi = fmaxf(Bi, oradi);
        s.dBdpsi[a] = Bi * Bi * (1.f - th * th) *
                      (1.f - 1.6f * psi + 14.55f * (psi * psi)) / radi;
        broadcast(cl, s.B, a, Bi);
        broadcast(cl, s.invB, a, 1.f / Bi);
      }
    }
    cl.sync();

    // ---- pass 2: dE/dB and the chain factor ----------------------------
    for (int sl = warp; sl < nslot; sl += W)
      gb_pair_tile(p, s, rank + CL * sl, sl, lane);
    cl.sync();
    for (int T = rank + CL * warp; T < p.nt; T += CL * W) {
      float acc[1];
      gather<1>(p, cl, s, T, lane, acc);
      const int a = T * kTile + lane;
      if (a < A) {
        const float qi = s.q[a], invBi = s.invB[a], radi = s.rad[a];
        const float ra = radi + 0.14f;
        const float r3 = radi * radi * radi;
        const float iB2 = invBi * invBi;
        float dEdB = p.pref * (-(qi * qi) * invBi * invBi) +
                     kSA * (ra * ra) * (r3 * r3) * (iB2 * iB2 * iB2 * invBi);
        dEdB += 2.f * acc[0];
        broadcast(cl, s.g, a, dEdB * s.dBdpsi[a] * s.orad[a]);
      }
    }
    cl.sync();
  }

  // ---- pass 3: forces ----------------------------------------------------
  for (int sl = warp; sl < nslot; sl += W)
    force_tile(p, s, rank + CL * sl, sl, lane);
  cl.sync();
  float* fw = f + (size_t)walker * 3 * A;
  for (int T = rank + CL * warp; T < p.nt; T += CL * W) {
    float F[3];
    gather<3>(p, cl, s, T, lane, F);
    const int a = T * kTile + lane;
    if (a < A) {
      fw[3 * a + 0] = F[0];
      fw[3 * a + 1] = F[1];
      fw[3 * a + 2] = F[2];
    }
  }
  cl.sync();  // no block leaves while another still reads its partials
}

// Lets the kernel take `smem` bytes of dynamic shared memory and, above 8
// blocks, a non-portable cluster size (each set once, when first needed).
cudaError_t allow(size_t smem, int cluster) {
  static size_t smem_set = 48 * 1024;
  static bool nonportable = false;
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gb_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (cluster > 8 && !nonportable) {
    const cudaError_t err = cudaFuncSetAttribute(
        gb_force_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  return cudaSuccess;
}

}  // namespace

// x, f: (B, 3A) float32 row-major on the device; tab (6, A) and qq (A, A)
// float32 on the device.  One cluster of `cluster` blocks of 32 * `warps`
// threads per walker.  Returns a cudaError_t.
extern "C" int gb_force(const void* x, void* f, int B, int A, const void* tab,
                        const void* qq, int use_gb, int use_rf, float rc,
                        float krf, float coulomb, float pref, int periodic,
                        float bx, float by, float bz, float ibx, float iby,
                        float ibz, int cluster, int warps, void* stream) {
  if (A < 2 || A > kMaxAtoms || B < 1 || cluster < 1 ||
      cluster > kMaxCluster || warps < 1 || warps > kMaxWarps)
    return cudaErrorInvalidValue;
  Params p;
  p.tab = static_cast<const float*>(tab);
  p.qq = static_cast<const float*>(qq);
  p.A = A;
  p.nt = (A + kTile - 1) / kTile;
  p.ntp = p.nt * (p.nt + 1) / 2;
  p.nslot = (p.ntp + cluster - 1) / cluster;
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
  const size_t smem = smem_bytes(p.nt, p.nslot, use_gb);
  cudaError_t err = allow(smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gb_force_kernel,
                           static_cast<const float*>(x),
                           static_cast<float*>(f), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of `cluster` blocks the card can hold at once for this launch
// shape (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int gb_force_max_clusters(int A, int use_gb, int cluster,
                                     int warps) {
  if (A < 2 || A > kMaxAtoms || cluster < 1 || cluster > kMaxCluster ||
      warps < 1 || warps > kMaxWarps)
    return -1;
  const int nt = (A + kTile - 1) / kTile;
  const int nslot = (nt * (nt + 1) / 2 + cluster - 1) / cluster;
  const size_t smem = smem_bytes(nt, nslot, use_gb);
  if (allow(smem, cluster) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, gb_force_kernel, &cfg) !=
      cudaSuccess)
    return -1;
  return n;
}
