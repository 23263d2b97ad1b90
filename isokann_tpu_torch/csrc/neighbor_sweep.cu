// Cell-list pair sweep of large periodic systems: LJ + reaction-field (or
// Ewald real-space erfc) Coulomb forces of every pair within the cutoff,
// and under LJPME the real-space dispersion term.
// Two kernels, launched one after the other by neighbor_kernel.py: the
// layout (the plan's cell table and the records the sweep reads) and the
// sweep (a block of four warps per 32-slot tile of a cell's atoms and
// walker).
//
// Replaces the TPU kernel isokann_tpu/md/neighbor.py:neighbor_sweep_pallas
// (its body _nb_kernel_body, and the cell table its XLA side builds).  It
// computes that function: for each atom i, F_i = sum_j -2 dE/d(r^2)(r_ij)
// d_ij over the atoms j in different slots within the cutoff under
// minimum image, with the hard (1-2/1-3) exclusions masked by the window
// bitmask of the lower-index atom (bit d-1 for the partner d indices
// above, d <= 32) or the atom's far-partner table, the LJ well combined as
// sqrt(eps_i) sqrt(eps_j), and Coulomb as the reaction field or, given
// alpha, the erfc real-space term through the Abramowitz-Stegun erfc.
// Given use_ljpme it adds q6_i q6_j dh/d(r^2) for every such pair, h(r) =
// (1 - g6(beta r)) / r^6 the long-range dispersion kernel
// (isokann_tpu/md/ewald.py:ljpme_hker_grad, with its series branch below
// u = (beta r)^2 = 0.1225).  The TPU kernel left LJPME to its XLA sweep:
// its 8-lane layout had no q6 lane.  The records need none: q6 = sqrt(2
// eps) (2 Rmin/2)^3, so q6_i q6_j = 128 sqrt(eps_i) sqrt(eps_j) (Rmin_i/2
// Rmin_j/2)^3 from the words 4 and 5 each record holds.  The box is a
// launch argument, so a box that changes from launch to launch (the NPT
// barostat's volume moves) needs no rebuilt table.  The caller adds the
// 1-4 corrections and the bonded terms.
//
// Bound on this card: operations.  Each walker reads 12 bytes and writes
// 12 bytes per atom; the work is the pair math of the ~400 partners each
// atom has within the cutoff at liquid density (neighbor_kernel.step_ops:
// 63 operations an unordered pair in cutoff for the reaction field), so
// the least time is operations / the FP32 non-tensor peak (67 TFLOP/s on an
// H100 SXM).  Three things keep a sweep from it: slots tested that lie
// beyond the cutoff; at one walker (randx0), too few warps to fill 132
// SMs; and lanes idle in the pair math while another lane of the warp has
// a partner in range.  The plan's grid is chosen by the reference's cost
// model for its TPU: few large cells (5 x 4 x 1 of capacity 696 for the
// 7,744-atom box), so one block per cell would leave most of the card
// idle, and testing every slot of the 9 stencil cells would test ~31
// slots for each partner in range.
//
// What the design does about it.  The layout orders each cell's kept
// slots by sub-cells of edge >= rc/2 in a serpentine order into whole
// 32-slot tiles, so that a tile is spatially compact, and gives each tile
// its bounding box and live count (it writes no empty slot: nothing reads
// one).  A block owns one
// (cell, tile, walker): 440 blocks of 4 warps at one walker on that plan.
// For each cell of the full stencil the lanes test one neighbour tile each,
// box against box under minimum image (a ballot gives the tiles within the
// cutoff); the block's warps take the surviving tiles in turn.  A warp
// stages a tile's records in its shared memory (lane k loads record k and
// tests its distance to the tile's own box: a second ballot gives the
// records that can have a partner), and every lane computes its atom
// against those records, read as broadcasts: ~7.5 slots tested for each
// pair in range instead of ~31.  Each pair is computed from both sides: no
// two blocks write the same atom, so there are no atomics; each lane sums
// in double in a fixed order and the warps' sums are added in warp order,
// so the same input gives the same bits.  The culling tests keep 1e-4 nm
// of slack, far above the rounding of the coordinates, so they never drop
// a pair the plain version counts.  A slot dropped by an overflowing cell
// is not in the records and writes nothing (the wrapper zeroes the
// output).  Newton's third law is not used: its reaction forces would
// need per-tile partial sums in device memory and a second pass to add
// them per atom in a fixed order, and at one walker, where the paths call
// the sweep most, the time goes to latency and idle lanes, not to pair
// operations.

#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 4;          // warps per tile, sharing its j tiles
constexpr int kTile = 32;          // slots per tile, one per lane
constexpr int kMaxFar = 8;         // far-partner table width
constexpr unsigned kAll = 0xffffffffu;
constexpr float kSlack = 1e-4f;    // nm, culling margin

struct Params {
  const float4* slots;  // (B, ncells, T * 32, 2) float4 records
  const float4* boxes;  // (B, ncells, T, 2): lo.xyz nlive, hi.xyz -
  const int* full;      // (ncells, nfull) cells of the full stencil
  const int* far;       // (n + 1, E2) far partners, -1 padded
  float* f;             // (B, 3 n) forces
  int n, ncells, T, nfull, E2, use_erfc, use_ljpme;
  float bx, by, bz, ibx, iby, ibz, rc2, krf, coulomb, alpha, alpha2, a_spi;
  float beta2, beta8;  // LJPME: beta^2, beta^8
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

// dh/d(r^2) of the dispersion kernel h, rounded per operation in the plain
// version's order (neighbor_kernel.ljpme_dh)
__device__ __forceinline__ float ljpme_dh(float r2, float beta2,
                                          float beta8) {
  const float u = __fmul_rn(beta2, r2);
  if (u < 0.1225f)
    return __fmul_rn(beta8, __fadd_rn(-0.125f, __fmul_rn(u, 0.1f)));
  const float e = expf(-u);
  const float omg = __fsub_rn(
      1.f, __fmul_rn(__fadd_rn(1.f, __fmul_rn(u, __fadd_rn(
                                        1.f, __fmul_rn(0.5f, u)))),
                     e));
  const float r6 = __fmul_rn(__fmul_rn(r2, r2), r2);
  return __fsub_rn(
      __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(beta2, u), u), e),
                __fmul_rn(2.f, r6)),
      __fdiv_rn(__fmul_rn(3.f, omg), __fmul_rn(r6, r2)));
}

// Distance beyond the slack between two intervals (centres c, half widths
// h) on a periodic axis of length L: a lower bound of the minimum-image
// distance between any two of their points.
__device__ __forceinline__ float gap(float c, float h, float L, float iL) {
  c -= L * rintf(c * iL);
  return fmaxf(fabsf(c) - h - kSlack, 0.f);
}

__global__ void __launch_bounds__(kTile * kSplit)
    neighbor_sweep_kernel(Params p) {
  __shared__ float4 sj[kSplit][2 * kTile];  // each warp's staged records
  __shared__ double part[kSplit][kTile][3];  // each warp's partial sums
  const int warp = threadIdx.x / kTile, lane = threadIdx.x % kTile;
  const int g = blockIdx.x;
  const int cell = g / p.T, tile = g % p.T;
  const int b = blockIdx.y;
  const int Cp = p.T * kTile;
  const float4* rec = p.slots + (size_t)b * p.ncells * Cp * 2;
  const float4* box = p.boxes + (size_t)b * p.ncells * p.T * 2;

  // the warp's tile: its box (centre, half widths) and this lane's atom
  const float4 lo = box[2 * g], hi = box[2 * g + 1];
  const int nlive = (int)lo.w;
  if (nlive == 0) return;  // an empty tile: the whole block returns
  const float cx = 0.5f * (lo.x + hi.x), cy = 0.5f * (lo.y + hi.y),
              cz = 0.5f * (lo.z + hi.z);
  const float hx = 0.5f * (hi.x - lo.x), hy = 0.5f * (hi.y - lo.y),
              hz = 0.5f * (hi.z - lo.z);
  const bool live = lane < nlive;
  float4 ai = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 bi = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    ai = rec[((size_t)cell * Cp + tile * kTile + lane) * 2 + 0];
    bi = rec[((size_t)cell * Cp + tile * kTile + lane) * 2 + 1];
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
  int nth = 0;  // surviving j tiles so far: warp w takes every kSplit-th
  for (int s = 0; s < p.nfull; ++s) {
    const int cj = p.full[cell * p.nfull + s];
    const float4* cbox = box + (size_t)cj * p.T * 2;
    for (int t0 = 0; t0 < p.T; t0 += kTile) {
      // lane k tests tile t0 + k of cell cj against the warp's box
      const int jt = t0 + lane;
      int nl = 0;
      bool near = false;
      if (jt < p.T) {
        const float4 l2 = cbox[2 * jt], h2 = cbox[2 * jt + 1];
        nl = (int)l2.w;
        if (nl > 0) {
          const float gx = gap(cx - 0.5f * (l2.x + h2.x),
                               hx + 0.5f * (h2.x - l2.x), p.bx, p.ibx);
          const float gy = gap(cy - 0.5f * (l2.y + h2.y),
                               hy + 0.5f * (h2.y - l2.y), p.by, p.iby);
          const float gz = gap(cz - 0.5f * (l2.z + h2.z),
                               hz + 0.5f * (h2.z - l2.z), p.bz, p.ibz);
          near = gx * gx + gy * gy + gz * gz < p.rc2;
        }
      }
      unsigned tiles = __ballot_sync(kAll, near);
      while (tiles) {
        const int k = __ffs(tiles) - 1;
        tiles &= tiles - 1;
        if (nth++ % kSplit != warp) continue;
        const int nlj = __shfl_sync(kAll, nl, k);
        // lane q loads record q of the tile and tests it against the box
        float4 aj = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
        bool keep = false;
        if (lane < nlj) {
          const size_t r = ((size_t)cj * Cp + (t0 + k) * kTile + lane) * 2;
          aj = rec[r];
          bj = rec[r + 1];
          const float gx = gap(cx - aj.x, hx, p.bx, p.ibx);
          const float gy = gap(cy - aj.y, hy, p.by, p.iby);
          const float gz = gap(cz - aj.z, hz, p.bz, p.ibz);
          keep = gx * gx + gy * gy + gz * gz < p.rc2;
        }
        unsigned recs = __ballot_sync(kAll, keep);
        __syncwarp();  // the previous tile's records are no longer read
        sj[warp][2 * lane] = aj;
        sj[warp][2 * lane + 1] = bj;
        __syncwarp();
        if (oidi < 0) continue;
        while (recs) {
          const int q = __ffs(recs) - 1;
          recs &= recs - 1;
          // the geometry rounds once per operation (no fused multiply-add),
          // as the plain version's tensor ops do: both then draw the cutoff
          // through the same pairs, bit for bit
          const float4 ajq = sj[warp][2 * q];
          float dx = __fsub_rn(ai.x, ajq.x);
          float dy = __fsub_rn(ai.y, ajq.y);
          float dz = __fsub_rn(ai.z, ajq.z);
          dx = __fsub_rn(dx, __fmul_rn(p.bx, rintf(__fmul_rn(dx, p.ibx))));
          dy = __fsub_rn(dy, __fmul_rn(p.by, rintf(__fmul_rn(dy, p.iby))));
          dz = __fsub_rn(dz, __fmul_rn(p.bz, rintf(__fmul_rn(dz, p.ibz))));
          const float r2 = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz)),
              1e-12f);
          if (!(r2 < p.rc2)) continue;
          const float4 bjq = sj[warp][2 * q + 1];
          const int oidj = __float_as_int(bjq.z);
          if (oidj == oidi) continue;  // the same atom
          const int dd = oidj - oidi;
          bool excluded = false;
          if (dd >= 1 && dd <= 32)
            excluded = (bitsi >> (dd - 1)) & 1u;
          else if (dd <= -1 && dd >= -32)
            excluded = (__float_as_uint(bjq.w) >> (-dd - 1)) & 1u;
#pragma unroll
          for (int e = 0; e < kMaxFar; ++e) excluded |= (fari[e] == oidj);
          if (excluded) continue;

          // the pair terms round once per operation, in the plain version's
          // order (no fused multiply-add): both give the same bits per pair
          const float inv_r = rsqrtf(r2);
          const float inv_r2 = __fmul_rn(inv_r, inv_r);
          const float qq = __fmul_rn(p.coulomb, __fmul_rn(ai.w, ajq.w));
          const float rmin = __fadd_rn(bi.x, bjq.x);
          const float epsij = __fmul_rn(bi.y, bjq.y);
          float x6 = __fmul_rn(__fmul_rn(rmin, rmin), inv_r2);
          x6 = __fmul_rn(__fmul_rn(x6, x6), x6);
          const float g_lj =
              __fmul_rn(__fmul_rn(__fmul_rn(6.f, epsij),
                                  __fsub_rn(x6, __fmul_rn(x6, x6))),
                        inv_r2);
          float g_c;
          if (p.use_erfc) {
            const float er =
                erfc_approx(__fmul_rn(p.alpha, __fmul_rn(r2, inv_r)));
            const float gauss = expf(__fmul_rn(-p.alpha2, r2));
            g_c = __fmul_rn(
                -qq,
                __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, er), inv_r2),
                                    inv_r),
                          __fmul_rn(__fmul_rn(p.a_spi, gauss), inv_r2)));
          } else {
            g_c = __fadd_rn(
                __fmul_rn(qq, __fmul_rn(__fmul_rn(-0.5f, inv_r2), inv_r)),
                __fmul_rn(qq, p.krf));
          }
          float g = __fadd_rn(g_lj, g_c);
          if (p.use_ljpme) {
            const float rr = __fmul_rn(bi.x, bjq.x);
            const float c6 = __fmul_rn(__fmul_rn(128.f, epsij),
                                       __fmul_rn(__fmul_rn(rr, rr), rr));
            g = __fadd_rn(g, __fmul_rn(c6, ljpme_dh(r2, p.beta2, p.beta8)));
          }
          const float w = __fmul_rn(-2.f, g);
          fx += (double)__fmul_rn(w, dx);
          fy += (double)__fmul_rn(w, dy);
          fz += (double)__fmul_rn(w, dz);
        }
      }
    }
  }
  // the warps' partial sums, added in warp order
  part[warp][lane][0] = fx;
  part[warp][lane][1] = fy;
  part[warp][lane][2] = fz;
  __syncthreads();
  if (warp == 0 && oidi >= 0) {
    for (int w = 1; w < kSplit; ++w) {
      fx += part[w][lane][0];
      fy += part[w][lane][1];
      fz += part[w][lane][2];
    }
    float* fo = p.f + (size_t)b * 3 * p.n + 3 * (size_t)oidi;
    fo[0] = (float)fx;
    fo[1] = (float)fy;
    fo[2] = (float)fz;
  }
}


// ---- the layout: the plan's cell table and the kernel's records --------
//
// One block per walker, the function of neighbor_kernel.kernel_records
// with the same rounding, so both give the same bits: wrap each atom into
// the box and find its plan cell and its sub-cell rank; rank the atoms of
// each cell in index order (a cell keeps its first C, as the plan's stable
// sort does), and the kept atoms of each (cell, sub-cell) in index order;
// write each kept atom's record at its cell's sub-cell offset plus that
// rank, and each tile's box and live count.  The slots behind a cell's
// kept atoms are not written: the sweep reads no record past a tile's
// live count, so they are not part of the function.  No sort and no
// atomics: each of W warps walks its own range of atoms 32 at a time
// (__match_any_sync groups the lanes of a key) and counts per key; the
// counts of the ranges before it are its offsets.

constexpr int kLayoutThreads = 256;

struct LayoutParams {
  const float* x;       // (B, n, 3) coordinates
  const float* atoms;   // (n + 1, 5): q, Rmin/2, sqrt(eps), id, bits
  const int* srank;     // (nsub,) serpentine rank of each sub-cell
  int* scratch;         // (B, 3, n): cell, sub-cell rank, kept (0 / -1)
  float4* rec;          // (B, ncells, T * 32, 2)
  float4* boxes;        // (B, ncells, T, 2)
  int n, ncells, C, T, nsub, W;
  int nc[3], ns[3];
  float box[3], cell[3], scale[3];
};

__device__ __forceinline__ float wrap(float x, float L) {
  return __fsub_rn(x, __fmul_rn(L, floorf(__fdiv_rn(x, L))));
}

// Offsets of the 32 atoms a0 + lane of one warp's range among the atoms of
// their key (`key` < 0: none), from the warp's running counts `run`: the
// lanes of a key take consecutive offsets in lane order and the count
// advances past them.  Returns -1 for a lane without a key.
__device__ __forceinline__ int rank_in(int key, int* run, int lane) {
  const unsigned peers = __match_any_sync(kAll, key < 0 ? -1 - lane : key);
  const int lead = __ffs(peers) - 1;
  int base = (key >= 0 && lane == lead) ? run[key] : 0;
  base = __shfl_sync(kAll, base, lead);
  if (key >= 0 && lane == lead) run[key] = base + __popc(peers);
  __syncwarp();  // this chunk's counts before the next chunk reads them
  return key < 0 ? -1 : base + __popc(peers & ((1u << lane) - 1u));
}

// Exclusive prefix over the W warps of the counts cnt[w * m + k].
__device__ __forceinline__ void warp_prefix(int* cnt, int W, int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    int run = 0;
    for (int w = 0; w < W; ++w) {
      const int v = cnt[w * m + k];
      cnt[w * m + k] = run;
      run += v;
    }
  }
}

__global__ void __launch_bounds__(kLayoutThreads)
    neighbor_layout_kernel(LayoutParams p) {
  // per warp: cell counts (ncells) | kept (cell, sub) counts (ncells nsub);
  // then the (cell, sub) starts and each cell's kept count
  extern __shared__ int smem_i[];
  const int nk2 = p.ncells * p.nsub;
  int* wc1 = smem_i;
  int* wc2 = wc1 + p.W * p.ncells;
  int* start2 = wc2 + p.W * nk2;
  int* kept = start2 + nk2;
  const int b = blockIdx.x, n = p.n, Cp = p.T * kTile;
  const float* x = p.x + (size_t)b * n * 3;
  int* cid = p.scratch + (size_t)b * 3 * n;
  int* key = cid + n;
  int* keep = key + n;
  float4* rec = p.rec + (size_t)b * p.ncells * Cp * 2;
  float4* boxes = p.boxes + (size_t)b * p.ncells * p.T * 2;
  const int warp = threadIdx.x / kTile, lane = threadIdx.x % kTile;
  for (int k = threadIdx.x; k < p.W * (p.ncells + nk2); k += blockDim.x)
    smem_i[k] = 0;

  // each atom's plan cell and sub-cell rank
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    int cd[3], sd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float xw = wrap(x[3 * a + k], p.box[k]);
      const long long q = (long long)__fdiv_rn(xw, p.cell[k]);
      cd[k] = (int)min(max(q, 0ll), (long long)(p.nc[k] - 1));
      const float u = floorf(__fsub_rn(__fmul_rn(xw, p.scale[k]),
                                        (float)(cd[k] * p.ns[k])));
      sd[k] = min(max((int)u, 0), p.ns[k] - 1);
    }
    cid[a] = (cd[0] * p.nc[1] + cd[1]) * p.nc[2] + cd[2];
    key[a] = p.srank[(sd[0] * p.ns[1] + sd[1]) * p.ns[2] + sd[2]];
  }
  __syncthreads();

  // warp w < W walks atoms [lo, hi), a multiple of 32 long
  const int span = ((n + p.W * kTile - 1) / (p.W * kTile)) * kTile;
  const int lo = warp * span, hi = min(n, lo + span);
  const bool ranks = warp < p.W;
  // pass 1: the cells' counts in each range
  if (ranks)
    for (int a0 = lo; a0 < hi; a0 += kTile) {
      const int a = a0 + lane;
      rank_in(a < hi ? cid[a] : -1, wc1 + warp * p.ncells, lane);
    }
  __syncthreads();
  warp_prefix(wc1, p.W, p.ncells);
  __syncthreads();
  // pass 2: each atom's rank in its cell (kept below C); the kept
  // (cell, sub) counts in each range
  if (ranks)
    for (int a0 = lo; a0 < hi; a0 += kTile) {
      const int a = a0 + lane;
      const int c = a < hi ? cid[a] : -1;
      const int r = rank_in(c, wc1 + warp * p.ncells, lane);
      const bool kp = c >= 0 && r < p.C;
      if (a < hi) keep[a] = kp ? 0 : -1;
      rank_in(kp ? c * p.nsub + key[a] : -1, wc2 + warp * nk2, lane);
    }
  __syncthreads();
  // each (cell, sub)'s total, its first slot in sub-cell rank order, and
  // each cell's kept count
  for (int k = threadIdx.x; k < nk2; k += blockDim.x) {
    int run = 0;
    for (int w = 0; w < p.W; ++w) run += wc2[w * nk2 + k];
    start2[k] = run;
  }
  __syncthreads();
  warp_prefix(wc2, p.W, nk2);
  for (int c = threadIdx.x; c < p.ncells; c += blockDim.x) {
    int run = 0;
    for (int s = 0; s < p.nsub; ++s) {
      const int v = start2[c * p.nsub + s];
      start2[c * p.nsub + s] = run;
      run += v;
    }
    kept[c] = run;
  }
  __syncthreads();
  // pass 3: each kept atom's record at its (cell, sub) start plus its rank
  if (ranks)
    for (int a0 = lo; a0 < hi; a0 += kTile) {
      const int a = a0 + lane;
      const int k2 = (a < hi && keep[a] == 0) ? cid[a] * p.nsub + key[a] : -1;
      const int r = rank_in(k2, wc2 + warp * nk2, lane);
      if (k2 < 0) continue;
      const size_t slot = (size_t)cid[a] * Cp + start2[k2] + r;
      const float* t = p.atoms + (size_t)a * 5;
      rec[2 * slot] = make_float4(wrap(x[3 * a], p.box[0]),
                                  wrap(x[3 * a + 1], p.box[1]),
                                  wrap(x[3 * a + 2], p.box[2]), t[0]);
      rec[2 * slot + 1] = make_float4(t[1], t[2], t[3], t[4]);
    }
  __syncthreads();  // the records are written

  // each tile's box and live count, one warp a tile
  for (int g = warp; g < p.ncells * p.T; g += blockDim.x / kTile) {
    const int c = g / p.T, t = g % p.T;
    const int nl = min(max(kept[c] - t * kTile, 0), kTile);
    const float inf = __int_as_float(0x7f800000);
    float lo3[3] = {inf, inf, inf};
    float hi3[3] = {-inf, -inf, -inf};
    if (lane < nl) {
      const float4 r = rec[2 * ((size_t)c * Cp + t * kTile + lane)];
      lo3[0] = hi3[0] = r.x;
      lo3[1] = hi3[1] = r.y;
      lo3[2] = hi3[2] = r.z;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo3[k] = fminf(lo3[k], __shfl_xor_sync(kAll, lo3[k], o));
        hi3[k] = fmaxf(hi3[k], __shfl_xor_sync(kAll, hi3[k], o));
      }
    if (lane == 0) {
      boxes[2 * g] = make_float4(lo3[0], lo3[1], lo3[2], (float)nl);
      boxes[2 * g + 1] = make_float4(hi3[0], hi3[1], hi3[2], 0.f);
    }
  }
}

}  // namespace

// slots: (B, ncells, T * 32, 8) float32 records on the device (ids and
// bits as int32 bit patterns); boxes: (B, ncells, T, 8) float32; full:
// (ncells, nfull) int32; far: (n + 1, E2) int32; f: (B, 3 n) float32,
// zeroed by the caller.  Returns a cudaError_t.
extern "C" int neighbor_sweep(const void* slots, const void* boxes,
                              const void* full, const void* far, void* f,
                              int B, int n, int ncells, int T, int nfull,
                              int E2, int use_erfc, int use_ljpme, float bx,
                              float by, float bz, float ibx, float iby,
                              float ibz, float rc2, float krf, float coulomb,
                              float alpha, float alpha2, float a_spi,
                              float beta2, float beta8, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || E2 < 1 || E2 > kMaxFar || nfull < 1 ||
      ncells < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.slots = static_cast<const float4*>(slots);
  p.boxes = static_cast<const float4*>(boxes);
  p.full = static_cast<const int*>(full);
  p.far = static_cast<const int*>(far);
  p.f = static_cast<float*>(f);
  p.n = n;
  p.ncells = ncells;
  p.T = T;
  p.nfull = nfull;
  p.E2 = E2;
  p.use_erfc = use_erfc;
  p.use_ljpme = use_ljpme;
  p.beta2 = beta2;
  p.beta8 = beta8;
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
  const dim3 grid(ncells * T, B);
  neighbor_sweep_kernel<<<grid, kTile * kSplit, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// x: (B, n, 3) float32; atoms: (n + 1, 5) float32 (ids and bits as int32
// bit patterns); srank: (prod ns) int32; scratch: (B, 3, n) int32; rec:
// (B, ncells, T * 32, 8) float32, each tile's first `live` records written
// (the rest left as they were); boxes: (B, ncells, T, 8) float32, written
// whole.  Returns a cudaError_t.
extern "C" int neighbor_layout(const void* x, const void* atoms,
                               const void* srank, void* scratch, void* rec,
                               void* boxes, int B, int n, int ncells, int C,
                               int T, int nc0, int nc1, int nc2, int ns0,
                               int ns1, int ns2, float bx, float by, float bz,
                               float cx, float cy, float cz, float sx,
                               float sy, float sz, void* stream) {
  LayoutParams p;
  p.x = static_cast<const float*>(x);
  p.atoms = static_cast<const float*>(atoms);
  p.srank = static_cast<const int*>(srank);
  p.scratch = static_cast<int*>(scratch);
  p.rec = static_cast<float4*>(rec);
  p.boxes = static_cast<float4*>(boxes);
  p.n = n;
  p.ncells = ncells;
  p.C = C;
  p.T = T;
  p.nsub = ns0 * ns1 * ns2;
  p.nc[0] = nc0; p.nc[1] = nc1; p.nc[2] = nc2;
  p.ns[0] = ns0; p.ns[1] = ns1; p.ns[2] = ns2;
  p.box[0] = bx; p.box[1] = by; p.box[2] = bz;
  p.cell[0] = cx; p.cell[1] = cy; p.cell[2] = cz;
  p.scale[0] = sx; p.scale[1] = sy; p.scale[2] = sz;
  // as many ranking warps (<= 8) as their counts fit in shared memory
  const size_t per_warp = sizeof(int) * (size_t)ncells * (p.nsub + 1);
  const size_t fixed = sizeof(int) * (size_t)ncells * (p.nsub + 1);
  const size_t limit = 227 * 1024;
  p.W = fixed + per_warp > limit
            ? 0
            : (int)min((size_t)(kLayoutThreads / kTile),
                       (limit - fixed) / per_warp);
  const size_t smem = fixed + per_warp * p.W;
  if (B < 1 || n < 1 || C < 1 || T * kTile < C || p.W < 1)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        neighbor_layout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  neighbor_layout_kernel<<<B, kLayoutThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
