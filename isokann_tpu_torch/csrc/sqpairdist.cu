// Squared pair distances by direct differences (kernel C) and their gradient
// (kernel C'), for a batch of walkers (B, N, 3) float32.
//
// Replaces the TPU kernels isokann_tpu/ops/pairdists.py:_sqpairdist_fwd_impl
// and _sqpairdist_bwd_impl, the forward and the custom-VJP backward of
// sqpairdist_fused.  They compute:
//   C:  p[b, i, j] = |x_i - x_j|^2, accumulated as the TPU body does:
//       acc = dx*dx; acc += dy*dy; acc += dz*dz, every operation rounded
//       (__fsub_rn / __fmul_rn / __fadd_rn: no fused multiply-add), so that
//       the plain version (ops/pairdists_kernel.py:sqpairdist_fwd_plain),
//       one rounded tensor operation per step, gives the same bits;
//   C': dx_i = 2 sum_j s_ij (x_i - x_j), s = dp + dp^T.  The TPU wrote the
//       same function as 2 (x_i rowsum(s)_i - (s x)_i) with an MXU product;
//       the difference form does not cancel between two large terms.  Every
//       s_ij, difference, product and sum is a rounded double operation
//       (__dadd_rn / __dsub_rn / __dmul_rn, no contraction), rounded once to
//       float at the end, as the plain version does in float64.
//
// Not the TPU's layout.  The TPU padded N to a multiple of 128 lanes and the
// three coordinates to 8, and ran one grid step per walker holding the whole
// (Np, Np) block in VMEM.
//
// C: one block per (j-tile, i-tile, walker) of 32 x 32 pairs, 32 x 8
// threads; both tiles' coordinates are staged in shared memory, thread
// (tx, ty) computes rows ty, ty + 8, ... of column j0 + tx, so a warp writes
// 32 consecutive floats of a row.  Bound: bytes (4 B N^2 written).
//
// C': each element of dp is read from device memory once, in two kernels.
//   Pass 1, the tile pairs.  The atoms go into 32-atom tiles; the work is the
//   nt (nt + 1) / 2 tile pairs (I, J), J >= I.  A warp loads dp[I, J] and
//   dp[J, I] (one tile on the diagonal) with the coordinates of both tiles,
//   and for every pair of the tile pair adds p = s_ij (x_i - x_j) to the row
//   atom i and subtracts it from the column atom j (on the diagonal tile
//   pair only the row sums, over all 32 x 32 ordered pairs).  Lane 4 g + h
//   owns rows 4 g .. 4 g + 3 and columns 8 h .. 8 h + 7: 32 pairs, their
//   3 x 4 row and 3 x 8 column sums in registers, each coordinate converted
//   to double once a tile pair into the warp's shared memory.  The row sums
//   are then reduced over the four lanes of a row group and the column sums
//   over the eight lanes of a column group by recursive halving
//   (__shfl_xor_sync, 60 shuffles a lane and tile pair instead of 6 a pair),
//   after which lane l holds row atom l and column atom 8 (l % 4) + l / 4.
//   The tile pair's row and column partial sums (1,536 bytes) go to a device
//   buffer that the wrapper allocates.
//   Pass 2, three warps per (tile, walker), one a coordinate: atom a of tile
//   T adds, in ascending order of the other tile U, the column partial of
//   (U, T) for U < T, then the row partials of (T, U) for U >= T, and writes
//   2 acc rounded to float.
//   Loads.  Each warp runs its own ring of two stages in shared memory: the
//   next tile pair is copied by cp.async while the current one is summed.
//   Rows of dp are copied 16 bytes at a time where N % 4 == 0 (villin's 588)
//   and dp is 16-byte aligned, 4 bytes otherwise; the ragged edge is
//   zero-filled by the copy (src-size 0), so padded pairs add s = 0.  A tile
//   is stored as rows of eight 16-byte chunks, chunk q of row r at
//   q ^ (r / 4): the lanes' float4 reads of their rows of dp[I, J] and of
//   their columns' rows of dp[J, I] are then free of bank conflicts.
//   Shape.  blockIdx = (rank, walker), G blocks of W warps a walker
//   (ops/pairdists_kernel.py:launch_shape): tile pair t goes to block
//   t mod G and there to warp (t / G) mod W.  G fills one wave of two blocks
//   an SM where the batch is small, down to a tile pair a warp at B = 1, so
//   one walker spreads over the card, and gives at most six tile pairs a
//   warp otherwise.  Pass 2 is launched as a programmatic dependent of pass
//   1, so its launch overlaps pass 1's last blocks.
//   No atomics: the order of every sum depends on the tile indices only, so
//   a walker's dx is the same bits at every batch size, launch shape and
//   repeat, and equals the tensor-op mirror
//   ops/pairdists_kernel.py:sqpairdist_bwd_tiled.
//   Measured and not kept (NVIDIA H100 80GB HBM3, 700 W; PERF.md): a
//   thread-block cluster per walker with the partials in distributed shared
//   memory (1.00x step_bytes, but the 32 clusters of B = 32 did not fit on
//   the card at once: 0.0506 ms cold against this design's 0.0371,
//   tools/pairdist_split.py), and a ring of three stages (no faster,
//   tools/pairdist_variants.py).
//
// Bound on this card: bytes.  C' reads 4 B N^2 bytes of dp for 10 operations
// a pair (ops/pairdists_kernel.py:step_ops): at N = 588 the memory rate
// (3.35 TB/s) allows 13.3 us at B = 32 and 0.427 ms at B = 1024, the FP32
// peak a tenth of that.  The partials, written once and read once, make
// kernel_bytes / step_bytes 1.40 at N = 588.  The FP64 work is 13
// operations and 2 conversions an unordered pair; it overlaps with the
// loads, because each warp sums one tile pair while cp.async fetches the
// next and eight warps share an SM: with the arithmetic in float32 the
// kernel was no faster (tools/pairdist_variants.py).  The coordinates of a
// tile pair are re-read per tile pair (768 bytes against dp's 8 KB) from
// the L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // atoms of a tile side
constexpr int kRows = 8;   // threadIdx.y extent of C's block

__global__ void sqpairdist_fwd_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, int N) {
  __shared__ float xi[kTile * 3];
  __shared__ float xj[kTile * 3];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* xb = x + (size_t)b * N * 3;
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (t < kTile * 3) {
    xi[t] = (i0 * 3 + t < N * 3) ? xb[i0 * 3 + t] : 0.f;
  } else if (t < 2 * kTile * 3) {
    const int u = t - kTile * 3;
    xj[u] = (j0 * 3 + u < N * 3) ? xb[j0 * 3 + u] : 0.f;
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= N) return;
  const float xjx = xj[3 * threadIdx.x], xjy = xj[3 * threadIdx.x + 1],
              xjz = xj[3 * threadIdx.x + 2];
  float* ob = out + (size_t)b * N * N;
  for (int r = threadIdx.y; r < kTile && i0 + r < N; r += kRows) {
    const float dx = __fsub_rn(xi[3 * r], xjx);
    const float dy = __fsub_rn(xi[3 * r + 1], xjy);
    const float dz = __fsub_rn(xi[3 * r + 2], xjz);
    float acc = __fmul_rn(dx, dx);
    acc = __fadd_rn(acc, __fmul_rn(dy, dy));
    acc = __fadd_rn(acc, __fmul_rn(dz, dz));
    ob[(size_t)(i0 + r) * N + j] = acc;
  }
}

// ---- C' ---------------------------------------------------------------------

constexpr int kMaxWarps = 8;
constexpr int kTileF = kTile * kTile;  // floats of a dp tile
constexpr int kXF = 3 * kTile;         // floats of a tile's coordinates
constexpr int kStageF = 2 * kTileF + 2 * kXF;  // a stage of the ring
constexpr int kStages = 2;             // stages of a warp's ring
constexpr int kPart = 2 * 3 * kTile;   // doubles: row[3][32], col[3][32]
// a warp's shared memory: the tile pair's coordinates in double, the ring
constexpr int kWarpBytes = 2 * kXF * 8 + kStages * kStageF * 4;
constexpr unsigned kFull = 0xffffffffu;

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

// Element (r, c) of a tile in shared memory: chunk c / 4 of row r at chunk
// (c / 4) ^ (r / 4).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTile + ((((c >> 2) ^ (r >> 2)) & 7) << 2) + (c & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kStages - 1 groups of this thread are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// dp[r0 .. r0 + 31][c0 .. c0 + 31] of a walker into tile t, zeros outside N.
template <bool kVec>
__device__ __forceinline__ void load_tile(float* t, const float* g, int r0,
                                          int c0, int N, int lane) {
  if (kVec) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int k = lane + 32 * m, r = k >> 3, c = (k & 7) << 2;
      const bool ok = r0 + r < N && c0 + c < N;
      cp_async16(t + swz(r, c), ok ? g + (size_t)(r0 + r) * N + c0 + c : g,
                 ok);
    }
  } else {
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const bool ok = r0 + r < N && c0 + lane < N;
      cp_async4(t + swz(r, lane),
                ok ? g + (size_t)(r0 + r) * N + c0 + lane : g, ok);
    }
  }
}

// The coordinates of tile T of a walker (96 floats), zeros outside N.
__device__ __forceinline__ void load_coords(float* s, const float* xw, int T,
                                            int N, int lane) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int e = lane + 32 * m;
    const bool ok = kXF * T + e < 3 * N;
    cp_async4(s + e, ok ? xw + kXF * T + e : xw, ok);
  }
}

// Tile pair (I, J) into a stage: dp[I, J], dp[J, I], x of I, x of J (the
// second tile and coordinates only off the diagonal).
template <bool kVec>
__device__ __forceinline__ void load_pair(float* st, const float* g,
                                          const float* xw, int I, int J,
                                          int N, int lane) {
  load_tile<kVec>(st, g, kTile * I, kTile * J, N, lane);
  load_coords(st + 2 * kTileF, xw, I, N, lane);
  if (I != J) {
    load_tile<kVec>(st + kTileF, g, kTile * J, kTile * I, N, lane);
    load_coords(st + 2 * kTileF + kXF, xw, J, N, lane);
  }
}

// keep + the partner's send, where the lane with `bit` set keeps `hi`.
__device__ __forceinline__ double halve(double lo, double hi, bool bit,
                                        int mask) {
  const double keep = bit ? hi : lo, send = bit ? lo : hi;
  return __dadd_rn(keep, __shfl_xor_sync(kFull, send, mask));
}

// The partial sums of one tile pair.  tA = dp[I, J], tB = dp[J, I] (tA on
// the diagonal), xr / xc = x of I / J in double, [3][32].  Writes the row
// partial of atom 32 I + lane to row[q * 32 + lane] and, off the diagonal,
// the column partial of atom 32 J + 8 h + g to col[q * 32 + 8 h + g].
template <bool kDiag>
__device__ __forceinline__ void pair_sums(const float* tA, const float* tB,
                                          const double* xr, const double* xc,
                                          int lane, double* row, double* col) {
  const int g = lane >> 2, h = lane & 3;
  float a[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(
          tA + swz(4 * g + r, 8 * h + 4 * u));
      a[r][4 * u] = v.x;
      a[r][4 * u + 1] = v.y;
      a[r][4 * u + 2] = v.z;
      a[r][4 * u + 3] = v.w;
    }
  }
  double xi[4][3], racc[4][3], cacc[8][3];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      xi[r][q] = xr[q * kTile + 4 * g + r];
      racc[r][q] = 0.0;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int j = 8 * h + c;
    const float4 bv = *reinterpret_cast<const float4*>(tB + swz(j, 4 * g));
    const float b[4] = {bv.x, bv.y, bv.z, bv.w};
    const double xj[3] = {xc[j], xc[kTile + j], xc[2 * kTile + j]};
#pragma unroll
    for (int q = 0; q < 3; ++q) cacc[c][q] = 0.0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const double s = __dadd_rn((double)a[r][c], (double)b[r]);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const double p = __dmul_rn(s, __dsub_rn(xi[r][q], xj[q]));
        racc[r][q] = __dadd_rn(racc[r][q], p);
        if (!kDiag) cacc[c][q] = __dsub_rn(cacc[c][q], p);
      }
    }
  }
  // rows over the four column groups (lane bits 0-1): lane keeps row 4g + h
  const bool h1 = h & 2, h0 = h & 1;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const double v0 = halve(racc[0][q], racc[2][q], h1, 2);
    const double v1 = halve(racc[1][q], racc[3][q], h1, 2);
    row[q * kTile + lane] = halve(v0, v1, h0, 1);
  }
  if (kDiag) return;
  // columns over the eight row groups (lane bits 2-4): lane keeps column
  // 8h + g
  const bool g2 = g & 4, g1 = g & 2, g0 = g & 1;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    double w1[4], w2[2];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w1[k] = halve(cacc[k][q], cacc[k + 4][q], g2, 16);
#pragma unroll
    for (int k = 0; k < 2; ++k) w2[k] = halve(w1[k], w1[k + 2], g1, 8);
    col[q * kTile + 8 * h + g] = halve(w2[0], w2[1], g0, 4);
  }
}

// The tile pairs of a walker spread over G blocks of W warps, blockIdx =
// (rank, walker): tile pair t goes to block t mod G and, there, to warp
// (t / G) mod W, whose ring streams them; its partial sums go to
// part[(walker * ntp + t) * kPart].
template <bool kVec>
__global__ void __launch_bounds__(32 * kMaxWarps)
    sqpairdist_bwd_pairs_kernel(const float* __restrict__ x,
                                const float* __restrict__ dp,
                                double* __restrict__ part, int N, int nt,
                                int ntp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = gridDim.x, rank = blockIdx.x, walker = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = G * (blockDim.x >> 5);
  unsigned char* mine = smem + (size_t)warp * kWarpBytes;
  double* xd = reinterpret_cast<double*>(mine);
  float* ring = reinterpret_cast<float*>(mine + 2 * kXF * sizeof(double));
  const float* g = dp + (size_t)walker * N * N;
  const float* xw = x + (size_t)walker * 3 * N;

  int t = rank + G * warp;
  // the ring: tile pair t + m step goes to stage m % kStages
#pragma unroll
  for (int m = 0; m < kStages - 1; ++m) {
    if (t + m * step < ntp) {
      int I, J;
      tp_tiles(t + m * step, nt, I, J);
      load_pair<kVec>(ring + m * kStageF, g, xw, I, J, N, lane);
    }
    cp_async_commit();
  }
  for (int k = 0; t < ntp; t += step, ++k) {
    float* cur = ring + (k % kStages) * kStageF;
    const int tn = t + (kStages - 1) * step;
    if (tn < ntp) {
      int I, J;
      tp_tiles(tn, nt, I, J);
      load_pair<kVec>(ring + ((k + kStages - 1) % kStages) * kStageF, g, xw,
                      I, J, N, lane);
    }
    cp_async_commit();
    cp_async_wait_ring();  // the current stage has landed
    __syncwarp();
    int I, J;
    tp_tiles(t, nt, I, J);
    const float* xs = cur + 2 * kTileF;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      xd[q * kTile + lane] = (double)xs[3 * lane + q];
      if (I != J) xd[kXF + q * kTile + lane] = (double)xs[kXF + 3 * lane + q];
    }
    __syncwarp();
    double* row = part + ((size_t)walker * ntp + t) * kPart;
    if (I == J)
      pair_sums<true>(cur, cur, xd, xd, lane, row, row + 3 * kTile);
    else
      pair_sums<false>(cur, cur + kTileF, xd, xd + kXF, lane, row,
                       row + 3 * kTile);
    __syncwarp();  // the stage and xd are free for the next tile pair
  }
}

// The second pass, one block of three warps per (tile T, walker), warp q
// for coordinate q: dx of atom 32 T + lane adds its partials in ascending
// order of the other tile U, the column partial of (U, T) for U < T, then
// the row partials of (T, U) for U >= T.
__global__ void sqpairdist_bwd_gather_kernel(const double* __restrict__ part,
                                             float* __restrict__ dx, int N,
                                             int nt, int ntp) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // pass 1 is done
  const int T = blockIdx.x, walker = blockIdx.y;
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const double* base =
      part + (size_t)walker * ntp * kPart + q * kTile + lane;
  double acc = 0.0;
#pragma unroll 16
  for (int U = 0; U < nt; ++U)
    acc = __dadd_rn(acc, U < T ? base[(size_t)tp_index(U, T, nt) * kPart +
                                      3 * kTile]
                               : base[(size_t)tp_index(T, U, nt) * kPart]);
  const int a = kTile * T + lane;
  if (a < N) dx[((size_t)walker * N + a) * 3 + q] = (float)(2.0 * acc);
}

// Lets sqpairdist_bwd_pairs_kernel<kVec> take `smem` bytes of dynamic
// shared memory (set once, when first needed).
template <bool kVec>
cudaError_t bwd_allow(size_t smem) {
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sqpairdist_bwd_pairs_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  return cudaSuccess;
}

}  // namespace

// x: (B, N, 3) float32, out: (B, N, N) float32, row-major on the device.
// Returns a cudaError_t.
extern "C" int sqpairdist_fwd(const void* x, void* out, int B, int N,
                              void* stream) {
  if (B < 1 || B > 65535 || N < 1) return cudaErrorInvalidValue;
  const int tiles = (N + kTile - 1) / kTile;
  sqpairdist_fwd_kernel<<<dim3(tiles, tiles, B), dim3(kTile, kRows), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), N);
  return cudaGetLastError();
}

// x: (B, N, 3), dp: (B, N, N), dx: (B, N, 3), float32 row-major on the
// device; part: (B, nt (nt + 1) / 2, 192) double on the device, nt the
// 32-atom tiles.  `blocks` blocks of `warps` warps a walker.  Returns a
// cudaError_t.
extern "C" int sqpairdist_bwd(const void* x, const void* dp, void* dx,
                              void* part, int B, int N, int blocks, int warps,
                              void* stream) {
  if (B < 1 || B > 65535 || N < 1 || blocks < 1 || warps < 1 ||
      warps > kMaxWarps)
    return cudaErrorInvalidValue;
  const int nt = (N + kTile - 1) / kTile, ntp = nt * (nt + 1) / 2;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(dp) % 16 == 0;
  const size_t smem = (size_t)warps * kWarpBytes;
  cudaError_t err = vec ? bwd_allow<true>(smem) : bwd_allow<false>(smem);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dpf = static_cast<const float*>(dp);
  double* pd = static_cast<double*>(part);
  const dim3 grid(blocks, B), block(32 * warps);
  if (vec)
    sqpairdist_bwd_pairs_kernel<true><<<grid, block, smem, st>>>(xf, dpf, pd,
                                                                 N, nt, ntp);
  else
    sqpairdist_bwd_pairs_kernel<false><<<grid, block, smem, st>>>(xf, dpf, pd,
                                                                  N, nt, ntp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the second pass may launch while the first drains (programmatic
  // dependent launch); it waits for the first's writes before reading
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt, B);
  cfg.blockDim = dim3(3 * kTile);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sqpairdist_bwd_gather_kernel,
                           static_cast<const double*>(pd),
                           static_cast<float*>(dx), N, nt, ntp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
