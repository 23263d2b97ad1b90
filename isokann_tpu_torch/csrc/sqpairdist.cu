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
//       the difference form does not cancel between two large terms.  Each
//       s_ij (x_i - x_j) is formed and summed in double in a fixed order and
//       rounded once to float, as the plain version does in float64.
//
// Not the TPU's layout.  The TPU padded N to a multiple of 128 lanes and the
// three coordinates to 8, and ran one grid step per walker holding the whole
// (Np, Np) block in VMEM.  Here:
//   C:  one block per (j-tile, i-tile, walker) of 32 x 32 pairs, 32 x 8
//       threads; both tiles' coordinates are staged in shared memory, thread
//       (tx, ty) computes rows ty, ty + 8, ... of column j0 + tx, so a warp
//       writes 32 consecutive floats of a row;
//   C': one block per (i-tile of 32 atoms, walker), 32 x 8 threads, looping
//       over j-tiles of 32: the tile dp[i0.., j0..] and the transposed tile
//       dp[j0.., i0..] are both read along their rows (coalesced) into
//       shared memory, thread (tx, ty) sums atom i0 + tx over the columns
//       ty, ty + 8, ... of each tile, and the eight partial sums of an atom
//       are added in a fixed order at the end: no atomics, the same bits for
//       the same input.
//
// Bound on this card: bytes.  C writes 4 B N^2 bytes and C' reads them, for
// 8-10 operations a pair (ops/pairdists_kernel.py:step_ops): at N = 588 the
// memory rate (3.35 TB/s) allows 13.3 us at B = 32 and 0.425 ms at B = 1024,
// the FP32 peak a tenth of that.  C' reads each dp element twice (once in its
// row tile, once in a transposed tile), so its traffic is twice the bound's;
// one read would need a block to own the pair (i, j) and (j, i) at once and
// scatter to both atoms.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // atoms of a tile side
constexpr int kRows = 8;   // threadIdx.y extent

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

__global__ void sqpairdist_bwd_kernel(const float* __restrict__ x,
                                      const float* __restrict__ dp,
                                      float* __restrict__ dx, int N) {
  __shared__ float row[kTile][kTile + 1];  // dp[i0 + r][j0 + c]
  __shared__ float col[kTile][kTile + 1];  // dp[j0 + r][i0 + c]
  __shared__ float xj[kTile * 3];
  __shared__ double part[kRows][kTile][3];
  const int b = blockIdx.y, i0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = i0 + tx;
  const float* xb = x + (size_t)b * N * 3;
  const float* g = dp + (size_t)b * N * N;
  const double xi0 = i < N ? (double)xb[3 * i] : 0.0;
  const double xi1 = i < N ? (double)xb[3 * i + 1] : 0.0;
  const double xi2 = i < N ? (double)xb[3 * i + 2] : 0.0;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int r = ty; r < kTile; r += kRows) {
      const int ir = i0 + r, jc = j0 + tx, jr = j0 + r;
      row[r][tx] = (ir < N && jc < N) ? g[(size_t)ir * N + jc] : 0.f;
      col[r][tx] = (jr < N && i < N) ? g[(size_t)jr * N + i] : 0.f;
    }
    const int t = ty * kTile + tx;
    if (t < kTile * 3) xj[t] = (j0 * 3 + t < N * 3) ? xb[j0 * 3 + t] : 0.f;
    __syncthreads();
    for (int c = ty; c < kTile && j0 + c < N; c += kRows) {
      const double s = (double)row[tx][c] + (double)col[c][tx];
      a0 += s * (xi0 - (double)xj[3 * c]);
      a1 += s * (xi1 - (double)xj[3 * c + 1]);
      a2 += s * (xi2 - (double)xj[3 * c + 2]);
    }
  }
  part[ty][tx][0] = a0;
  part[ty][tx][1] = a1;
  part[ty][tx][2] = a2;
  __syncthreads();
  if (ty < 3 && i < N) {
    double s = 0.0;
    for (int r = 0; r < kRows; ++r) s += part[r][tx][ty];
    dx[((size_t)b * N + i) * 3 + ty] = (float)(2.0 * s);
  }
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
// device.  Returns a cudaError_t.
extern "C" int sqpairdist_bwd(const void* x, const void* dp, void* dx, int B,
                              int N, void* stream) {
  if (B < 1 || B > 65535 || N < 1) return cudaErrorInvalidValue;
  const int tiles = (N + kTile - 1) / kTile;
  sqpairdist_bwd_kernel<<<dim3(tiles, B), dim3(kTile, kRows), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dp),
      static_cast<float*>(dx), N);
  return cudaGetLastError();
}
