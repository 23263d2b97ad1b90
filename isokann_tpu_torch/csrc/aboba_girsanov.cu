// Whole Girsanov-weighted ABOBA trajectories under the chi-MLP
// optimal-control bias, for small vacuum systems, one warp per walker.
//
// Replaces the TPU kernel isokann_tpu/md/pallas_md.py:aboba_girsanov_fused
// (with its ChiBiasPlan and make_chi_grad_fn).  It computes what that kernel
// computes, per step:
//   A   q += dt/2 p/m
//       F = forces(q)                        (warp_forces, warp_forces.cuh)
//       f = the pair distances of q's pair rows (minimum-imaged when
//           periodic, as the TPU kernel's own pair rows are)
//       chi, dchi/df from the MLP: a forward pass, then a hand-written
//           backward (sigmoid derivative from the cached activations,
//           LayerNorm backward through the row means)
//       lam = exp(qrate (Tmax - t)),  psi = max(lam (chi - b) + b, 1e-2)
//       Bias = fs sigma^2 (lam / psi) sum_pairs dchi/dr dr/dq,
//           sigma^2 = 2 kB T gamma m
//       deta = (a + 1)/famp dt/2 Bias;  logw -= eta . deta + |deta|^2 / 2
//   B   p += dt/2 (F + Bias)
//   O   p = a p + famp eta,  a = exp(-gamma dt), famp = sqrt(kB T m (1-a^2))
//   B   p += dt/2 (F + Bias)
//   A   q += dt/2 p/m
// but not how: the TPU kernel ran the MLP and the bias back-projection as
// (dim, 256-walker) matmuls for its matrix unit.
//
// Layout.  As kernel A: a warp owns a walker, a block holds kWarps = 4
// walkers, lane l owns atoms l and l + 32 (N <= 64) and keeps their q and p
// in registers; the forces come from kernel A's routine and tables
// (warp_forces.cuh).  Besides A's per-warp rows (positions, noise, bonded
// slots), each warp has rows for the raw features f, the LayerNorm output,
// the feature gradient and the hidden units.  The chi weights are staged in
// shared memory once per block (when the block still fits; a larger model
// is read from device memory in the same order), layer k's weight as
// [out][stride] with an odd stride >= its inputs, so that both the forward
// pass (lane = output unit, at input i) and the input gradient (lane =
// input, at output unit u) read 32 distinct banks.  A step, with __syncwarp
// between the phases:
//   1. positions to the warp's row, noise (lane q draws normal4 q), forces;
//   2. features: lane l computes pair rows p = l + 32 k;
//   3. LayerNorm mean and variance: lane sums in order, then a shuffle
//      butterfly (every lane gets the same bits); each dense layer: lane l
//      computes output units l and l + 32 over the inputs in order;
//   4. backward: each hidden unit's dchi/dz by its lane over the units
//      above, in order; dchi/dy_i by lane i mod 32 over the first layer's
//      units; the LayerNorm backward's two means by warp sums; the pair
//      coefficient c_p = (dchi/df_p) / r_p to the warp's row;
//   5. back-projection, a gather: each lane adds c_p (x_a - x_b) over its
//      atoms' partners b in ascending order (no atomics); then B-O-B-A on
//      the lane's coordinates and its share of the log-weight, summed by a
//      butterfly.
// The weights and b, qrate and Tmax are arguments of the launch, not
// constants of the build, so an adaptive loop refreshes them every
// generation without a rebuild.  FP32 on the CUDA cores; no tensor cores
// (TF32 would lose the port's precision rule).
//
// Noise: kernel A's convention, the stream of this kernel's first design.
// curand's Philox4x32-10 keyed by (seed, walker, step); the coordinates
// 4q..4q+3 of step s take the normal4 at offset s * 4 * ceil(3N/4) + 4q, so
// a walker's noise depends neither on B nor on the layout; noise == 0 runs
// the noiseless recursion.
//
// Bound on this card: operations.  Per walker-step alanine dipeptide costs
// kernel A's ~18.7k force-field operations plus the MLP (~36k for the
// forward and input-gradient passes of 231-38-6-1) and the LayerNorm,
// features and bias (~12k), ~67k in all: step_ops() in
// md/girsanov_kernel.py.  Device memory sees q, p and logw once per launch.
// So the least time is ops / the FP32 non-tensor peak (67 TFLOP/s on an
// H100 SXM).  A step of one walker is a chain of dependent phases spread
// over 32 lanes; its latency, not the card's rate, sets the time at the
// path's B = 256.

#include <curand_kernel.h>

#include "warp_forces.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr float kPsiFloor = 1e-2f;  // PSI_FLOOR of md/integrators.py
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory

// The same sum in every lane: xor butterfly over the lanes' partials.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The chi model: optional input LayerNorm (eps 1e-5), dense layers with
// sigmoid on the hidden ones and an identity scalar output.  Parameters
// arrive packed in one float array: gamma (n0), beta (n0) when layernorm,
// then for each layer k its weight (n_{k+1} x n_k, row-major: nn.Linear's
// layout) and its bias (n_{k+1}).
struct Mlp {
  const float* w;               // the packed parameters (device memory)
  int nl;                       // dense layers
  int layernorm;
  int sizes[kMaxLayers + 1];
  int woff[kMaxLayers];         // offsets of weights and biases in w
  int boff[kMaxLayers];
  int hoff[kMaxLayers];         // hidden layer k's units in a warp's row
  int nhidden;                  // hidden units in all
  int stride[kMaxLayers];       // row stride of layer k's staged weight
  int soff[kMaxLayers];         // offsets of the staged weights and biases
  int sboff[kMaxLayers];
  int staged;                   // floats of the staged copy
};

// Pointers the warp routines read the model through: the staged copy in
// shared memory, or the packed array in device memory (stride n_k).
struct MlpView {
  const float* gamma;
  const float* beta;
  const float* W[kMaxLayers];
  const float* b[kMaxLayers];
  int stride[kMaxLayers];
};

// Copies the packed parameters into the padded shared layout (all threads
// of the block) and returns the view of it; with dst == nullptr the view of
// the packed array.
__device__ MlpView stage_mlp(const Mlp& m, float* dst) {
  MlpView v;
  const int n0 = m.sizes[0];
  if (dst == nullptr) {
    v.gamma = m.w;
    v.beta = m.w + n0;
    for (int k = 0; k < m.nl; ++k) {
      v.W[k] = m.w + m.woff[k];
      v.b[k] = m.w + m.boff[k];
      v.stride[k] = m.sizes[k];
    }
    return v;
  }
  if (m.layernorm)
    for (int i = threadIdx.x; i < 2 * n0; i += blockDim.x) dst[i] = m.w[i];
  v.gamma = dst;
  v.beta = dst + n0;
  for (int k = 0; k < m.nl; ++k) {
    const int nin = m.sizes[k], nout = m.sizes[k + 1], S = m.stride[k];
    float* Wk = dst + m.soff[k];
    for (int e = threadIdx.x; e < nout * S; e += blockDim.x) {
      const int u = e / S, i = e - u * S;
      Wk[e] = i < nin ? m.w[m.woff[k] + u * nin + i] : 0.f;
    }
    for (int u = threadIdx.x; u < nout; u += blockDim.x)
      dst[m.sboff[k] + u] = m.w[m.boff[k] + u];
    v.W[k] = Wk;
    v.b[k] = dst + m.sboff[k];
    v.stride[k] = S;
  }
  return v;
}

// A warp's rows: raw features f (n0), the first layer's input y (n0; the
// LayerNorm output), the feature gradient / pair coefficients (n0) and the
// hidden units.
struct Rows {
  float *f, *y, *g, *h;
};

// chi at the features in r.f.  With layernorm, r.y gets the LayerNorm
// output and mu / inv_std are set.  The hidden activations go to r.h.
__device__ float warp_forward(const Mlp& m, const MlpView& v, const Rows& r,
                              int lane, float& mu, float& inv_std) {
  const int n0 = m.sizes[0];
  const float* in = r.f;
  if (m.layernorm) {
    float s = 0.f;
    for (int i = lane; i < n0; i += 32) s += r.f[i];
    mu = warp_sum(s) / n0;
    float q = 0.f;
    for (int i = lane; i < n0; i += 32) {
      const float d = r.f[i] - mu;
      q += d * d;
    }
    inv_std = rsqrtf(warp_sum(q) / n0 + 1e-5f);
    for (int i = lane; i < n0; i += 32)
      r.y[i] = (r.f[i] - mu) * inv_std * v.gamma[i] + v.beta[i];
    __syncwarp();
    in = r.y;
  }
  int nin = n0;
  float out0 = 0.f;
  for (int k = 0; k < m.nl; ++k) {
    const int nout = m.sizes[k + 1], S = v.stride[k];
    const bool last = k == m.nl - 1;
    float* out = r.h + m.hoff[k];
    for (int u0 = lane; u0 < nout; u0 += 64) {
      // units u0 and u0 + 32 side by side (the second clamped in range)
      const int u1 = min(u0 + 32, nout - 1);
      const float* W0 = v.W[k] + u0 * S;
      const float* W1 = v.W[k] + u1 * S;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int i = 0; i < nin; ++i) {
        const float h = in[i];
        a0 = fmaf(W0[i], h, a0);
        a1 = fmaf(W1[i], h, a1);
      }
      a0 += v.b[k][u0];
      a1 += v.b[k][u1];
      if (last) {
        out0 = a0;                                  // nout == 1: lane 0
      } else {
        out[u0] = 1.f / (1.f + expf(-a0));
        if (u0 + 32 < nout) out[u0 + 32] = 1.f / (1.f + expf(-a1));
      }
    }
    __syncwarp();
    in = out;
    nin = nout;
  }
  return __shfl_sync(kFull, out0, 0);
}

// Backward through the hidden layers, in place: on return hidden layer k's
// units hold dchi/dz_k (z_k its pre-activation), from the top down.
__device__ void warp_backward_hidden(const Mlp& m, const MlpView& v,
                                     const Rows& r, int lane) {
  for (int k = m.nl - 2; k >= 0; --k) {
    const int n = m.sizes[k + 1], nup = m.sizes[k + 2];
    const float* W = v.W[k + 1];
    const int S = v.stride[k + 1];
    float* hk = r.h + m.hoff[k];
    const bool top = k == m.nl - 2;             // the output layer above
    const float* gup = top ? nullptr : r.h + m.hoff[k + 1];
    for (int i = lane; i < n; i += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (int j = 0; j < nup; ++j)
        acc = fmaf(W[j * S + i], top ? 1.f : gup[j], acc);
      const float s = hk[i];
      hk[i] = acc * (s * (1.f - s));
    }
    __syncwarp();
  }
}

constexpr int kIn = 8;  // inputs a lane carries side by side

// dchi/dy_i for the inputs i = i0 + 32 k (k < kIn, i < n0) of the first
// dense layer, each a sum over the layer's units in order.
__device__ __forceinline__ void input_grad(const Mlp& m, const MlpView& v,
                                           const Rows& r, int i0,
                                           float gy[kIn]) {
  const int n0 = m.sizes[0];
  const float* W = v.W[0];
  const int S = v.stride[0];
#pragma unroll
  for (int k = 0; k < kIn; ++k) gy[k] = 0.f;
  if (m.nl == 1) {
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      if (i0 + 32 * k < n0) gy[k] = W[i0 + 32 * k];
    return;
  }
  for (int u = 0; u < m.sizes[1]; ++u) {
    const float hu = r.h[u];
    const float* Wu = W + u * S;
#pragma unroll
    for (int k = 0; k < kIn; ++k)
      gy[k] = fmaf(Wu[min(i0 + 32 * k, n0 - 1)], hu, gy[k]);
  }
}

// dchi/df_i for every feature into r.g, through the LayerNorm backward when
// there is one: g = inv_std (gx - mean(gx) - xn mean(gx xn)), gx = gy gamma.
__device__ void warp_feature_grad(const Mlp& m, const MlpView& v,
                                  const Rows& r, int lane, float mu,
                                  float inv_std) {
  const int n0 = m.sizes[0];
  float m1 = 0.f, m2 = 0.f;
  for (int i0 = lane; i0 < n0; i0 += 32 * kIn) {
    float gy[kIn];
    input_grad(m, v, r, i0, gy);
#pragma unroll
    for (int k = 0; k < kIn; ++k) {
      const int i = i0 + 32 * k;
      if (i >= n0) continue;
      if (!m.layernorm) {
        r.g[i] = gy[k];
        continue;
      }
      const float gx = gy[k] * v.gamma[i];
      const float xn = (r.f[i] - mu) * inv_std;
      m1 += gx;
      m2 += gx * xn;
      r.g[i] = gx;
    }
  }
  if (m.layernorm) {
    m1 = warp_sum(m1) / n0;
    m2 = warp_sum(m2) / n0;
    for (int i = lane; i < n0; i += 32) {
      const float xn = (r.f[i] - mu) * inv_std;
      r.g[i] = inv_std * (r.g[i] - m1 - xn * m2);
    }
  }
  __syncwarp();
}

// Shared memory beyond kernel A's layout: the packed pair list (np ints),
// the staged weights, then kWarps per-walker regions of Rows.
struct MlpLayout {
  int pairs, weights, rows, row_bytes, total;
};

__host__ __device__ inline MlpLayout mlp_layout(int base, int np,
                                                const Mlp& m, bool staged) {
  MlpLayout M;
  int o = base;
  M.pairs = take(o, 4 * np);
  M.weights = take(o, staged ? 4 * m.staged : 0);
  M.rows = o;
  int w = 0;
  take(w, 4 * m.sizes[0]);
  take(w, 4 * m.sizes[0]);
  take(w, 4 * m.sizes[0]);
  take(w, 4 * (m.nhidden + 1));
  M.row_bytes = w;
  M.total = o + kWarps * w;
  return M;
}

__device__ __forceinline__ Rows warp_mlp_rows(const Mlp& m,
                                              const MlpLayout& M,
                                              unsigned char* smem, int warp) {
  float* b = reinterpret_cast<float*>(smem + M.rows + warp * M.row_bytes);
  const int n4 = (m.sizes[0] + 3) & ~3;
  return Rows{b, b + n4, b + 2 * n4, b + 3 * n4};
}

__global__ void __launch_bounds__(32 * kWarps)
    chi_grad_kernel(const float* __restrict__ f, float* __restrict__ chi,
                    float* __restrict__ g, int B, Mlp m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpLayout M = mlp_layout(0, 0, m, m.staged > 0);
  const MlpView v = stage_mlp(
      m, m.staged > 0 ? reinterpret_cast<float*>(smem + M.weights) : nullptr);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;  // no block-wide barrier follows
  const int n0 = m.sizes[0];
  const Rows r = warp_mlp_rows(m, M, smem, warp);
  const float* fw = f + (size_t)w * n0;
  for (int i = lane; i < n0; i += 32) r.f[i] = fw[i];
  __syncwarp();
  float mu = 0.f, inv_std = 1.f;
  const float c = warp_forward(m, v, r, lane, mu, inv_std);
  if (lane == 0) chi[w] = c;
  warp_backward_hidden(m, v, r, lane);
  warp_feature_grad(m, v, r, lane, mu, inv_std);
  for (int i = lane; i < n0; i += 32) g[(size_t)w * n0 + i] = r.g[i];
}

__global__ void __launch_bounds__(32 * kWarps)
    aboba_girsanov_kernel(float* __restrict__ x, float* __restrict__ p,
                          float* __restrict__ logw, int B, Geometry geo,
                          const int* __restrict__ itab,
                          const float* __restrict__ ftab,
                          const float4* __restrict__ dense,
                          const int* __restrict__ aslots, Mlp m,
                          const float* __restrict__ gtab, int nsteps,
                          unsigned long long seed, int noise, float dt,
                          float a, float b, float qrate, float tmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(geo);
  const MlpLayout M = mlp_layout(L.total, geo.np, m, m.staged > 0);
  stage(geo, L, itab, ftab, dense, aslots, smem);
  int* pairs = reinterpret_cast<int*>(smem + M.pairs);
  for (int k = threadIdx.x; k < geo.np; k += blockDim.x)
    pairs[k] = itab[2 * k] | (itab[2 * k + 1] << 16);
  const MlpView v = stage_mlp(
      m, m.staged > 0 ? reinterpret_cast<float*>(smem + M.weights) : nullptr);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;  // no block-wide barrier follows
  const int N = geo.natoms, A3 = 3 * N, np = geo.np;
  float* wx = warp_rows(L, smem, warp, N, lane);
  float* wz = wx + ((A3 + 3) & ~3);
  float* wc = wz + 4 * L.nq;
  const Rows r = warp_mlp_rows(m, M, smem, warp);

  // the lane's atoms: q, p, 1/m, famp, 1/famp, fs sigma^2
  const float* minv = ftab + 4 * geo.np + 2 * geo.nb + 2 * geo.na +
                      3 * geo.nd;
  float qr[kPer][3], pr[kPer][3], mi[kPer][3], fa[kPer][3], ifa[kPer][3],
      fs[kPer][3];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int at = lane + 32 * u;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = 3 * at + k;
      const bool own = at < N;
      qr[u][k] = own ? x[(size_t)w * A3 + c] : 0.f;
      pr[u][k] = own ? p[(size_t)w * A3 + c] : 0.f;
      mi[u][k] = own ? minv[c] : 0.f;
      fa[u][k] = own ? gtab[c] : 0.f;
      ifa[u][k] = own ? gtab[A3 + c] : 0.f;
      fs[u][k] = own ? gtab[2 * A3 + c] : 0.f;
    }
  }
  const float ibx = 1.f / geo.bx, iby = 1.f / geo.by, ibz = 1.f / geo.bz;
  const float h = 0.5f * dt;
  const float c_deta = (a + 1.f) * h;
  float lw = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    const float tt = (float)s * dt;
    // ---- 1. A, positions to the row, noise, forces ----------------------
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int at = lane + 32 * u;
      if (at < N)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          qr[u][k] += h * pr[u][k] * mi[u][k];
          wx[3 * at + k] = qr[u][k];
        }
    }
    __syncwarp();
    if (noise) {
      for (int q = lane; q < L.nq; q += 32) {
        curandStatePhilox4_32_10_t st;
        curand_init(seed, (unsigned long long)w,
                    ((unsigned long long)s * L.nq + q) * 4ull, &st);
        const float4 z4 = curand_normal4(&st);
        wz[4 * q] = z4.x;
        wz[4 * q + 1] = z4.y;
        wz[4 * q + 2] = z4.z;
        wz[4 * q + 3] = z4.w;
      }
    }
    float F[kPer][3];
    warp_forces(geo, L, smem, wx, wc, lane, F);  // ends after a __syncwarp

    // ---- 2. features: the pair rows' distances --------------------------
    for (int q = lane; q < np; q += 32) {
      const int ij = pairs[q], i = ij & 0xffff, j = ij >> 16;
      float dx = wx[3 * i] - wx[3 * j], dy = wx[3 * i + 1] - wx[3 * j + 1],
            dz = wx[3 * i + 2] - wx[3 * j + 2];
      if (geo.periodic) {
        dx -= geo.bx * rintf(dx * ibx);
        dy -= geo.by * rintf(dy * iby);
        dz -= geo.bz * rintf(dz * ibz);
      }
      r.f[q] = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f);
    }
    __syncwarp();

    // ---- 3-4. chi and dchi/df; the pair coefficients c_p = g_p / r_p ----
    float mu = 0.f, inv_std = 1.f;
    const float chi = warp_forward(m, v, r, lane, mu, inv_std);
    warp_backward_hidden(m, v, r, lane);
    warp_feature_grad(m, v, r, lane, mu, inv_std);
    for (int q = lane; q < np; q += 32) r.g[q] = r.g[q] / r.f[q];
    __syncwarp();
    const float lam = expf(qrate * (tmax - tt));
    const float scale = lam / fmaxf(lam * (chi - b) + b, kPsiFloor);

    // ---- 5. back-projection, gathered; B-O-B-A; the log-weight ----------
    float dlw = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int at = lane + 32 * u;
      if (at >= N) continue;
      const float xa = wx[3 * at], ya = wx[3 * at + 1], za = wx[3 * at + 2];
      float G[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
      for (int bb = 0; bb < N; ++bb) {
        if (bb == at) continue;
        const int lo = min(at, bb), hi = max(at, bb);
        const float c = r.g[lo * N - lo * (lo + 1) / 2 + (hi - lo - 1)];
        float dx = xa - wx[3 * bb], dy = ya - wx[3 * bb + 1],
              dz = za - wx[3 * bb + 2];
        if (geo.periodic) {
          dx -= geo.bx * rintf(dx * ibx);
          dy -= geo.by * rintf(dy * iby);
          dz -= geo.bz * rintf(dz * ibz);
        }
        G[0] += c * dx;
        G[1] += c * dy;
        G[2] += c * dz;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float z = noise ? wz[3 * at + k] : 0.f;
        const float bias = fs[u][k] * (scale * G[k]);
        const float deta = c_deta * bias * ifa[u][k];
        dlw += z * deta + 0.5f * deta * deta;
        const float half = h * (F[u][k] + bias);
        float pc = pr[u][k] + half;                                  // B
        pc = a * pc + fa[u][k] * z;                                  // O
        pc += half;                                                  // B
        pr[u][k] = pc;
        qr[u][k] += h * pc * mi[u][k];                               // A
      }
    }
    lw -= warp_sum(dlw);
    __syncwarp();  // every lane is past its reads of wx, wz and r
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int at = lane + 32 * u;
    if (at < N)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[(size_t)w * A3 + 3 * at + k] = qr[u][k];
        p[(size_t)w * A3 + 3 * at + k] = pr[u][k];
      }
  }
  if (lane == 0) logw[w] = lw;
}

// Fills m from the packed parameters and the layer sizes (sizes[0..nl]).
// Returns false for a layout the kernels do not take.
bool make_mlp(Mlp& m, const void* params, int nl, const int* sizes,
              int layernorm) {
  if (nl < 1 || nl > kMaxLayers || sizes[nl] != 1) return false;
  m.w = static_cast<const float*>(params);
  m.nl = nl;
  m.layernorm = layernorm;
  int off = layernorm ? 2 * sizes[0] : 0;
  int soff = off;
  int hid = 0;
  for (int k = 0; k <= nl; ++k) {
    if (sizes[k] < 1) return false;
    m.sizes[k] = sizes[k];
  }
  for (int k = 0; k < nl; ++k) {
    m.woff[k] = off;
    off += sizes[k + 1] * sizes[k];
    m.boff[k] = off;
    off += sizes[k + 1];
    m.stride[k] = sizes[k] | 1;
    m.soff[k] = soff;
    soff += sizes[k + 1] * m.stride[k];
    m.sboff[k] = soff;
    soff += sizes[k + 1];
    m.hoff[k] = hid;
    if (k < nl - 1) hid += sizes[k + 1];
  }
  m.nhidden = hid;
  m.staged = soff;
  return true;
}

// Stages the weights when the block fits with them; else m.staged = 0 and
// the kernels read the packed array.  Returns the block's bytes, or 0 when
// it does not fit even so.
size_t plan_smem(Mlp& m, int base, int np) {
  const size_t with = mlp_layout(base, np, m, true).total;
  if (with <= kMaxSmem) return with;
  m.staged = 0;
  const size_t without = mlp_layout(base, np, m, false).total;
  return without <= kMaxSmem ? without : 0;
}

}  // namespace

// f: (B, n0) features; chi: (B,); g: (B, n0) dchi/df.  float32 row-major
// on the device.  Returns a cudaError_t.
extern "C" int ag_chi_grad(const void* f, void* chi, void* g, int B,
                           const void* params, int nl, const int* sizes,
                           int layernorm, void* stream) {
  Mlp m;
  if (B < 1 || !make_mlp(m, params, nl, sizes, layernorm))
    return cudaErrorInvalidValue;
  const size_t smem = plan_smem(m, 0, 0);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(chi_grad_kernel, smem);
  if (err != cudaSuccess) return err;
  chi_grad_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<float*>(chi),
      static_cast<float*>(g), B, m);
  return cudaGetLastError();
}

// x, p: (B, 3N) float32 row-major on the device, advanced in place by
// nsteps biased ABOBA steps; logw: (B,) the Girsanov log-weights.  itab,
// ftab, dense, aslots, K and the geometry as kernel A's; gtab: famp |
// 1/famp | forcescale sigma^2 (3N each).  Returns a cudaError_t.
extern "C" int ag_aboba_girsanov(
    void* x, void* p, void* logw, int B, const void* itab, const void* ftab,
    const void* dense, const void* aslots, int K, int natoms, int np, int nb,
    int na, int nd, int use_rf, float rc, float krf, int periodic, float bx,
    float by, float bz, const void* gtab, const void* params, int nl,
    const int* sizes, int layernorm, int nsteps, unsigned long long seed,
    int noise, float dt, float a, float b, float qrate, float tmax,
    void* stream) {
  Geometry geo;
  size_t base = 0;
  Mlp m;
  cudaError_t err = prepare_geometry(geo, natoms, np, nb, na, nd, K, use_rf,
                                     rc, krf, periodic, bx, by, bz, base);
  if (err == cudaSuccess &&
      (natoms < 2 || B < 1 || nsteps < 0 ||
       !make_mlp(m, params, nl, sizes, layernorm) || m.sizes[0] != np))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const size_t smem = plan_smem(m, (int)base, np);
  if (smem == 0) return cudaErrorInvalidValue;
  err = allow_smem(aboba_girsanov_kernel, smem);
  if (err != cudaSuccess) return err;
  aboba_girsanov_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(p),
      static_cast<float*>(logw), B, geo, static_cast<const int*>(itab),
      static_cast<const float*>(ftab), static_cast<const float4*>(dense),
      static_cast<const int*>(aslots), m, static_cast<const float*>(gtab),
      nsteps, seed, noise, dt, a, b, qrate, tmax);
  return cudaGetLastError();
}
