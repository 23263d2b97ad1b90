// Whole Girsanov-weighted ABOBA trajectories under the chi-MLP
// optimal-control bias, for small vacuum systems, one CUDA thread per walker.
//
// Replaces the TPU kernel isokann_tpu/md/pallas_md.py:aboba_girsanov_fused
// (with its ChiBiasPlan and make_chi_grad_fn).  It computes what that kernel
// computes, per step:
//   A   q += dt/2 p/m
//       F = forces(q)                         (compute_forces, md_forces.cuh)
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
// (dim, 256-walker) matmuls for its matrix unit.  Here one thread carries
// one walker's whole recursion.
//
// Layout.  A block is one warp of 32 walkers (kBlock, md_forces.cuh).  The
// walker's q, p, F and the unscaled bias gradient G (3N each), its features
// (n0 = N(N-1)/2) and its hidden activations live in dynamic shared memory
// as [unit][walker-in-block], so lanes never conflict; a per-thread array of
// 231 + 44 floats would spill to local memory.  The chi weights are read
// from device memory through the read-only cache: every lane reads the same
// weight at the same time (a broadcast), and the 35 KB of pairnet weights
// stay in L1.  The weights and b, qrate and Tmax are arguments of
// the launch, not constants of the build, so an adaptive loop refreshes
// them every generation without a rebuild (forcescale rides in the
// fs sigma^2 table, also an argument).  The features buffer is reused:
// raw distances, then the LayerNorm output, then g * gamma for the
// LayerNorm backward; the distances are recomputed from q where the
// backward and the back-projection need them again.  FP32 on the CUDA
// cores; no tensor cores (TF32 would lose the port's precision rule).
//
// Noise: kernel A's convention.  curand's Philox4x32-10 keyed by (seed,
// walker, step), offset step * 4 * ceil(3N/4); noise == 0 runs the
// noiseless recursion.
//
// Bound on this card: operations.  Per walker-step alanine dipeptide costs
// kernel A's ~18.7k force-field operations plus the MLP (~36k for the
// forward and input-gradient passes of 231-38-6-1) and the LayerNorm,
// features and bias (~12k), ~67k in all: step_ops() in
// md/girsanov_kernel.py.  Device memory sees
// q, p and logw once per launch.  So the least time is ops / the FP32
// non-tensor peak (67 TFLOP/s on an H100 SXM).  This first version is
// latency-bound: one warp per block and a long dependent chain per thread.

#include <curand_kernel.h>

#include "md_forces.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr float kPsiFloor = 1e-2f;  // PSI_FLOOR of md/integrators.py

// Pair row p (atoms i < j): d = x_i - x_j, minimum-imaged when periodic,
// as compute_forces (md_forces.cuh) forms it.  Returns r^2 + 1e-12.  The
// chi model's distance features read their pair rows through it.
__device__ __forceinline__ float pair_delta(const Tables& t, const float* sx,
                                            int p, int lane, int& i, int& j,
                                            float& dx, float& dy, float& dz) {
  i = __ldg(t.itab + 2 * p);
  j = __ldg(t.itab + 2 * p + 1);
  float xi, yi, zi, xj, yj, zj;
  load3(sx, i, lane, xi, yi, zi);
  load3(sx, j, lane, xj, yj, zj);
  dx = xi - xj;
  dy = yi - yj;
  dz = zi - zj;
  if (t.periodic) {
    dx -= t.bx * rintf(dx * (1.f / t.bx));
    dy -= t.by * rintf(dy * (1.f / t.by));
    dz -= t.bz * rintf(dz * (1.f / t.bz));
  }
  return dx * dx + dy * dy + dz * dz + 1e-12f;
}

// The chi model: optional input LayerNorm (eps 1e-5), dense layers with
// sigmoid on the hidden ones and an identity scalar output.  Parameters are
// packed in one float array: gamma (n0), beta (n0) when layernorm, then for
// each layer k its weight (n_{k+1} x n_k, row-major: nn.Linear's layout)
// and its bias (n_{k+1}).
struct Mlp {
  const float* w;
  int nl;                       // dense layers
  int layernorm;
  int sizes[kMaxLayers + 1];
  int woff[kMaxLayers];         // offsets of weights and biases in w
  int boff[kMaxLayers];
  int hoff[kMaxLayers];         // hidden layer k's units in the h buffer
  int nhidden;                  // hidden units in all
};

// chi at the features in sfeat ([n0][kBlock]).  With layernorm, sfeat is
// overwritten by the LayerNorm output and mu / inv_std are set.  The
// hidden activations go to sh.
__device__ float mlp_forward(const Mlp& m, float* sfeat, float* sh, int lane,
                             float& mu, float& inv_std) {
  const int n0 = m.sizes[0];
  if (m.layernorm) {
    float s = 0.f;
    for (int i = 0; i < n0; ++i) s += *at(sfeat, i, lane);
    mu = s / n0;
    float v = 0.f;
    for (int i = 0; i < n0; ++i) {
      const float d = *at(sfeat, i, lane) - mu;
      v += d * d;
    }
    inv_std = rsqrtf(v / n0 + 1e-5f);
    const float* gamma = m.w;
    const float* beta = m.w + n0;
    for (int i = 0; i < n0; ++i)
      *at(sfeat, i, lane) = (*at(sfeat, i, lane) - mu) * inv_std *
                              __ldg(gamma + i) + __ldg(beta + i);
  }
  const float* h = sfeat;
  int nin = n0;
  float chi = 0.f;
  for (int k = 0; k < m.nl; ++k) {
    const int nout = m.sizes[k + 1];
    const float* W = m.w + m.woff[k];
    const float* bias = m.w + m.boff[k];
    const bool last = k == m.nl - 1;
    float* out = sh + m.hoff[k] * kBlock;
    for (int j = 0; j < nout; ++j) {
      const float* Wj = W + j * nin;
      float acc = 0.f;
      for (int i = 0; i < nin; ++i)
        acc = fmaf(__ldg(Wj + i), h[i * kBlock + lane], acc);
      acc += __ldg(bias + j);
      if (last)
        chi = acc;                              // nout == 1
      else
        *at(out, j, lane) = 1.f / (1.f + expf(-acc));
    }
    h = out;
    nin = nout;
  }
  return chi;
}

// Backward through the hidden layers, in place: on return hidden layer k's
// buffer holds dchi/dz_k (z_k its pre-activation), from the top down.
__device__ void mlp_backward_hidden(const Mlp& m, float* sh, int lane) {
  for (int k = m.nl - 2; k >= 0; --k) {
    const int n = m.sizes[k + 1];
    const int nup = m.sizes[k + 2];
    const float* W = m.w + m.woff[k + 1];       // (nup, n)
    float* hk = sh + m.hoff[k] * kBlock;
    const bool top = k == m.nl - 2;             // the output layer above
    const float* gup = top ? nullptr : sh + m.hoff[k + 1] * kBlock;
    for (int i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int j = 0; j < nup; ++j)
        acc = fmaf(__ldg(W + j * n + i), top ? 1.f : gup[j * kBlock + lane],
                   acc);
      const float s = hk[i * kBlock + lane];
      hk[i * kBlock + lane] = acc * (s * (1.f - s));
    }
  }
}

// dchi/dh_i for input unit i of the first dense layer.
__device__ float mlp_input_grad(const Mlp& m, const float* sh, int i,
                                int lane) {
  const int n0 = m.sizes[0];
  const float* W = m.w + m.woff[0];
  if (m.nl == 1) return __ldg(W + i);
  float acc = 0.f;
  for (int j = 0; j < m.sizes[1]; ++j)
    acc = fmaf(__ldg(W + j * n0 + i), sh[j * kBlock + lane], acc);
  return acc;
}

// dchi/df_i for every feature, through the LayerNorm backward when there
// is one: g = inv_std (gx - mean(gx) - xn mean(gx xn)), gx = g_h gamma.
// feat.r(i) gives raw feature i again; feat.emit(i, g) takes the result.
// sfeat is scratch here.
template <class Feat>
__device__ void mlp_feature_grad(const Mlp& m, float* sfeat, const float* sh,
                                 int lane, float mu, float inv_std,
                                 Feat& feat) {
  const int n0 = m.sizes[0];
  if (!m.layernorm) {
    for (int i = 0; i < n0; ++i) feat.emit(i, mlp_input_grad(m, sh, i, lane));
    return;
  }
  const float* gamma = m.w;
  float m1 = 0.f, m2 = 0.f;
  for (int i = 0; i < n0; ++i) {
    const float gx = mlp_input_grad(m, sh, i, lane) * __ldg(gamma + i);
    const float xn = (feat.r(i) - mu) * inv_std;
    m1 += gx;
    m2 += gx * xn;
    *at(sfeat, i, lane) = gx;
  }
  m1 /= n0;
  m2 /= n0;
  for (int i = 0; i < n0; ++i) {
    const float xn = (feat.r(i) - mu) * inv_std;
    feat.emit(i, inv_std * (*at(sfeat, i, lane) - m1 - xn * m2));
  }
}

// Features given as rows of f (B, n0); the gradient goes to rows of g.
struct RowFeat {
  const float* f;
  float* g;
  __device__ float r(int i) const { return f[i]; }
  __device__ void emit(int i, float v) { g[i] = v; }
};

// Features are the pair distances of the walker's pair rows; the gradient
// is projected back onto the coordinates: G += dchi/dr (d / r) on atom i,
// minus that on atom j.
struct PairFeat {
  Tables t;
  const float* sx;
  float* sg;
  int lane;
  __device__ float r(int p) const {
    int i, j;
    float dx, dy, dz;
    return sqrtf(pair_delta(t, sx, p, lane, i, j, dx, dy, dz));
  }
  __device__ void emit(int p, float g) {
    int i, j;
    float dx, dy, dz;
    const float c = g / sqrtf(pair_delta(t, sx, p, lane, i, j, dx, dy, dz));
    add3(sg, i, lane, c * dx, c * dy, c * dz);
    add3(sg, j, lane, -c * dx, -c * dy, -c * dz);
  }
};

__global__ void chi_grad_kernel(const float* __restrict__ f,
                                float* __restrict__ chi,
                                float* __restrict__ g, int B, Mlp m) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int w = blockIdx.x * kBlock + lane;
  if (w >= B) return;  // no block-wide barrier follows
  const int n0 = m.sizes[0];
  float* sfeat = smem;
  float* sh = sfeat + n0 * kBlock;
  const float* fw = f + (size_t)w * n0;
  for (int i = 0; i < n0; ++i) *at(sfeat, i, lane) = fw[i];
  float mu = 0.f, inv_std = 1.f;
  chi[w] = mlp_forward(m, sfeat, sh, lane, mu, inv_std);
  mlp_backward_hidden(m, sh, lane);
  RowFeat rf{fw, g + (size_t)w * n0};
  mlp_feature_grad(m, sfeat, sh, lane, mu, inv_std, rf);
}

__global__ void aboba_girsanov_kernel(
    float* __restrict__ x, float* __restrict__ p, float* __restrict__ logw,
    int B, Tables t, Mlp m, const float* __restrict__ gtab, int nsteps,
    unsigned long long seed, int noise, float dt, float a, float b,
    float qrate, float tmax) {
  extern __shared__ float smem[];
  const int A3 = 3 * t.natoms;
  const int lane = threadIdx.x;
  const int w = blockIdx.x * kBlock + lane;
  if (w >= B) return;  // no block-wide barrier follows
  float* sx = smem;
  float* sp = sx + A3 * kBlock;
  float* sf = sp + A3 * kBlock;
  float* sg = sf + A3 * kBlock;
  float* sfeat = sg + A3 * kBlock;
  float* sh = sfeat + t.np * kBlock;
  for (int c = 0; c < A3; ++c) {
    *at(sx, c, lane) = x[(size_t)w * A3 + c];
    *at(sp, c, lane) = p[(size_t)w * A3 + c];
  }
  const float* minv = t.ftab + minv_offset(t);
  const float* famp = gtab;
  const float* inv_famp = famp + A3;
  const float* fs_sig2 = inv_famp + A3;
  const float h = 0.5f * dt;
  const float c_deta = (a + 1.f) * h;
  const int nq = (A3 + 3) / 4;
  PairFeat pf{t, sx, sg, lane};
  float lw = 0.f;
  for (int s = 0; s < nsteps; ++s) {
    const float tt = (float)s * dt;
    for (int c = 0; c < A3; ++c)                                     // A
      *at(sx, c, lane) += h * *at(sp, c, lane) * __ldg(minv + c);
    compute_forces(t, sx, sf, lane);
    for (int q = 0; q < t.np; ++q) *at(sfeat, q, lane) = pf.r(q);
    float mu = 0.f, inv_std = 1.f;
    const float chi = mlp_forward(m, sfeat, sh, lane, mu, inv_std);
    mlp_backward_hidden(m, sh, lane);
    for (int c = 0; c < A3; ++c) *at(sg, c, lane) = 0.f;
    mlp_feature_grad(m, sfeat, sh, lane, mu, inv_std, pf);
    const float lam = expf(qrate * (tmax - tt));
    const float scale = lam / fmaxf(lam * (chi - b) + b, kPsiFloor);

    curandStatePhilox4_32_10_t st;
    if (noise)
      curand_init(seed, (unsigned long long)w,
                  (unsigned long long)s * 4ull * nq, &st);
    float dlw = 0.f;
    for (int c0 = 0; c0 < A3; c0 += 4) {
      const float4 z4 =
          noise ? curand_normal4(&st) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
      for (int q = 0; q < 4 && c0 + q < A3; ++q) {
        const int c = c0 + q;
        const float bias = __ldg(fs_sig2 + c) * (scale * *at(sg, c, lane));
        const float deta = c_deta * bias * __ldg(inv_famp + c);
        dlw += z[q] * deta + 0.5f * deta * deta;
        const float half = h * (*at(sf, c, lane) + bias);
        float pc = *at(sp, c, lane) + half;                          // B
        pc = a * pc + __ldg(famp + c) * z[q];                        // O
        pc += half;                                                  // B
        *at(sp, c, lane) = pc;
        *at(sx, c, lane) += h * pc * __ldg(minv + c);                // A
      }
    }
    lw -= dlw;
  }
  for (int c = 0; c < A3; ++c) {
    x[(size_t)w * A3 + c] = *at(sx, c, lane);
    p[(size_t)w * A3 + c] = *at(sp, c, lane);
  }
  logw[w] = lw;
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
    m.hoff[k] = hid;
    if (k < nl - 1) hid += sizes[k + 1];
  }
  m.nhidden = hid;
  return true;
}

constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory

}  // namespace

// f: (B, n0) features; chi: (B,); g: (B, n0) dchi/df.  float32 row-major
// on the device.  Returns a cudaError_t.
extern "C" int ag_chi_grad(const void* f, void* chi, void* g, int B,
                           const void* params, int nl, const int* sizes,
                           int layernorm, void* stream) {
  Mlp m;
  if (B < 1 || !make_mlp(m, params, nl, sizes, layernorm))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (m.sizes[0] + m.nhidden) * kBlock;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = prepare(chi_grad_kernel, smem);
  if (err != cudaSuccess) return err;
  chi_grad_kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<float*>(chi),
      static_cast<float*>(g), B, m);
  return cudaGetLastError();
}

// x, p: (B, 3N) float32 row-major on the device, advanced in place by
// nsteps biased ABOBA steps; logw: (B,) the Girsanov log-weights.  gtab:
// famp | 1/famp | forcescale sigma^2 (3N each).  Returns a cudaError_t.
extern "C" int ag_aboba_girsanov(
    void* x, void* p, void* logw, int B, const void* itab, const void* ftab,
    int natoms, int np, int nb, int na, int nd, int use_rf, float rc,
    float krf, int periodic, float bx, float by, float bz, const void* gtab,
    const void* params, int nl, const int* sizes, int layernorm, int nsteps,
    unsigned long long seed, int noise, float dt, float a, float b,
    float qrate, float tmax, void* stream) {
  Mlp m;
  if (natoms < 2 || natoms > kMaxAtoms || B < 1 || nsteps < 0 ||
      !make_mlp(m, params, nl, sizes, layernorm) || m.sizes[0] != np)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (4 * 3 * natoms + np + m.nhidden) * kBlock;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = prepare(aboba_girsanov_kernel, smem);
  if (err != cudaSuccess) return err;
  const Tables t = make_tables(itab, ftab, natoms, np, nb, na, nd, use_rf, rc,
                               krf, periodic, bx, by, bz);
  aboba_girsanov_kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(p),
      static_cast<float*>(logw), B, t, m, static_cast<const float*>(gtab),
      nsteps, seed, noise, dt, a, b, qrate, tmax);
  return cudaGetLastError();
}
