// Fused photometric J^T W J reduce for Hopper (sm_90a), FP32 FMA only.
//
// Replaces the TPU kernel photo_reduce_pallas (sage_slam_tpu/ops/
// pallas_kernels.py:118, pl.pallas_call at :152); same function as
// photo_reduce_xla (sage_slam_tpu/ops/photometric.py:617). Inputs, all
// float32 and contiguous:
//   fgs  [E, L, 3C, N]  target samples, rows f1 | gx | gy (d-major grads)
//   f0   [E, L, C, N]   source features
//   gate [E, N]
//   kx, ky [E, dim, N]  K-rows, dim = 13 + CS
// Outputs, un-normalised: ata [E, dim, dim], atb [E, dim], err [E], n_inl [E].
//
// Bound: memory. Every input is read once (about 93 MB at the window-BA
// bench point E=24, L=4, C=16, N=3072, dim=29); the arithmetic is well
// under a GFLOP.
//
// Stage A, grid (ceil(N/TN), E), one thread per point: the thread walks
// the L levels and C channels with loads coalesced along N, keeps the
// level-weighted Gram terms in registers and applies gate^2. The block
// stages its tile's K-rows and Gram terms in shared memory (row stride
// TN+1, so threads reading different rows hit different banks) and reduces
// the tile into one partial vector: the upper triangle of ata (row by row),
// then atb, err and n_inl. Stage B sums the partials of each edge over the
// tiles in tile order (deterministic, no atomics) and writes ata(i, j) and
// ata(j, i) from one sum, so ata is bit-symmetric. The partials buffer is
// allocated by the caller.

#include <cuda_runtime.h>

#define TN 128
#define MAX_LEVELS 8
#define MAX_DIM 32
#define KSTRIDE (TN + 1)
#define SUM_THREADS 256

struct LevelParams {
  float w[MAX_LEVELS];
  float rx[MAX_LEVELS];
  float ry[MAX_LEVELS];
};

// Output slot o < dim*(dim+1)/2 -> (i, j), i <= j, rows of the upper
// triangle in order (row i holds j = i .. dim-1).
__device__ __forceinline__ void pair_of(int o, int dim, int* i, int* j) {
  int row = 0;
  int start = 0;
  while (o >= start + (dim - row)) {
    start += dim - row;
    ++row;
  }
  *i = row;
  *j = row + (o - start);
}

__global__ void __launch_bounds__(TN) photo_reduce_tiles(
    const float* __restrict__ fgs, const float* __restrict__ f0,
    const float* __restrict__ gate, const float* __restrict__ kx,
    const float* __restrict__ ky, float* __restrict__ partial, int L, int C,
    int N, int dim, LevelParams p) {
  __shared__ float s_kx[MAX_DIM * KSTRIDE];
  __shared__ float s_ky[MAX_DIM * KSTRIDE];
  // gate^2-scaled gxx, gxy, gyy, hx, hy, sum_l w_l d^2, and gate^2
  __shared__ float s_g[7][TN];

  const int tile = blockIdx.x;
  const int e = blockIdx.y;
  const int t = threadIdx.x;
  const int n = tile * TN + t;
  const bool live = n < N;

  float gxx = 0.f, gxy = 0.f, gyy = 0.f, hx = 0.f, hy = 0.f, esum = 0.f;
  float g2 = 0.f;
  if (live) {
    const float g = gate[(size_t)e * N + n];
    g2 = g * g;
    for (int l = 0; l < L; ++l) {
      const float* fg = fgs + (size_t)(e * L + l) * 3 * C * N + n;
      const float* fz = f0 + (size_t)(e * L + l) * C * N + n;
      float sxx = 0.f, sxy = 0.f, syy = 0.f, sx = 0.f, sy = 0.f, sd = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float f1 = fg[(size_t)c * N];
        const float gx = fg[(size_t)(C + c) * N];
        const float gy = fg[(size_t)(2 * C + c) * N];
        const float d = fz[(size_t)c * N] - f1;
        sxx = fmaf(gx, gx, sxx);
        sxy = fmaf(gx, gy, sxy);
        syy = fmaf(gy, gy, syy);
        sx = fmaf(gx, d, sx);
        sy = fmaf(gy, d, sy);
        sd = fmaf(d, d, sd);
      }
      const float wl = p.w[l];
      const float rx = p.rx[l];
      const float ry = p.ry[l];
      gxx = fmaf(wl * rx * rx, sxx, gxx);
      gxy = fmaf(wl * rx * ry, sxy, gxy);
      gyy = fmaf(wl * ry * ry, syy, gyy);
      hx = fmaf(wl * rx, sx, hx);
      hy = fmaf(wl * ry, sy, hy);
      esum = fmaf(wl, sd, esum);
    }
  }
  s_g[0][t] = g2 * gxx;
  s_g[1][t] = g2 * gxy;
  s_g[2][t] = g2 * gyy;
  s_g[3][t] = g2 * hx;
  s_g[4][t] = g2 * hy;
  s_g[5][t] = g2 * esum;
  s_g[6][t] = g2;
  for (int r = 0; r < dim; ++r) {
    const size_t src = ((size_t)e * dim + r) * N + n;
    s_kx[r * KSTRIDE + t] = live ? kx[src] : 0.f;
    s_ky[r * KSTRIDE + t] = live ? ky[src] : 0.f;
  }
  __syncthreads();

  const int npairs = dim * (dim + 1) / 2;
  const int nout = npairs + dim + 2;
  const int count = min(TN, N - tile * TN);  // live points of this tile
  float* out = partial + ((size_t)e * gridDim.x + tile) * nout;
  for (int o = t; o < nout; o += TN) {
    float acc = 0.f;
    if (o < npairs) {
      int i, j;
      pair_of(o, dim, &i, &j);
      const float* xi = s_kx + i * KSTRIDE;
      const float* yi = s_ky + i * KSTRIDE;
      const float* xj = s_kx + j * KSTRIDE;
      const float* yj = s_ky + j * KSTRIDE;
      for (int m = 0; m < count; ++m) {
        const float kgx = fmaf(s_g[1][m], yj[m], s_g[0][m] * xj[m]);
        const float kgy = fmaf(s_g[2][m], yj[m], s_g[1][m] * xj[m]);
        acc = fmaf(xi[m], kgx, acc);
        acc = fmaf(yi[m], kgy, acc);
      }
    } else if (o < npairs + dim) {
      const float* xi = s_kx + (o - npairs) * KSTRIDE;
      const float* yi = s_ky + (o - npairs) * KSTRIDE;
      for (int m = 0; m < count; ++m) {
        acc = fmaf(xi[m], s_g[3][m], acc);
        acc = fmaf(yi[m], s_g[4][m], acc);
      }
    } else {
      const float* v = s_g[o == npairs + dim ? 5 : 6];
      for (int m = 0; m < count; ++m) acc += v[m];
    }
    out[o] = acc;
  }
}

__global__ void __launch_bounds__(SUM_THREADS) photo_reduce_sum(
    const float* __restrict__ partial, float* __restrict__ ata,
    float* __restrict__ atb, float* __restrict__ err,
    float* __restrict__ n_inl, int n_tiles, int dim) {
  const int e = blockIdx.x;
  const int npairs = dim * (dim + 1) / 2;
  const int nout = npairs + dim + 2;
  const float* src = partial + (size_t)e * n_tiles * nout;
  for (int o = threadIdx.x; o < nout; o += SUM_THREADS) {
    float acc = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) acc += src[(size_t)tile * nout + o];
    if (o < npairs) {
      int i, j;
      pair_of(o, dim, &i, &j);
      ata[((size_t)e * dim + i) * dim + j] = acc;
      ata[((size_t)e * dim + j) * dim + i] = acc;
    } else if (o < npairs + dim) {
      atb[(size_t)e * dim + (o - npairs)] = acc;
    } else if (o == npairs + dim) {
      err[e] = acc;
    } else {
      n_inl[e] = acc;
    }
  }
}

extern "C" int photo_reduce_num_tiles(int n) { return (n + TN - 1) / TN; }

extern "C" const char* photo_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// host_params: L weights, then L x-ratios, then L y-ratios (host memory).
// partial: [E, photo_reduce_num_tiles(N), dim*(dim+1)/2 + dim + 2] scratch.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int photo_reduce_launch(const float* fgs, const float* f0,
                                   const float* gate, const float* kx,
                                   const float* ky, float* partial, float* ata,
                                   float* atb, float* err, float* n_inl, int E,
                                   int L, int C, int N, int dim,
                                   const float* host_params, void* stream) {
  if (E < 1 || L < 1 || L > MAX_LEVELS || C < 1 || N < 1 || dim < 1 ||
      dim > MAX_DIM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelParams p = {};
  for (int l = 0; l < L; ++l) {
    p.w[l] = host_params[l];
    p.rx[l] = host_params[L + l];
    p.ry[l] = host_params[2 * L + l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = photo_reduce_num_tiles(N);
  photo_reduce_tiles<<<dim3(n_tiles, E), TN, 0, s>>>(fgs, f0, gate, kx, ky,
                                                      partial, L, C, N, dim, p);
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  photo_reduce_sum<<<E, SUM_THREADS, 0, s>>>(partial, ata, atb, err, n_inl,
                                             n_tiles, dim);
  return static_cast<int>(cudaGetLastError());
}
