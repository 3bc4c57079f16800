// The photometric factor's prep for Hopper (sm_90a): warp, target sampling
// and K-rows of every edge in one launch, FP32 only.
//
// Replaces no TPU kernel. The JAX package's photo_prep
// (sage_slam_tpu/ops/photometric.py) is vmapped XLA that the TPU compiler
// fuses; its torch port (ops/photometric.photo_prep, kept as the plain
// version) is a chain of about 340 tensor ops an LM iteration on the card:
// per-edge copies of the source tables, quad gathers, hat-weight matmuls for
// the coarse levels, stacks and cats. At the full-graph BA cell (E=372,
// N=3072) it took 64% of the device time and a quarter of the launches of
// an LM iteration. This kernel computes the same five tensors, the inputs of
// K1 (photo_reduce.cu), in their layouts:
//   fgs   [E, L, 3C, N]  target samples per level, rows f1 | gx | gy
//   f0    [E, L, C, N]   source features, channel-major
//   gate  [E, N]         (z > eps) * mask at the warped point
//   kx, ky [E, dim, N]   K-rows, dim = 13 + CS: pose0 (6), pose1 (6),
//                        code0 (CS), scale0 (1); CS <= 32
// from the window's tensors taken whole and the edge indices i0, i1:
//   rot [K, 3, 3], trans [K, 3], code [K, CS], scale [K]   the variables
//   homo [K, N, 3], bias_at [K, N], jac_at [K, N, CS]       source points
//     (or loc1d [K, N] into bias_flat [K, HW], jac_flat [K, HW, CS])
//   src [K, L, N, C]                                        source features
//   pixel [K, T, PW]  per pyramid pixel f1 | gx | gy | mask | zeros,
//                     PW = 3C + 1 rounded up to 4 (photo_prep.pixel_table)
//
// Bound: memory. At the cell's shape the kernel must write 1.44 GB (fgs
// 878 MB, f0 293 MB, kx + ky 265 MB, gate 5 MB) and read, at least once,
// the source rows of each distinct source keyframe (homo, the depth decode,
// the source features: 66 MB over 64 keyframes) and the pixel table of
// each distinct target frame (90 MB): 1.60 GB, 0.48 ms at 3.35 TB/s
// (chip_smoke.prep_bound counts it so). A thread re-reads its edge's source
// rows, 293 MB over 372 edges, most of it from L2. The arithmetic, a few
// hundred FP32 operations a point, is 1-2% of the FP32 peak's time.
//
// The design answers that bound:
// * One thread a point, grid (point blocks, E). Every output is
//   channel-major, so a warp's 32 threads write 32 neighbouring floats of
//   one row: each store is one coalesced 128-byte line.
// * Nothing per edge is copied first. A thread indexes the window's tables
//   by i0 / i1 itself (its edge's pose, code and scale are the same
//   addresses for the whole block and come from L1), and reads its own
//   source rows with contiguous loads (the features 16 bytes at a time).
// * Target sampling reads a point-major pixel table. The channel-major quad
//   tables (packed_fg [4*(3C+1), K*Tq]) would make every 4-byte value of a
//   point's gather a 32-byte sector of its own, 8x the bytes; a pixel row
//   of the point-major table is 208 contiguous bytes (C=16), and a
//   bilinear tap pair (x0, x1) 416. Each level is one zero-padded bilinear
//   gather: interp._quad_anchor's floor, clamp and nan_to_num, the four
//   bounds-masked weights, corners outside the image read as zero. That is
//   quad_gather_cols at every level and, exactly up to rounding, the
//   hat-weight matmuls (interp.dense_bilinear_cm) of the coarse levels:
//   outside the 2x2 taps the hat weights are zero.
// * The per-point geometry stays in registers: depth decode, warp through
//   R1^T R0, projection with the plain version's front / z rule, then the
//   13 + CS K-rows. The code width W, the length of the register array
//   that holds a point's code basis, is a template parameter, built at 16
//   and 32 (the kernel names carry it: photo_prep_points<16>); the wrapper
//   picks the smaller that holds CS. Coordinates and the bilinear combine
//   use round-to-nearest products and sums in the plain version's order
//   (no contraction into FMA), so a point at the same coordinates samples
//   the same bits.
// * FP32 only: no TF32, no atomics; the output is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#define PREP_MAX_LEVELS 8
#define PREP_THREADS 128

struct PrepCamera {
  float fx, fy, cx, cy, eps;
};

// Per level: size, first pixel within a frame's T pixels, focal ratios to
// level 0.
struct PrepLevels {
  int width[PREP_MAX_LEVELS];
  int height[PREP_MAX_LEVELS];
  int offset[PREP_MAX_LEVELS];
  float rx[PREP_MAX_LEVELS];
  float ry[PREP_MAX_LEVELS];
};

// round-to-nearest arithmetic that nvcc does not contract into FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// interp._int_coord: nan_to_num(f, nan=-2).clamp(-2, size + 1), then int
__device__ __forceinline__ int int_coord(float f, int size) {
  if (isnan(f)) return -2;
  return (int)fminf(fmaxf(f, -2.0f), (float)size + 1.0f);
}

// The four taps of a zero-padded bilinear gather at level coordinates
// (x, y) of a width x height image whose pixel rows start at base:
// interp._quad_anchor's weights, and the tap rows (null outside the image).
struct Taps {
  const float* row[4];  // (x0, y0), (x1, y0), (x0, y1), (x1, y1)
  float w[4];
};

__device__ __forceinline__ Taps bilinear_taps(const float* base, float x, float y, int width,
                                              int height, int pw) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx0 = sub(add(x0, 1.0f), x), wy0 = sub(add(y0, 1.0f), y);
  const float wx1 = sub(1.0f, wx0), wy1 = sub(1.0f, wy0);
  const int xi = int_coord(x0, width), yi = int_coord(y0, height);
  const bool ix0 = xi >= 0 && xi < width, ix1 = xi + 1 >= 0 && xi + 1 < width;
  const bool iy0 = yi >= 0 && yi < height, iy1 = yi + 1 >= 0 && yi + 1 < height;
  const float bx0 = ix0, bx1 = ix1, by0 = iy0, by1 = iy1;
  Taps t;
  // products in the order of _quad_anchor: wx * wy * bx * by (a NaN
  // coordinate gives NaN weights there too)
  t.w[0] = mul(mul(mul(wx0, wy0), bx0), by0);
  t.w[1] = mul(mul(mul(wx1, wy0), bx1), by0);
  t.w[2] = mul(mul(mul(wx0, wy1), bx0), by1);
  t.w[3] = mul(mul(mul(wx1, wy1), bx1), by1);
  const long long r0 = (long long)yi * width + xi;
  t.row[0] = (ix0 && iy0) ? base + r0 * pw : nullptr;
  t.row[1] = (ix1 && iy0) ? base + (r0 + 1) * pw : nullptr;
  t.row[2] = (ix0 && iy1) ? base + (r0 + width) * pw : nullptr;
  t.row[3] = (ix1 && iy1) ? base + (r0 + width + 1) * pw : nullptr;
  return t;
}

__device__ __forceinline__ float4 tap4(const float* row, int ch) {
  return row ? __ldg(reinterpret_cast<const float4*>(row + ch)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float tap1(const float* row, int ch) { return row ? __ldg(row + ch) : 0.0f; }

// interp.combine_quad_cm's order: ((v00 w00 + v10 w10) + v01 w01) + v11 w11
__device__ __forceinline__ float combine(float a, float b, float c, float d, const float* w) {
  return add(add(add(mul(a, w[0]), mul(b, w[1])), mul(c, w[2])), mul(d, w[3]));
}

template <int W>
__global__ void __launch_bounds__(PREP_THREADS) photo_prep_points(
    const float* __restrict__ rot, const float* __restrict__ trans, const float* __restrict__ code,
    const float* __restrict__ scale, const long long* __restrict__ i0,
    const long long* __restrict__ i1, const float* __restrict__ homo,
    const float* __restrict__ bias_at, const float* __restrict__ jac_at,
    const long long* __restrict__ loc1d, const float* __restrict__ bias_flat,
    const float* __restrict__ jac_flat, const float* __restrict__ src,
    const float* __restrict__ pixel, float* __restrict__ fgs, float* __restrict__ f0,
    float* __restrict__ gate, float* __restrict__ kx, float* __restrict__ ky, int N, int HW, int T,
    int PW, int C, int CS, int L, int soft, PrepCamera cam, PrepLevels lv) {
  const int n = blockIdx.x * PREP_THREADS + threadIdx.x;
  const int e = blockIdx.y;
  if (n >= N) return;
  const int dim = 13 + CS;
  const int C3 = 3 * C;
  const long long k0 = i0[e], k1 = i1[e];
  const float* R0 = rot + k0 * 9;
  const float* R1 = rot + k1 * 9;
  const float* t0 = trans + k0 * 3;
  const float* t1 = trans + k1 * 3;

  // ---- relative pose: R10 = R1^T R0, t10 = R1^T (t0 - t1) ----
  float r10[9], t10[3];
  {
    const float d[3] = {sub(t0[0], t1[0]), sub(t0[1], t1[1]), sub(t0[2], t1[2])};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        r10[i * 3 + j] = fmaf(R1[6 + i], R0[6 + j], fmaf(R1[3 + i], R0[3 + j], R1[i] * R0[j]));
      t10[i] = fmaf(R1[6 + i], d[2], fmaf(R1[3 + i], d[1], R1[i] * d[0]));
    }
  }

  // ---- depth decode at the source pixel: scale * (bias + code . jac) ----
  const long long pt = k0 * N + n;
  const float* jac;
  float bias;
  if (bias_at != nullptr) {
    bias = bias_at[pt];
    jac = jac_at + pt * CS;
  } else {
    const long long px = k0 * HW + loc1d[pt];
    bias = bias_flat[px];
    jac = jac_flat + px * CS;
  }
  const float* code0 = code + k0 * CS;
  float jv[W];
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k < CS) {
      jv[k] = jac[k];
      dot = fmaf(code0[k], jv[k], dot);
    }
  }
  const float s0 = scale[k0];
  const float depth0 = mul(s0, add(bias, dot));

  // ---- warp and projection (ops/photometric._warp_project_cm) ----
  const float h[3] = {homo[pt * 3], homo[pt * 3 + 1], homo[pt * 3 + 2]};
  float rh[3], x1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rh[i] = fmaf(r10[i * 3 + 2], h[2], fmaf(r10[i * 3 + 1], h[1], r10[i * 3] * h[0]));
    x1[i] = add(mul(depth0, rh[i]), t10[i]);
  }
  const bool front = x1[2] > cam.eps;
  const float pos = front ? 1.0f : 0.0f;
  // gated-out points must not divide by ~0 z (0-gate times inf = NaN)
  const float z = front ? x1[2] : 1.0f;
  const float u1 = add(mul(__fdiv_rn(x1[0], z), cam.fx), cam.cx);
  const float v1 = add(mul(__fdiv_rn(x1[1], z), cam.fy), cam.cy);

  // ---- K-rows (ops/photometric.photo_prep) ----
  {
    const float inv_z = __fdiv_rn(1.0f, z);
    const float xz = mul(x1[0], inv_z), yz = mul(x1[1], inv_z);
    const float fxz = mul(cam.fx, inv_z), fyz = mul(cam.fy, inv_z);
    // world point xw = depth0 (R0 h) + t0; a = R1^T
    float xw[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      xw[i] = add(mul(depth0, fmaf(R0[i * 3 + 2], h[2], fmaf(R0[i * 3 + 1], h[1], R0[i * 3] * h[0]))),
                  t0[i]);
    float kxp[6], kyp[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // a[r][k] = R1[k][r]
      kxp[k] = mul(fxz, sub(R1[k * 3], mul(xz, R1[k * 3 + 2])));
      kyp[k] = mul(fyz, sub(R1[k * 3 + 1], mul(yz, R1[k * 3 + 2])));
    }
    // the columns of -hat(xw)
    const float nh[3][3] = {{0.0f, -xw[2], xw[1]}, {xw[2], 0.0f, -xw[0]}, {-xw[1], xw[0], 0.0f}};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float jr[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        jr[r] = fmaf(R1[6 + r], nh[m][2], fmaf(R1[3 + r], nh[m][1], R1[r] * nh[m][0]));
      kxp[3 + m] = mul(fxz, sub(jr[0], mul(xz, jr[2])));
      kyp[3 + m] = mul(fyz, sub(jr[1], mul(yz, jr[2])));
    }
    const float dx =
        mul(cam.fx, sub(mul(rh[0], inv_z), mul(mul(mul(x1[0], rh[2]), inv_z), inv_z)));
    const float dy =
        mul(cam.fy, sub(mul(rh[1], inv_z), mul(mul(mul(x1[1], rh[2]), inv_z), inv_z)));
    float* kxo = kx + (long long)e * dim * N + n;
    float* kyo = ky + (long long)e * dim * N + n;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      kxo[(long long)r * N] = kxp[r];
      kyo[(long long)r * N] = kyp[r];
      kxo[(long long)(6 + r) * N] = -kxp[r];
      kyo[(long long)(6 + r) * N] = -kyp[r];
    }
    const float dxs = mul(dx, s0), dys = mul(dy, s0);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < CS) {
        kxo[(long long)(12 + k) * N] = mul(dxs, jv[k]);
        kyo[(long long)(12 + k) * N] = mul(dys, jv[k]);
      }
    }
    const float ds = __fdiv_rn(depth0, s0);
    kxo[(long long)(12 + CS) * N] = mul(dx, ds);
    kyo[(long long)(12 + CS) * N] = mul(dy, ds);
  }

  // ---- source features, transposed: f0[e, l, c, n] = src[i0, l, n, c] ----
  for (int l = 0; l < L; ++l) {
    const float* s = src + ((k0 * L + l) * N + n) * C;
    float* o = f0 + (((long long)e * L + l) * C) * N + n;
    for (int c = 0; c < C; c += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(s + c));
      o[(long long)c * N] = v.x;
      o[(long long)(c + 1) * N] = v.y;
      o[(long long)(c + 2) * N] = v.z;
      o[(long long)(c + 3) * N] = v.w;
    }
  }

  // ---- target samples per level and the gate ----
  const float* frame = pixel + k1 * T * PW;
  float within = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int wl = lv.width[l], hl = lv.height[l];
    // interp.level_coords: (p + 0.5) * ratio - 0.5
    const float ul = sub(mul(add(u1, 0.5f), lv.rx[l]), 0.5f);
    const float vl = sub(mul(add(v1, 0.5f), lv.ry[l]), 0.5f);
    const float* base = frame + (long long)lv.offset[l] * PW;
    const Taps t = bilinear_taps(base, ul, vl, wl, hl, PW);
    float* o = fgs + (((long long)e * L + l) * C3) * N + n;
#pragma unroll 2
    for (int ch = 0; ch < C3; ch += 4) {
      const float4 a = tap4(t.row[0], ch), b = tap4(t.row[1], ch);
      const float4 c = tap4(t.row[2], ch), d = tap4(t.row[3], ch);
      o[(long long)ch * N] = combine(a.x, b.x, c.x, d.x, t.w);
      o[(long long)(ch + 1) * N] = combine(a.y, b.y, c.y, d.y, t.w);
      o[(long long)(ch + 2) * N] = combine(a.z, b.z, c.z, d.z, t.w);
      o[(long long)(ch + 3) * N] = combine(a.w, b.w, c.w, d.w, t.w);
    }
    if (l == 0) {
      if (soft) {  // interp.quad_bilinear_select_cm on the mask column
        within = combine(tap1(t.row[0], C3), tap1(t.row[1], C3), tap1(t.row[2], C3),
                         tap1(t.row[3], C3), t.w);
      } else {  // interp.quad_nearest_select_cm: nearest pixel, half up
        const float fx0 = floorf(ul), fy0 = floorf(vl);
        const int xr = int_coord(fx0, wl) + (sub(ul, fx0) >= 0.5f ? 1 : 0);
        const int yr = int_coord(fy0, hl) + (sub(vl, fy0) >= 0.5f ? 1 : 0);
        const bool inb = xr >= 0 && xr < wl && yr >= 0 && yr < hl;
        within = inb ? __ldg(base + ((long long)yr * wl + xr) * PW + C3) : 0.0f;
      }
    }
  }
  gate[(long long)e * N + n] = mul(pos, within);
}

extern "C" const char* photo_prep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch on the current device's stream. width: the instantiation, 16
// or 32, with CS <= width; cam: fx, fy, cx, cy, eps; levels: width, height,
// offset of each level; ratios: rx, ry of each level. bias_at and jac_at
// may be null (then loc1d, bias_flat and jac_flat are read). The wrapper
// (ops/photo_prep.py) checks every shape, dtype, alignment and limit
// first. Returns 0 or a CUDA error code.
extern "C" int photo_prep_launch(const float* rot, const float* trans, const float* code,
                                 const float* scale, const long long* i0, const long long* i1,
                                 const float* homo, const float* bias_at, const float* jac_at,
                                 const long long* loc1d, const float* bias_flat,
                                 const float* jac_flat, const float* src, const float* pixel,
                                 float* fgs, float* f0, float* gate, float* kx, float* ky, int E,
                                 int N, int HW, int T, int PW, int C, int CS, int width, int L,
                                 int soft, const float* cam, const int* levels,
                                 const float* ratios, void* stream) {
  if (L < 1 || L > PREP_MAX_LEVELS || CS < 0 || CS > width || (width != 16 && width != 32) ||
      C % 4 != 0 || PW % 4 != 0 || E < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PrepCamera c{cam[0], cam[1], cam[2], cam[3], cam[4]};
  PrepLevels lv{};
  for (int l = 0; l < L; ++l) {
    lv.width[l] = levels[3 * l];
    lv.height[l] = levels[3 * l + 1];
    lv.offset[l] = levels[3 * l + 2];
    lv.rx[l] = ratios[2 * l];
    lv.ry[l] = ratios[2 * l + 1];
  }
  const dim3 grid((N + PREP_THREADS - 1) / PREP_THREADS, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 16) {
    photo_prep_points<16><<<grid, PREP_THREADS, 0, s>>>(
        rot, trans, code, scale, i0, i1, homo, bias_at, jac_at, loc1d, bias_flat, jac_flat, src,
        pixel, fgs, f0, gate, kx, ky, N, HW, T, PW, C, CS, L, soft, c, lv);
  } else {
    photo_prep_points<32><<<grid, PREP_THREADS, 0, s>>>(
        rot, trans, code, scale, i0, i1, homo, bias_at, jac_at, loc1d, bias_flat, jac_flat, src,
        pixel, fgs, f0, gate, kx, ky, N, HW, T, PW, C, CS, L, soft, c, lv);
  }
  return static_cast<int>(cudaGetLastError());
}
