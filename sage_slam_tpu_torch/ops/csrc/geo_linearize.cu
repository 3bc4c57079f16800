// The geometric factor's linearization for Hopper (sm_90a): frame-1 decode,
// warp, sampling, rows and their Gram in three launches, FP32 only.
//
// Replaces no TPU kernel. The JAX package's geometric_jac_error
// (sage_slam_tpu/ops/geometric.py) is vmapped XLA that the TPU compiler
// fuses; its torch port (ops/geometric.build_frame1_tables +
// geometric_jac_error, kept as the plain version) is a chain of about 300
// tensor ops an LM iteration on the card: the 64 keyframes' frame-1 tables
// decoded, differentiated and quad-packed, then the warp, the quad gathers,
// ~40 stacks and cats for the 14 + 2CS rows and two batched products. This
// kernel family computes the same four outputs, un-PSD-corrected:
//   ata   [E, D, D]  w / n_inl * sum_n rows rows^T, D = 14 + 2CS, CS <= 32
//                    and a multiple of 4 (the code rows are read as float4)
//   atb   [E, D]     w / n_inl * sum_n rows diff
//   error [E]        w / n_inl * sum_n err_pt (w * 10 without inliers)
//   n_inl [E]        sum_n pos * within
// from the window's tensors taken whole and the edge indices i0, i1:
//   rot [K, 3, 3], trans [K, 3], code [K, CS], scale [K]   the variables
//   homo [K, N, 3], bias_at [K, N], jac_at [K, N, CS]       source points
//     (or loc1d [K, N] into bias_flat [K, HW], jac_flat [K, HW, CS])
//   bias_flat, jac_flat, mask [HW]                          target frames
//   avg_sq_bias [K]  the robust loss's scale: loss_factor * avg_sq_bias[i0]
//
// Bound: FP32 compute. Per point the Gram's upper triangle and the
// gradient, E N (D (D + 1) + 2 D) operations: 2.58 GFLOP at the full-graph
// cell (E=372, N=3072, CS=16), 7.22 at CS=32, 0.038 and 0.108 ms at 67
// TFLOP/s; the bytes (the distinct source rows, the target frames' tables
// and jac rows, the outputs) are 50-100 MB, 0.02-0.03 ms
// (chip_smoke.geo_bound counts both).
//
// The design answers that bound:
// * Three launches. geo_frame1_table decodes each keyframe's depth once a
//   linearization (bias + jac . code, scaled) with its central-difference
//   gradient (replicated border) into a point-major float4 table [K, HW]
//   (depth, gx, gy, mask): the rows of build_frame1_tables' quad table
//   less the jacobian, which is read in place from jac_flat.
//   geo_split_points<W> sums one point range of one edge; geo_combine<W>
//   sums the splits in split order, normalises and mirrors.
// * The rows never reach device memory. A split block walks its range in
//   128-point tiles. First each thread computes one point: the source
//   decode, the warp and projection with _warp_project_cm's front / z rule,
//   the zero-padded bilinear sample of the table and of the four corners'
//   jac_flat rows (interp._quad_anchor's floor, clamp and bounds-masked
//   weights over the quad table's four slots, read where pack_quads_level
//   puts them, so a NaN beside the image reaches the sample as in the
//   plain version), the nearest-pixel mask (half up, quad_nearest_select_cm), the
//   robust weight, and the D rows in geometric_jac_error's order, written
//   with diff, a ones row, err_pt and pos * within into shared memory as
//   [quad][row][4 points]. Then the block contracts the tile: the Gram of
//   the D + 4 rows padded to P (56 at W = 16, 88 at W = 32) gives ata
//   (rows x rows), atb (rows x diff), the error (ones x err_pt) and n_inl
//   (ones x pos within) from one loop.
// * The contraction is register-tiled as K1's (photo_reduce.cu): two
//   point groups of 64 threads, each thread (P/8) x (P/8) outputs (rows
//   ti + 8a, columns tj + 8b) over its group's quads, upper triangle only,
//   one 16-byte shared load feeding 4 FMAs per output; the groups' sums
//   are added in group order, then written as the split's partial.
// * What bounds it in practice is the first step, not the Gram: without
//   the contraction the split kernel (then with 256-point tiles) still
//   took 0.165 ms at CS = 16 and 0.406 at CS = 32 (E = 372, N = 3072,
//   H100 at 700 W), against 0.254 and 0.663 with it. The samples come in random order (the mapper's randperm), so
//   a tile's four-corner reads of jac_flat rows scatter over the whole
//   target frame, and the 64 frames' code bases (21 / 42 MB) and source
//   rows do not stay in the L2 together: the step reads scattered sectors.
//   Tried and not kept: reading the code rows through each warp together
//   (lanes along a row: 10% faster at CS = 32, 14% slower at 16), one
//   block an SM, 256-point tiles (5-14% slower than these 128-point ones).
// * Arithmetic in the plain version's order: round-to-nearest products
//   and sums that nvcc does not contract into FMA wherever the plain
//   version runs separate elementwise ops, FMA chains where it runs a
//   batched product. The code width W, the register array of a point's
//   source code basis, is a template parameter built at 16 and 32 (the
//   kernel names carry it: geo_split_points<16>).
// * FP32 only: no TF32, no atomics; the output is deterministic and ata
//   exactly symmetric (both halves read one sum).

#include <cuda_runtime.h>
#include <stdint.h>

#define GEO_THREADS 128                // threads of a split block, points of a tile
#define GEO_QUADS (GEO_THREADS / 4)    // 4-point groups of a tile
#define GEO_GROUPS (GEO_THREADS / 64)  // point groups of the contraction
#define TABLE_THREADS 256
#define TABLE_ROWS 8                   // image rows of a table block
#define COMBINE_THREADS 256
#define GEO_MAX_SHARED (48 * 1024)     // the table launch's halo rows must fit

// fx, fy, cx, cy, eps, the robust loss's factor, the factor weight and
// its error without inliers (w * 10, rounded from double on the host)
struct GeoParams {
  float fx, fy, cx, cy, eps, loss_factor, weight, weight10;
};

// The code width W's instantiation: rows D <= 14 + 2W, plus diff, ones,
// err_pt and pos * within, padded to P; its shared memory in floats.
template <int W>
struct GeoLay {
  static constexpr int MAX_DIM = 14 + 2 * W;
  static constexpr int P = (MAX_DIM + 4 + 7) / 8 * 8;
  static constexpr int R = P / 8;               // a thread's outputs along each axis
  static constexpr int QS = P + 1;              // a quad's stride in float4: conflict-free stores
  // resident blocks an SM: 122 registers a thread at W = 16; 254 at 32
  // (two blocks, no spill: four spilled and ran 9% slower)
  static constexpr int MIN_BLOCKS = W <= 16 ? 4 : 2;
  static constexpr int SMEM_FLOATS = GEO_QUADS * QS * 4;
  static constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
  static_assert(P * P <= SMEM_FLOATS, "the group sums fit in the rows' area");
};

// round-to-nearest arithmetic that nvcc does not contract into FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// interp._int_coord: nan_to_num(f, nan=-2).clamp(-2, size + 1), then int
__device__ __forceinline__ int int_coord(float f, int size) {
  if (isnan(f)) return -2;
  return (int)fminf(fmaxf(f, -2.0f), (float)size + 1.0f);
}

// bias + jac . code of one pixel (build_frame1_tables' unscaled depth)
__device__ __forceinline__ float decode(const float* __restrict__ jac, float bias,
                                        const float* __restrict__ code, int CS) {
  float dot = 0.0f;
  for (int k = 0; k < CS; k += 4) {
    const float4 j = __ldg(reinterpret_cast<const float4*>(jac + k));
    dot = fmaf(j.x, code[k], dot);
    dot = fmaf(j.y, code[k + 1], dot);
    dot = fmaf(j.z, code[k + 2], dot);
    dot = fmaf(j.w, code[k + 3], dot);
  }
  return add(bias, dot);
}

// Per pixel of keyframe blockIdx.y, image rows TABLE_ROWS * blockIdx.x on:
// (scale depth, scale gx, scale gy, mask), gx and gy pyramid.spatial_grad's
// central differences with a replicated border. The block decodes its rows
// and one halo row each side into shared memory first.
__global__ void __launch_bounds__(TABLE_THREADS) geo_frame1_table(
    const float* __restrict__ bias_flat, const float* __restrict__ jac_flat,
    const float* __restrict__ code, const float* __restrict__ scale,
    const float* __restrict__ mask, float4* __restrict__ table, int HW, int width, int height,
    int CS) {
  extern __shared__ float u_s[];
  const int k = blockIdx.y;
  const int y0 = blockIdx.x * TABLE_ROWS;
  const int ylo = max(y0 - 1, 0), yhi = min(y0 + TABLE_ROWS + 1, height);
  const float* bias = bias_flat + (long long)k * HW;
  const float* jac = jac_flat + (long long)k * HW * CS;
  const float* c = code + (long long)k * CS;
  for (int p = threadIdx.x; p < (yhi - ylo) * width; p += TABLE_THREADS) {
    const long long px = (long long)ylo * width + p;
    u_s[p] = decode(jac + px * CS, __ldg(bias + px), c, CS);
  }
  __syncthreads();
  const float s = scale[k];
  const int rows = min(TABLE_ROWS, height - y0);
  for (int p = threadIdx.x; p < rows * width; p += TABLE_THREADS) {
    const int y = y0 + p / width, x = p % width;
    const float* r = u_s + (y - ylo) * width;
    const float u = r[x];
    const float gx = mul(0.5f, sub(r[min(x + 1, width - 1)], r[max(x - 1, 0)]));
    const float gy = mul(0.5f, sub(u_s[(min(y + 1, height - 1) - ylo) * width + x],
                                   u_s[(max(y - 1, 0) - ylo) * width + x]));
    const int px = y * width + x;
    table[(long long)k * HW + px] = make_float4(mul(s, u), mul(s, gx), mul(s, gy), __ldg(mask + px));
  }
}

// interp.combine_quad_cm's order: ((v00 w00 + v10 w10) + v01 w01) + v11 w11
__device__ __forceinline__ float combine(float a, float b, float c, float d, const float* w) {
  return add(add(add(mul(a, w[0]), mul(b, w[1])), mul(c, w[2])), mul(d, w[3]));
}

// The first point of split s of [0, N).
__device__ __forceinline__ int split_start(int s, int splits, int N) {
  return (int)((long long)s * N / splits);
}

// One point's augmented rows into the tile: D rows (times sqrt_w), diff,
// 1, err_pt, pos * within; all zero for a point past the range.
template <int W>
__device__ __forceinline__ void point_rows(
    float* __restrict__ S, int m, bool live, int e, int n, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ code,
    const float* __restrict__ scale, long long k0, long long k1,
    const float* __restrict__ homo, const float* __restrict__ bias_at,
    const float* __restrict__ jac_at, const long long* __restrict__ loc1d,
    const float* __restrict__ bias_flat, const float* __restrict__ jac_flat,
    const float4* __restrict__ table, const float* __restrict__ r10,
    const float* __restrict__ t10, float lp, int N, int HW, int width, int height, int CS,
    const GeoParams& g) {
  using Lay = GeoLay<W>;
  const int D = 14 + 2 * CS;
  float* out = S + (m >> 2) * Lay::QS * 4 + (m & 3);  // row r at out[4 r]
  if (!live) {
    for (int r = 0; r < D + 4; ++r) out[4 * r] = 0.0f;
    return;
  }
  const float* R0 = rot + k0 * 9;
  const float* R1 = rot + k1 * 9;
  const float* t0 = trans + k0 * 3;

  // ---- source decode: scale0 * (bias + code0 . jac) ----
  const long long pt = k0 * N + n;
  const float* jac;
  float bias;
  if (bias_at != nullptr) {
    bias = __ldg(bias_at + pt);
    jac = jac_at + pt * CS;
  } else {
    const long long px = k0 * HW + loc1d[pt];
    bias = __ldg(bias_flat + px);
    jac = jac_flat + px * CS;
  }
  const float* code0 = code + k0 * CS;
  float jv[W];
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    if (k < CS) {
      const float4 j = __ldg(reinterpret_cast<const float4*>(jac + k));
      jv[k] = j.x, jv[k + 1] = j.y, jv[k + 2] = j.z, jv[k + 3] = j.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) dot = fmaf(code0[k + i], jv[k + i], dot);
    }
  }
  const float s0 = scale[k0], s1 = scale[k1];
  const float depth0 = mul(s0, add(bias, dot));

  // ---- warp and projection (photometric._warp_project_cm) ----
  const float h[3] = {__ldg(homo + pt * 3), __ldg(homo + pt * 3 + 1), __ldg(homo + pt * 3 + 2)};
  float rh[3], x1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rh[i] = fmaf(r10[i * 3 + 2], h[2], fmaf(r10[i * 3 + 1], h[1], r10[i * 3] * h[0]));
    x1[i] = add(mul(depth0, rh[i]), t10[i]);
  }
  const bool front = x1[2] > g.eps;
  const float pos = front ? 1.0f : 0.0f;
  // gated-out points must not divide by ~0 z (0-gate times inf = NaN)
  const float z = front ? x1[2] : 1.0f;
  const float u1 = add(mul(div(x1[0], z), g.fx), g.cx);
  const float v1 = add(mul(div(x1[1], z), g.fy), g.cy);

  // ---- the four taps at (u1, v1) (interp._quad_anchor) ----
  const float x0f = floorf(u1), y0f = floorf(v1);
  const float wx0 = sub(add(x0f, 1.0f), u1), wy0 = sub(add(y0f, 1.0f), v1);
  const float wx1 = sub(1.0f, wx0), wy1 = sub(1.0f, wy0);
  const int xi = int_coord(x0f, width), yi = int_coord(y0f, height);
  const bool ix0 = xi >= 0 && xi < width, ix1 = xi + 1 >= 0 && xi + 1 < width;
  const bool iy0 = yi >= 0 && yi < height, iy1 = yi + 1 >= 0 && yi + 1 < height;
  const float bx0 = ix0, bx1 = ix1, by0 = iy0, by1 = iy1;
  // products in the order of _quad_anchor: wx * wy * bx * by
  const float w4[4] = {mul(mul(mul(wx0, wy0), bx0), by0), mul(mul(mul(wx1, wy0), bx1), by0),
                       mul(mul(mul(wx0, wy1), bx0), by1), mul(mul(mul(wx1, wy1), bx1), by1)};
  // The quad table's four slots (interp.pack_quads_level): the pixels
  // q0 + {0, 1, width, width + 1} of the frame's flat rows, q0 from the
  // anchor clipped to [-1, size - 1], zero outside [0, HW). A slot whose
  // corner lies outside the image carries a zero weight but is still read,
  // so a NaN there reaches the sample as in the plain version.
  const long long frame = k1 * HW;
  const int q0 = min(max(yi, -1), height - 1) * width + min(max(xi, -1), width - 1);
  long long tap[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int p = q0 + (c & 1) + (c >> 1) * width;
    tap[c] = p >= 0 && p < HW ? frame + p : -1;
  }
  float4 tv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) tv[c] = tap[c] >= 0 ? __ldg(table + tap[c]) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float d1 = combine(tv[0].x, tv[1].x, tv[2].x, tv[3].x, w4);
  const float g1x = combine(tv[0].y, tv[1].y, tv[2].y, tv[3].y, w4);
  const float g1y = combine(tv[0].z, tv[1].z, tv[2].z, tv[3].z, w4);
  // the mask at the nearest pixel, half up (interp.quad_nearest_select_cm)
  float within;
  {
    const int xr = int_coord(x0f, width) + (sub(u1, x0f) >= 0.5f ? 1 : 0);
    const int yr = int_coord(y0f, height) + (sub(v1, y0f) >= 0.5f ? 1 : 0);
    const bool inb = xr >= 0 && xr < width && yr >= 0 && yr < height;
    within = inb ? __ldg(table + frame + (long long)yr * width + xr).w : 0.0f;
  }

  // ---- robust weight (ops/geometric.geometric_jac_error) ----
  const float z1 = z;
  const float raw = sub(d1, z1);
  const float wr = mul(within, raw);
  const float err_pt = mul(pos, log1pf(div(mul(wr, wr), lp)));
  const float sqrt_w = mul(mul(pos, within), rsqrtf(add(mul(raw, raw), lp)));

  // ---- the rows: pose0 (6), pose1 (6), code0 (CS), code1 (CS), scale0, scale1 ----
  const float inv_z = div(1.0f, z1);
  const float xz = mul(x1[0], inv_z), yz = mul(x1[1], inv_z);
  const float fxz = mul(g.fx, inv_z), fyz = mul(g.fy, inv_z);
  float xw[3];  // depth0 (R0 h) + t0
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xw[i] = add(mul(depth0, fmaf(R0[i * 3 + 2], h[2], fmaf(R0[i * 3 + 1], h[1], R0[i * 3] * h[0]))),
                t0[i]);
  // a = R1^T: a[r][k] = R1[k][r]
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    const float kx = mul(fxz, sub(R1[kk * 3], mul(xz, R1[kk * 3 + 2])));
    const float ky = mul(fyz, sub(R1[kk * 3 + 1], mul(yz, R1[kk * 3 + 2])));
    const float jp = mul(sub(R1[kk * 3 + 2], add(mul(g1x, kx), mul(g1y, ky))), sqrt_w);
    out[4 * kk] = jp;
    out[4 * (6 + kk)] = -jp;
  }
  // the columns of -hat(xw)
  const float nh[3][3] = {{0.0f, -xw[2], xw[1]}, {xw[2], 0.0f, -xw[0]}, {-xw[1], xw[0], 0.0f}};
#pragma unroll
  for (int m3 = 0; m3 < 3; ++m3) {
    float jr[3];  // a @ nh[m3]
#pragma unroll
    for (int r = 0; r < 3; ++r)
      jr[r] = fmaf(R1[6 + r], nh[m3][2], fmaf(R1[3 + r], nh[m3][1], R1[r] * nh[m3][0]));
    const float kx = mul(fxz, sub(jr[0], mul(xz, jr[2])));
    const float ky = mul(fyz, sub(jr[1], mul(yz, jr[2])));
    const float jp = mul(sub(jr[2], add(mul(g1x, kx), mul(g1y, ky))), sqrt_w);
    out[4 * (3 + m3)] = jp;
    out[4 * (9 + m3)] = -jp;
  }
  const float dx = mul(g.fx, sub(mul(rh[0], inv_z), mul(mul(mul(x1[0], rh[2]), inv_z), inv_z)));
  const float dy = mul(g.fy, sub(mul(rh[1], inv_z), mul(mul(mul(x1[1], rh[2]), inv_z), inv_z)));
  const float cz = sub(rh[2], add(mul(g1x, dx), mul(g1y, dy)));  // rh_z - d1_jac_dpt0
  const float cs0 = mul(cz, s0);
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < CS) out[4 * (12 + k)] = mul(mul(cs0, jv[k]), sqrt_w);
  // code1: -s1 times the bilinear sample of the four corners' jac rows
  const float ns1 = -s1;
  const float* jr4[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) jr4[c] = tap[c] >= 0 ? jac_flat + tap[c] * CS : nullptr;
  for (int k = 0; k < CS; k += 4) {
    float v[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (jr4[c] == nullptr) {
        v[c][0] = v[c][1] = v[c][2] = v[c][3] = 0.0f;
      } else {
        const float4 t = __ldg(reinterpret_cast<const float4*>(jr4[c] + k));
        v[c][0] = t.x, v[c][1] = t.y, v[c][2] = t.z, v[c][3] = t.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[4 * (12 + CS + k + i)] =
          mul(mul(ns1, combine(v[0][i], v[1][i], v[2][i], v[3][i], w4)), sqrt_w);
  }
  out[4 * (12 + 2 * CS)] = mul(div(mul(cz, depth0), s0), sqrt_w);
  out[4 * (13 + 2 * CS)] = mul(div(-d1, s1), sqrt_w);
  out[4 * D] = mul(sqrt_w, raw);
  out[4 * (D + 1)] = 1.0f;
  out[4 * (D + 2)] = err_pt;
  out[4 * (D + 3)] = mul(pos, within);
}

// Per block: the augmented Gram's upper triangle over one point range of
// edge blockIdx.y, written to partial[e, split].
template <int W>
__global__ void __launch_bounds__(GEO_THREADS, GeoLay<W>::MIN_BLOCKS) geo_split_points(
    const float* __restrict__ rot, const float* __restrict__ trans,
    const float* __restrict__ code, const float* __restrict__ scale,
    const long long* __restrict__ i0, const long long* __restrict__ i1,
    const float* __restrict__ homo, const float* __restrict__ bias_at,
    const float* __restrict__ jac_at, const long long* __restrict__ loc1d,
    const float* __restrict__ bias_flat, const float* __restrict__ jac_flat,
    const float* __restrict__ avg_sq_bias, const float4* __restrict__ table,
    float* __restrict__ partial, int N, int HW, int width, int height, int CS, GeoParams g) {
  using Lay = GeoLay<W>;
  constexpr int P = Lay::P, R = Lay::R, QS = Lay::QS;
  extern __shared__ __align__(16) float S[];
  const int t = threadIdx.x;
  const int split = blockIdx.x, splits = gridDim.x;
  const int e = blockIdx.y;
  const int D = 14 + 2 * CS;
  const int lo = split_start(split, splits, N), hi = split_start(split + 1, splits, N);
  const long long k0 = i0[e], k1 = i1[e];

  // the edge's relative pose: R10 = R1^T R0, t10 = R1^T (t0 - t1)
  float r10[9], t10[3];
  {
    const float* R0 = rot + k0 * 9;
    const float* R1 = rot + k1 * 9;
    const float* t0 = trans + k0 * 3;
    const float* t1 = trans + k1 * 3;
    const float d[3] = {sub(t0[0], t1[0]), sub(t0[1], t1[1]), sub(t0[2], t1[2])};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        r10[i * 3 + j] = fmaf(R1[6 + i], R0[6 + j], fmaf(R1[3 + i], R0[3 + j], R1[i] * R0[j]));
      t10[i] = fmaf(R1[6 + i], d[2], fmaf(R1[3 + i], d[1], R1[i] * d[0]));
    }
  }
  const float lp = mul(g.loss_factor, avg_sq_bias[k0]);

  // padding rows D + 4 .. P - 1 stay zero
  for (int u = t; u < GEO_QUADS * (P - D - 4); u += GEO_THREADS) {
    const int q = u / (P - D - 4), row = D + 4 + u % (P - D - 4);
    reinterpret_cast<float4*>(S)[q * QS + row] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int grp = t / 64;
  const int ti = (t % 64) / 8, tj = t % 8;
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.0f;

  const float4* S4 = reinterpret_cast<const float4*>(S);
  for (int n0 = lo; n0 < hi; n0 += GEO_THREADS) {
    const int n = n0 + t;
    point_rows<W>(S, t, n < hi, e, n, rot, trans, code, scale, k0, k1, homo, bias_at, jac_at,
                  loc1d, bias_flat, jac_flat, table, r10, t10, lp, N, HW, width, height, CS, g);
    __syncthreads();
    const int live_quads = min(GEO_QUADS, (hi - n0 + 3) / 4);
    for (int q = grp; q < live_quads; q += GEO_GROUPS) {
      float4 ar[R];
#pragma unroll
      for (int a = 0; a < R; ++a) ar[a] = S4[q * QS + ti + 8 * a];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float4 bc = S4[q * QS + tj + 8 * b];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          // only the upper triangle (row <= column)
          if (a > b || (a == b && ti > tj)) continue;
          float s = acc[a][b];
          s = fmaf(ar[a].x, bc.x, s);
          s = fmaf(ar[a].y, bc.y, s);
          s = fmaf(ar[a].z, bc.z, s);
          s = fmaf(ar[a].w, bc.w, s);
          acc[a][b] = s;
        }
      }
    }
    __syncthreads();
  }

  // the groups' sums in group order -> this split's partial (upper triangle)
  float* red = S;
  for (int gi = 0; gi < GEO_GROUPS; ++gi) {
    if (grp == gi) {
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          if (a > b) continue;
          float* o = red + (ti + 8 * a) * P + tj + 8 * b;
          *o = gi == 0 ? acc[a][b] : *o + acc[a][b];
        }
    }
    __syncthreads();
  }
  float* mine = partial + ((long long)e * splits + split) * P * P;
  for (int o = t; o < P * P; o += GEO_THREADS) {
    if (o / P <= o % P) mine[o] = red[o];
  }
}

// Per (edge, output): the splits' partials summed in split order, then
// normalised by w / max(n_inl, 1) (0 without inliers). ata[r, c] and
// ata[c, r] read the same sum, so ata is exactly symmetric.
template <int W>
__global__ void __launch_bounds__(COMBINE_THREADS) geo_combine(
    const float* __restrict__ partial, float* __restrict__ ata, float* __restrict__ atb,
    float* __restrict__ error, float* __restrict__ n_inl, int splits, int CS, GeoParams g) {
  constexpr int P = GeoLay<W>::P;
  const int e = blockIdx.y;
  const int D = 14 + 2 * CS;
  const int o = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (o >= D * D + D + 2) return;
  const float* p = partial + (long long)e * splits * P * P;
  auto total = [&](int r, int c) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) sum += p[(long long)s * P * P + r * P + c];
    return sum;
  };
  const float n = total(D + 1, D + 3);
  const bool has = n > 0.0f;
  const float inv = has ? div(g.weight, fmaxf(n, 1.0f)) : 0.0f;
  if (o < D * D) {
    const int r = o / D, c = o % D;
    ata[(long long)e * D * D + o] = mul(inv, total(min(r, c), max(r, c)));
  } else if (o < D * D + D) {
    atb[(long long)e * D + o - D * D] = mul(inv, total(o - D * D, D));
  } else if (o == D * D + D) {
    error[e] = has ? mul(inv, total(D + 1, D + 2)) : g.weight10;
  } else {
    n_inl[e] = n;
  }
}

extern "C" const char* geo_linearize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <int W>
static int slots_for(void) {
  const int bytes = GeoLay<W>::SMEM_BYTES;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st == cudaSuccess) st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess) {
    st = cudaFuncSetAttribute(geo_split_points<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
  }
  if (st == cudaSuccess) {
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, geo_split_points<W>, GEO_THREADS,
                                                       bytes);
  }
  if (st != cudaSuccess) return -static_cast<int>(st);
  return per_sm * sms;
}

// Sets the width-W split kernel's shared-memory limit on the current device
// and returns its resident block slots (blocks per SM x SMs), or a negative
// CUDA error code. Call once per device and width before
// geo_linearize_launch.
extern "C" int geo_linearize_slots(int width) {
  if (width == 16) return slots_for<16>();
  if (width == 32) return slots_for<32>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The padded width P of the width-W instantiation (the partial's stride).
extern "C" int geo_linearize_pad(int width) {
  if (width == 16) return GeoLay<16>::P;
  if (width == 32) return GeoLay<32>::P;
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <int W>
static int launch(const float* rot, const float* trans, const float* code, const float* scale,
                  const long long* i0, const long long* i1, const float* homo,
                  const float* bias_at, const float* jac_at, const long long* loc1d,
                  const float* bias_flat, const float* jac_flat, const float* avg_sq_bias,
                  const float4* table, float* partial, float* ata, float* atb, float* error,
                  float* n_inl, int E, int N, int HW, int width, int height, int CS,
                  int splits, const GeoParams& g, cudaStream_t s) {
  geo_split_points<W><<<dim3(splits, E), GEO_THREADS, GeoLay<W>::SMEM_BYTES, s>>>(
      rot, trans, code, scale, i0, i1, homo, bias_at, jac_at, loc1d, bias_flat, jac_flat,
      avg_sq_bias, table, partial, N, HW, width, height, CS, g);
  cudaError_t st = cudaGetLastError();
  if (st != cudaSuccess) return static_cast<int>(st);
  const int outputs = (14 + 2 * CS) * (14 + 2 * CS) + (14 + 2 * CS) + 2;
  geo_combine<W><<<dim3((outputs + COMBINE_THREADS - 1) / COMBINE_THREADS, E), COMBINE_THREADS,
                   0, s>>>(partial, ata, atb, error, n_inl, splits, CS, g);
  return static_cast<int>(cudaGetLastError());
}

// Three launches on the current device's stream: the frame-1 table of the
// K keyframes, the splits, the combine. width: the instantiation, 16 or
// 32, with CS <= width and CS % 4 == 0; params: fx, fy, cx, cy, eps,
// loss_factor, weight, weight * 10 (host memory). bias_at and jac_at may
// be null (then loc1d, bias_flat and jac_flat are read); jac_flat and
// jac_at are 16-byte aligned, as the code rows are read as float4. table: [K, HW] float4 scratch;
// partial: [E, splits, P, P] scratch (P = geo_linearize_pad(width));
// splits <= N. The wrapper (ops/geo_linearize.py) checks every shape,
// dtype and limit first. Returns 0 or a CUDA error code.
extern "C" int geo_linearize_launch(
    const float* rot, const float* trans, const float* code, const float* scale,
    const long long* i0, const long long* i1, const float* homo, const float* bias_at,
    const float* jac_at, const long long* loc1d, const float* bias_flat, const float* jac_flat,
    const float* mask, const float* avg_sq_bias, float* table, float* partial, float* ata,
    float* atb, float* error, float* n_inl, int E, int K, int N, int HW, int width_px,
    int height_px, int CS, int width, int splits, const float* params, void* stream) {
  const size_t halo_bytes = (size_t)(TABLE_ROWS + 2) * width_px * sizeof(float);
  if (E < 1 || E > 65535 || K < 1 || K > 65535 || N < 1 || CS < 1 || CS > width ||
      (width != 16 && width != 32) || splits < 1 || splits > N || width_px < 1 ||
      height_px < 1 || (long long)width_px * height_px != HW || halo_bytes > GEO_MAX_SHARED ||
      CS % 4 != 0 || ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(jac_flat) |
                       reinterpret_cast<uintptr_t>(jac_at)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const GeoParams g{params[0], params[1], params[2], params[3],
                    params[4], params[5], params[6], params[7]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid((height_px + TABLE_ROWS - 1) / TABLE_ROWS, K);
  geo_frame1_table<<<tgrid, TABLE_THREADS, halo_bytes, s>>>(
      bias_flat, jac_flat, code, scale, mask, reinterpret_cast<float4*>(table), HW, width_px,
      height_px, CS);
  cudaError_t st = cudaGetLastError();
  if (st != cudaSuccess) return static_cast<int>(st);
  const float4* t4 = reinterpret_cast<const float4*>(table);
  if (width == 16) {
    return launch<16>(rot, trans, code, scale, i0, i1, homo, bias_at, jac_at, loc1d, bias_flat,
                      jac_flat, avg_sq_bias, t4, partial, ata, atb, error, n_inl, E, N, HW,
                      width_px, height_px, CS, splits, g, s);
  }
  return launch<32>(rot, trans, code, scale, i0, i1, homo, bias_at, jac_at, loc1d, bias_flat,
                    jac_flat, avg_sq_bias, t4, partial, ata, atb, error, n_inl, E, N, HW,
                    width_px, height_px, CS, splits, g, s);
}
