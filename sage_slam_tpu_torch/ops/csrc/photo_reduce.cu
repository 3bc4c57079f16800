// Fused photometric J^T W J reduce for Hopper (sm_90a), FP32 FMA only.
//
// Replaces the TPU kernel photo_reduce_pallas (sage_slam_tpu/ops/
// pallas_kernels.py:118, pl.pallas_call at :152); same function as
// photo_reduce_xla (sage_slam_tpu/ops/photometric.py:617). Inputs, all
// float32 and contiguous:
//   fgs  [E, L, 3C, N]  target samples, rows f1 | gx | gy (d-major grads)
//   f0   [E, L, C, N]   source features
//   gate [E, N]
//   kx, ky [E, dim, N]  K-rows, dim = 13 + CS <= 45
// Output, un-normalised, in the TPU kernel's padded layout: out [E, P, P]
// holds ata in [:dim, :dim], atb in column dim, err at [dim+1, dim+1] and
// n_inl at [dim+1, dim+2] (the wrapper returns views of it). The padded
// width P is a template parameter, built at 32 (dim <= 29, CS <= 16) and
// 48 (dim <= 45, CS <= 32); the wrapper picks the smaller that fits.
//
// Bound: memory. Every input is read once, about 93 MB at the window-BA
// bench point (E=24, L=4, C=16, N=3072, dim=29): 28 us at 3.35 TB/s. The
// contraction is ~0.3 GFLOP, ~5 us at the FP32 peak, so it must hide
// behind the stream rather than follow it. The design:
//
// * Split by what each input needs. fgs and f0 (81% of the bytes) feed one
//   point's Gram terms each: they go straight from device memory into
//   registers, 16-byte loads of 4 consecutive points (scalar loads when
//   N % 4 != 0 or a base is not 16-byte aligned), streaming cache hint.
//   Only the K-rows go through shared memory, by cp.async into a 2-stage
//   ring: tile t+1's copies are in flight while tile t is contracted.
// * Keep device memory streaming. Each block is warp-specialised: 6
//   producer warps stream fgs/f0 and reduce them to the per-point,
//   gate^2-scaled Gram terms of tile t+1 while 4 consumer warps contract
//   tile t; the two meet at named barriers over double-buffered terms in
//   shared memory. Loads wait for a contraction only when the consumers fall
//   two tiles behind, and the blocks need not drift apart.
// * A loop inside the block replaces the TPU's sequential grid axis. The
//   grid is (splits, E); a block walks one point range of one edge in
//   64-point tiles and keeps its PxP outputs in registers. The wrapper
//   sizes the splits to fill every resident block slot once, and the
//   ranges are equal to 4 points (not whole tiles), so no SM waits on
//   another. A second tiny pass sums the splits of each edge in split
//   order: deterministic, no atomics, and ata[i, j] and ata[j, i] come
//   from one sum (bit-symmetric). (Summing in the edge's last block instead,
//   behind an integer ticket, measured slower: its serial tail outlasts the
//   second launch.)
// * A cheap contraction. Per tile, kgx = gxx kx + gxy ky and kgy = gxy kx +
//   gyy ky are formed once per row (not once per output), then the padded
//   product out += Kx^T Kgx + Ky^T Kgy is register-tiled: each consumer
//   thread owns (P/8)x(P/8) outputs (rows ti + 8a, columns tj + 8b; 4x4
//   at P = 32, 6x6 at 48) over half of the tile's points, so one 16-byte
//   shared load feeds 8 FMAs, and the [quad][row][4 points] layout keeps
//   the loads free of bank conflicts. At P = 48 the block's shared memory
//   grows from 71 KB to 96 KB; two blocks an SM still fit.
//   Only the upper triangle is summed (every output the caller reads lies
//   there: ata's upper half, atb, err, n_inl); the second pass mirrors ata.
//   The TPU kernel's padding trick gives every output from that one loop:
//   padded kx row dim+1 is ones, padded kgx rows dim, dim+1, dim+2 carry
//   hx, gate^2 sum_l w_l d^2 and gate^2, padded kgy row dim carries hy.
// * Precision: FP32 FFMA. The JAX kernel pins Precision.HIGHEST; TF32
//   tensor cores would break its tolerances, and 3xTF32 buys nothing on a
//   kernel bound by bytes.
// * Tried and measured slower on the H100, so not used here: bringing
//   fgs/f0 in through a shared-memory ring of TMA bulk copies on mbarriers
//   (one copy per 256-byte row), an L2 bulk prefetch of the next tile, 8
//   or 4 producer warps instead of 6, and one or four rows of loads in
//   flight per producer instead of two. See PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#define TN 64                  // points per tile
#define QUADS (TN / 4)         // 4-point groups per tile
#define MAX_LEVELS 8
#define PRODUCERS 192          // 6 warps: fgs/f0, gate -> per-point Gram terms
#define CONSUMERS 128          // 4 warps: K-rows, kgx/kgy, the contraction
#define THREADS (PRODUCERS + CONSUMERS)
#define MIN_BLOCKS 2           // resident blocks per SM the kernel is built for
#define SLICES (PRODUCERS / QUADS)  // (level, channel) slices of a quad
#define GROUPS (CONSUMERS / 64)     // point groups of the contraction
#define NTERMS 7               // gxx gxy gyy hx hy sum_l w_l d^2, all times g^2; g^2
#define COMBINE_THREADS 256

// Named barriers (0 is __syncthreads).
#define BAR_FULL 1       // + b: producers -> consumers, terms[b] written
#define BAR_FREE 3       // + b: consumers -> producers, terms[b] read
#define BAR_CONSUMERS 5  // consumers only
#define BAR_PRODUCERS 6  // producers only

#define HANDOFF (PRODUCERS / 32 * 6 * TN)  // one partial per producer warp, in floats
#define TERMS (NTERMS * TN)

// The padded width P's instantiation: dim + 3 <= P, and its shared memory,
// in floats (every offset a multiple of 4: 16-byte aligned).
template <int P>
struct Pad {
  static_assert(P % 8 == 0 && P * P % COMBINE_THREADS == 0, "P: 8 | P, whole combine blocks");
  static constexpr int MAX_DIM = P - 3;
  static constexpr int R = P / 8;              // a consumer's outputs along each axis
  static constexpr int KTILE = QUADS * P * 4;  // one [quad][row][4 points] array
  static constexpr int STAGE = 2 * KTILE;      // kx, ky of one tile
  static constexpr int OFF_HANDOFF = 2 * STAGE;
  static constexpr int OFF_TERMS = OFF_HANDOFF + 2 * HANDOFF;
  static constexpr int OFF_KG = OFF_TERMS + 2 * TERMS;  // kgx, kgy; at the end the group sums
  static constexpr int OFF_COEF = OFF_KG + 2 * KTILE;
  static constexpr int SMEM_FLOATS = OFF_COEF + MAX_LEVELS * 8;
  static constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
  static_assert(GROUPS * P * P <= 2 * KTILE, "the group sums fit in kgx, kgy");
};

// Per level: w rx^2, w rx ry, w ry^2, w rx | w ry, w, 0, 0.
struct LevelCoef {
  float c[MAX_LEVELS * 8];
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The first point of split s of [0, N): 4-aligned, equal to 4 points.
// photo_reduce.split_ranges on the host cuts the same way.
__device__ __forceinline__ int split_start(int s, int splits, int N) {
  return s == splits ? N : (int)(((long long)s * N / splits) & ~3LL);
}

// Points n .. n+3 of one row (zero from hi on).
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* p, int n, int hi) {
  if (kVec) {
    return n < hi ? __ldcs(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
  v.x = n < hi ? __ldcs(p) : 0.f;
  v.y = n + 1 < hi ? __ldcs(p + 1) : 0.f;
  v.z = n + 2 < hi ? __ldcs(p + 2) : 0.f;
  v.w = n + 3 < hi ? __ldcs(p + 3) : 0.f;
  return v;
}

// Consumers: cp.async of one tile's K-rows (rows < dim), points n0 ..
// n0+TN-1 (zero from hi on), into a ring stage.
template <int P, bool kVec>
__device__ __forceinline__ void load_k_rows(float* stage, const float* __restrict__ kx,
                                            const float* __restrict__ ky, int ct, int e, int n0,
                                            int hi, int N, int dim) {
  using Lay = Pad<P>;
  if (kVec) {
    // 16-byte units: a warp covers 8 rows x 4 quads, so each row reads
    // 64 contiguous bytes and each 8-lane phase writes 8 consecutive units;
    // the warps' chunks walk P/8 row blocks, then 4 quad blocks, then kx | ky.
    for (unsigned u = ct; u < 2u * P * QUADS; u += CONSUMERS) {
      const unsigned w = u >> 5;
      const int row = (u & 7) + 8 * (w % Lay::R);
      const int q = ((u >> 3) & 3) + 4 * ((w / Lay::R) & 3);
      const int arr = w / (4 * Lay::R);
      if (row >= dim) continue;
      const int n = n0 + 4 * q;
      const float* src = (arr ? ky : kx) + ((size_t)e * dim + row) * N + n;
      cp_async16(stage + arr * Lay::KTILE + (q * P + row) * 4, n < hi ? src : kx, n < hi);
    }
  } else {
    for (int u = ct; u < 2 * dim * TN; u += CONSUMERS) {
      const int m = u % TN;
      const int row = (u / TN) % dim;
      const int arr = u / (TN * dim);
      const int n = n0 + m;
      const float* src = (arr ? ky : kx) + ((size_t)e * dim + row) * N + n;
      cp_async4(stage + arr * Lay::KTILE + ((m >> 2) * P + row) * 4 + (m & 3), n < hi ? src : kx,
                n < hi);
    }
  }
}

// Producers: per point of each tile, sum_l w_l (rx^2 gx.gx, rx ry gx.gy,
// ry^2 gy.gy, rx gx.d, ry gy.d, d.d) over (level, channel), one partial per
// warp, then the warps' partials in warp order times gate^2 into
// terms[tile & 1].
template <int P, bool kVec>
__device__ __forceinline__ void produce(const float* __restrict__ fgs,
                                        const float* __restrict__ f0,
                                        const float* __restrict__ gate, float* smem, int e,
                                        int L, int C, int N, int lo, int hi, int n_tiles) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int q = t % QUADS;      // this thread's point quad
  const int slice = t / QUADS;  // and its (level, channel) rows slice, slice + SLICES, ..
  const int K = L * C;
  const int dl = SLICES / C, dc = SLICES % C;  // (level, channel) step of a slice
  using Lay = Pad<P>;
  const float4* coef = reinterpret_cast<const float4*>(smem + Lay::OFF_COEF);
  for (int i = 0; i < n_tiles; ++i) {
    const int b = i & 1;
    const int n0 = lo + i * TN;
    const int n = n0 + 4 * q;
    // this thread's point in the terms step below (t % TN for all of its items)
    const float gv = n0 + t % TN < hi ? __ldg(gate + (size_t)e * N + n0 + t % TN) : 0.f;
    float g[6][4];
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int p = 0; p < 4; ++p) g[j][p] = 0.f;
    int l = slice / C, c = slice % C;
#pragma unroll 2  // two (level, channel) rows of loads in flight
    for (int k = slice; k < K; k += SLICES) {
      const float* fg = fgs + ((size_t)(e * L + l) * 3 * C + c) * N + n;
      const float* fz = f0 + ((size_t)(e * L + l) * C + c) * N + n;
      const float4 v1 = load_quad<kVec>(fg, n, hi);
      const float4 vx = load_quad<kVec>(fg + (size_t)C * N, n, hi);
      const float4 vy = load_quad<kVec>(fg + (size_t)2 * C * N, n, hi);
      const float4 v0 = load_quad<kVec>(fz, n, hi);
      const float4 ca = coef[2 * l];
      const float4 cb = coef[2 * l + 1];
      const float x[4] = {vx.x, vx.y, vx.z, vx.w};
      const float y[4] = {vy.x, vy.y, vy.z, vy.w};
      const float d[4] = {v0.x - v1.x, v0.y - v1.y, v0.z - v1.z, v0.w - v1.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        g[0][p] = fmaf(ca.x, x[p] * x[p], g[0][p]);
        g[1][p] = fmaf(ca.y, x[p] * y[p], g[1][p]);
        g[2][p] = fmaf(ca.z, y[p] * y[p], g[2][p]);
        g[3][p] = fmaf(ca.w, x[p] * d[p], g[3][p]);
        g[4][p] = fmaf(cb.x, y[p] * d[p], g[4][p]);
        g[5][p] = fmaf(cb.y, d[p] * d[p], g[5][p]);
      }
      l += dl;
      c += dc;
      if (c >= C) {
        c -= C;
        ++l;
      }
    }
    // the warp's two slices (lanes l and l+16 share a quad)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int p = 0; p < 4; ++p) g[j][p] += __shfl_xor_sync(0xffffffffu, g[j][p], 16);
    float* part = smem + Lay::OFF_HANDOFF + b * HANDOFF;
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        reinterpret_cast<float4*>(part + (warp * 6 + j) * TN)[q] =
            make_float4(g[j][0], g[j][1], g[j][2], g[j][3]);
      }
    }
    bar_sync(BAR_PRODUCERS, PRODUCERS);  // every warp's partial of this tile
    if (i >= 2) bar_sync(BAR_FREE + b, THREADS);  // consumers are done with terms[b]
    float* terms = smem + Lay::OFF_TERMS + b * TERMS;
    const float g2 = gv * gv;
    for (int u = t; u < NTERMS * TN; u += PRODUCERS) {
      const int term = u / TN;
      const int m = u % TN;
      float sum = 1.f;
      if (term < 6) {
        sum = 0.f;
#pragma unroll
        for (int w = 0; w < PRODUCERS / 32; ++w) sum += part[(w * 6 + term) * TN + m];
      }
      terms[u] = g2 * sum;
    }
    bar_arrive(BAR_FULL + b, THREADS);
  }
}

// Consumers: the padded product of the block's tiles, then the block's
// partial [P, P] (point groups summed in group order).
template <int P, bool kVec>
__device__ __forceinline__ void consume(const float* __restrict__ kx,
                                        const float* __restrict__ ky, float* smem,
                                        float* __restrict__ partial, int e, int split,
                                        int splits, int N, int dim, int lo, int hi,
                                        int n_tiles) {
  using Lay = Pad<P>;
  constexpr int R = Lay::R;
  const int ct = threadIdx.x - PRODUCERS;
  float* s_kgx = smem + Lay::OFF_KG;
  float* s_kgy = s_kgx + Lay::KTILE;
  // output rows ti + 8a, columns tj + 8b, point group grp
  const int grp = ct / 64;
  const int ti = (ct % 64) / 8;
  const int tj = ct % 8;
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.f;

  load_k_rows<P, kVec>(smem, kx, ky, ct, e, lo, hi, N, dim);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int b = i & 1;
    const int n0 = lo + i * TN;
    const float* stage = smem + b * Lay::STAGE;
    if (i + 1 < n_tiles) {
      // the other stage was last read before the previous tile's last barrier
      load_k_rows<P, kVec>(smem + (b ^ 1) * Lay::STAGE, kx, ky, ct, e, n0 + TN, hi, N, dim);
    }
    cp_async_commit();  // possibly empty: this tile's group is then never the newest
    cp_async_wait_prev();
    bar_sync(BAR_FULL + b, THREADS);  // the producers' terms, every consumer's copies

    // padded kgx, kgy rows of this tile
    {
      const float4* terms = reinterpret_cast<const float4*>(smem + Lay::OFF_TERMS + b * TERMS);
      const float4* skx = reinterpret_cast<const float4*>(stage);
      const float4* sky = reinterpret_cast<const float4*>(stage + Lay::KTILE);
      for (int u = ct; u < QUADS * P; u += CONSUMERS) {
        const int row = u % P;
        const int qq = u / P;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 X = zero, Y = zero;
        if (row < dim) {
          const float4 gxx = terms[0 * QUADS + qq], gxy = terms[1 * QUADS + qq],
                       gyy = terms[2 * QUADS + qq];
          const float4 x = skx[u], y = sky[u];
          X = make_float4(fmaf(gxy.x, y.x, gxx.x * x.x), fmaf(gxy.y, y.y, gxx.y * x.y),
                          fmaf(gxy.z, y.z, gxx.z * x.z), fmaf(gxy.w, y.w, gxx.w * x.w));
          Y = make_float4(fmaf(gyy.x, y.x, gxy.x * x.x), fmaf(gyy.y, y.y, gxy.y * x.y),
                          fmaf(gyy.z, y.z, gxy.z * x.z), fmaf(gyy.w, y.w, gxy.w * x.w));
        } else if (row == dim) {
          X = terms[3 * QUADS + qq];
          Y = terms[4 * QUADS + qq];
        } else if (row == dim + 1) {
          X = terms[5 * QUADS + qq];
        } else if (row == dim + 2) {
          X = terms[6 * QUADS + qq];
        }
        reinterpret_cast<float4*>(s_kgx)[u] = X;
        reinterpret_cast<float4*>(s_kgy)[u] = Y;
      }
    }
    if (i + 2 < n_tiles) bar_arrive(BAR_FREE + b, THREADS);  // producers may refill terms[b]
    bar_sync(BAR_CONSUMERS, CONSUMERS);

    // out += Kx^T Kgx + Ky^T Kgy over this group's quads of the tile
    {
      const float4* X4 = reinterpret_cast<const float4*>(stage);
      const float4* Y4 = reinterpret_cast<const float4*>(stage + Lay::KTILE);
      const float4* GX4 = reinterpret_cast<const float4*>(s_kgx);
      const float4* GY4 = reinterpret_cast<const float4*>(s_kgy);
      const int live_quads = min(QUADS, (hi - n0 + 3) / 4);
      for (int qq = grp; qq < live_quads; qq += GROUPS) {
        float4 ax[R], ay[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          ax[a] = X4[qq * P + ti + 8 * a];
          ay[a] = Y4[qq * P + ti + 8 * a];
        }
#pragma unroll
        for (int b2 = 0; b2 < R; ++b2) {
          const float4 bx = GX4[qq * P + tj + 8 * b2];
          const float4 by = GY4[qq * P + tj + 8 * b2];
#pragma unroll
          for (int a = 0; a < R; ++a) {
            // only the upper triangle (row <= column): rows ti + 8a < tj + 8b2
            // when a < b2, never when a > b2
            if (a > b2 || (a == b2 && ti > tj)) continue;
            float s = acc[a][b2];
            s = fmaf(ax[a].x, bx.x, s);
            s = fmaf(ay[a].x, by.x, s);
            s = fmaf(ax[a].y, bx.y, s);
            s = fmaf(ay[a].y, by.y, s);
            s = fmaf(ax[a].z, bx.z, s);
            s = fmaf(ay[a].z, by.z, s);
            s = fmaf(ax[a].w, bx.w, s);
            s = fmaf(ay[a].w, by.w, s);
            acc[a][b2] = s;
          }
        }
      }
    }
    bar_sync(BAR_CONSUMERS, CONSUMERS);
  }

  // the point groups' sums in group order -> this split's partial
  float* red = smem + Lay::OFF_KG;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) red[grp * P * P + (ti + 8 * a) * P + tj + 8 * b] = acc[a][b];
  bar_sync(BAR_CONSUMERS, CONSUMERS);
  float* mine = partial + ((size_t)e * splits + split) * P * P;
  for (int o = ct; o < P * P; o += CONSUMERS) {
    float sum = red[o];
#pragma unroll
    for (int g = 1; g < GROUPS; ++g) sum += red[g * P * P + o];
    mine[o] = sum;
  }
}

// Per block: the padded PxP product of one point range of edge
// blockIdx.y, written to partial[e, split].
template <int P, bool kVec>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) photo_reduce_split(
    const float* __restrict__ fgs, const float* __restrict__ f0,
    const float* __restrict__ gate, const float* __restrict__ kx,
    const float* __restrict__ ky, float* __restrict__ partial, int L, int C, int N,
    int dim, LevelCoef coef) {
  using Lay = Pad<P>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int e = blockIdx.y;
  const int lo = split_start(split, splits, N);
  const int hi = split_start(split + 1, splits, N);
  const int n_tiles = (hi - lo + TN - 1) / TN;

  if (t < L * 8) smem[Lay::OFF_COEF + t] = coef.c[t];
  // padded K-rows of both stages: row dim+1 of kx is ones, the rest zero
  for (int u = t; u < 2 * 2 * QUADS * P; u += THREADS) {
    const int row = u % P;
    if (row < dim) continue;
    const int q = (u / P) % QUADS;
    const int arr = (u / (P * QUADS)) & 1;
    const int st = u / (2 * P * QUADS);
    const float v = (arr == 0 && row == dim + 1) ? 1.f : 0.f;
    reinterpret_cast<float4*>(smem + st * Lay::STAGE + arr * Lay::KTILE)[q * P + row] =
        make_float4(v, v, v, v);
  }
  __syncthreads();
  if (t < PRODUCERS) {
    produce<P, kVec>(fgs, f0, gate, smem, e, L, C, N, lo, hi, n_tiles);
  } else {
    consume<P, kVec>(kx, ky, smem, partial, e, split, splits, N, dim, lo, hi, n_tiles);
  }
}

// Per (edge, P*P/256-th of the outputs): the splits' partials summed in
// split order, 8 loads in flight. The lower triangle of ata is read from
// the upper partials, so ata is bit-symmetric.
template <int P>
__global__ void __launch_bounds__(COMBINE_THREADS) photo_reduce_combine(
    const float* __restrict__ partial, float* __restrict__ out, int splits, int dim) {
  const int e = blockIdx.y;
  const int o = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  const int r = o / P;
  const int c = o % P;
  const float* p = partial + (size_t)e * splits * P * P + ((r > c && r < dim) ? c * P + r : o);
  float sum = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = s0 + k < splits ? p[(size_t)(s0 + k) * P * P] : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (s0 + k < splits) sum += v[k];
    }
  }
  out[(size_t)e * P * P + o] = sum;
}

extern "C" const char* photo_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <int P>
static int slots_for(void) {
  const int bytes = Pad<P>::SMEM_BYTES;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st == cudaSuccess) st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess) {
    st = cudaFuncSetAttribute(photo_reduce_split<P, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (st == cudaSuccess) {
    st = cudaFuncSetAttribute(photo_reduce_split<P, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (st == cudaSuccess) {
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, photo_reduce_split<P, true>,
                                                       THREADS, bytes);
  }
  if (st != cudaSuccess) return -static_cast<int>(st);
  return per_sm * sms;
}

// Sets the pad-wide kernels' shared-memory limit on the current device and
// returns their resident block slots (blocks per SM x SMs), or a negative
// CUDA error code. Call once per device and pad before photo_reduce_launch.
extern "C" int photo_reduce_slots(int pad) {
  if (pad == 32) return slots_for<32>();
  if (pad == 48) return slots_for<48>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <int P>
static int launch(const float* fgs, const float* f0, const float* gate, const float* kx,
                  const float* ky, float* partial, float* out, int E, int L, int C, int N,
                  int dim, int splits, const LevelCoef& coef, bool vec, cudaStream_t s) {
  if (dim > Pad<P>::MAX_DIM) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Pad<P>::SMEM_BYTES;
  const dim3 grid(splits, E);
  if (vec) {
    photo_reduce_split<P, true><<<grid, THREADS, bytes, s>>>(fgs, f0, gate, kx, ky, partial, L,
                                                             C, N, dim, coef);
  } else {
    photo_reduce_split<P, false><<<grid, THREADS, bytes, s>>>(fgs, f0, gate, kx, ky, partial, L,
                                                              C, N, dim, coef);
  }
  cudaError_t st = cudaGetLastError();
  if (st != cudaSuccess) return static_cast<int>(st);
  photo_reduce_combine<P><<<dim3(P * P / COMBINE_THREADS, E), COMBINE_THREADS, 0, s>>>(
      partial, out, splits, dim);
  return static_cast<int>(cudaGetLastError());
}

// pad: the instantiation, 32 or 48, with dim + 3 <= pad. host_params: L
// weights, then L x-ratios, then L y-ratios (host memory). partial:
// [E, splits, pad, pad] scratch; out: [E, pad, pad]; splits <= N / 64 (or
// 1). Returns cudaGetLastError() after the launches (0 on success).
extern "C" int photo_reduce_launch(const float* fgs, const float* f0, const float* gate,
                                   const float* kx, const float* ky, float* partial, float* out,
                                   int E, int L, int C, int N, int dim, int pad, int splits,
                                   const float* host_params, void* stream) {
  if (E < 1 || E > 65535 || L < 1 || L > MAX_LEVELS || C < 1 || N < 1 || dim < 1 ||
      splits < 1 || (splits > 1 && splits > N / TN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelCoef coef = {};
  for (int l = 0; l < L; ++l) {
    const float w = host_params[l], rx = host_params[L + l], ry = host_params[2 * L + l];
    float* c = coef.c + l * 8;
    c[0] = w * rx * rx;
    c[1] = w * rx * ry;
    c[2] = w * ry * ry;
    c[3] = w * rx;
    c[4] = w * ry;
    c[5] = w;
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(fgs) | reinterpret_cast<uintptr_t>(f0) |
                          reinterpret_cast<uintptr_t>(gate) | reinterpret_cast<uintptr_t>(kx) |
                          reinterpret_cast<uintptr_t>(ky);
  const bool vec = N % 4 == 0 && (align & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pad == 32) {
    return launch<32>(fgs, f0, gate, kx, ky, partial, out, E, L, C, N, dim, splits, coef, vec, s);
  }
  if (pad == 48) {
    return launch<48>(fgs, f0, gate, kx, ky, partial, out, E, L, C, N, dim, splits, coef, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
