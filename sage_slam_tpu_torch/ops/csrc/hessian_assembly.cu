// The Hessian assembly for Hopper (sm_90a): every edge's S x S block and S
// vector added into the dense system H [D, D] and b [D], in place, by output
// tiles, in a fixed order and without atomics. FP32 only.
//
// Replaces no TPU kernel. The JAX package assembles with one-hot matmuls
// (sage_slam_tpu/solver/graph.py scatter_hessian), which the TPU's matrix
// unit runs; the port kept them as its plain version
// (solver/graph.scatter_hessian_ref): P^T (A P) with a one-hot P [E*S, D],
// 2 D^2 E S FLOPs to place E S^2 entries. At the 64-keyframe full-graph
// problem with a 32-dim code (D = 2,496, E = 372, S = 78 and 45) that was
// 5.7e11 FLOPs and 14.5 ms an LM iteration on an H100, and the cost grows
// as D^2.
//
// Bound: memory, and a small one. The work is to read each valid edge's
// indices, block and vector once, and to read and write once each tile of
// H that an edge touches: 8.8 MB for the five calls of an LM iteration at
// CS = 16 and 24.4 MB at CS = 32, 2.6 and 7.3 us at 3.35 TB/s
// (chip_smoke.assembly_bound). The arithmetic is an add an entry. What the
// kernel has to keep short is the chain of dependent steps: an output tile
// takes its edges one after the other.
//
// The design:
// * Tiles. H is cut into T x T tiles, T from the caller's keyframe block
//   width (the block itself, or as many whole blocks as fit in 32 for
//   narrow ones; at most kMaxTile), so an edge between two keyframes
//   touches 2 x 2 tiles and a prior one.
// * Launch 1, assembly_plan: a CTA per word of 32 edges writes, for every
//   tile row a, the mask of those edges with a slot in it (rows[a][w]). An
//   edge whose valid is 0, and a slot whose index lies outside [0, D),
//   touch nothing. The 32 edges' slots are staged in shared memory, and one
//   warp walks them slot by slot, merging the lanes that share a tile row
//   with __match_any_sync: each mask word is written by one thread, with no
//   atomics.
// * Launch 2, assembly_tiles: a CTA per output tile (a, c), nT^2 of them.
//   The tile's edges are the bits of rows[a] & rows[c]; an empty mask ends
//   the CTA before H is read, so a tile no edge touches is neither read nor
//   written, and the block scheduler hands the SM to the next tile at once.
//   The CTA reads its tile into shared memory and walks the tile's edges in
//   ascending order. For each it maps the edge's slots onto the tile's rows
//   and columns with chained inverse tables in shared memory (each row's
//   first slot, then the next slot of the same row), built by two warps 32
//   slots at a time with __match_any_sync, so slots of one edge that repeat
//   a global index are all summed, as the one-hot product sums them. Each
//   thread then adds valid^2 times its entries' sums of the block; a
//   diagonal tile also adds valid times the vector's sums into b, for its
//   rows. The next edge's indices are loaded while the current one is
//   summed. Last, the tile is written back. A tile's edges one after the
//   other are the kernel's critical path: a diagonal tile of the cells'
//   maps takes a dozen.
// * Determinism. Every entry of H and b is owned by one thread of one CTA,
//   and its sum runs in a fixed order: the entry's value, then the edges in
//   ascending order, within an edge the slot pairs in a fixed order. Two
//   calls on the same inputs give bitwise-equal H and b.
// * Symmetry. Within an edge the pairs are walked with the chain of the
//   smaller global index outside (the row chain when i <= j, else the
//   column chain), so entries (i, j) and (j, i) add the same values in the
//   same order whenever each block is bitwise symmetric, as psd_correct
//   makes it: H then comes out exactly symmetric if it went in so. A block
//   that is not symmetric is still added entry by entry as it is.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;
constexpr int kPlanSlots = 64;                // slots of 32 edges staged at a time by the plan
constexpr int kPlanStride = kPlanSlots + 1;   // a lane's staged row, padded off the banks
constexpr int kPrefetch = 2;                  // slots a thread loads ahead for the next edge (S <= 512)
constexpr int kSmallSmem = 48 * 1024;         // dynamic shared memory without the opt-in

__global__ void __launch_bounds__(kThreads) assembly_plan(
    const long long* __restrict__ gidx, long long g_e, long long g_s,
    const float* __restrict__ valid, long long v_e, int E, int S, long long D, int T, int nT,
    int W, unsigned* __restrict__ rows) {
  extern __shared__ int plan_smem[];
  unsigned* word = reinterpret_cast<unsigned*>(plan_smem);  // [nT] this word's mask of each tile row
  int* trow = plan_smem + nT;                                // [32][kPlanStride] tile row of a slot
  const int w = blockIdx.x;
  for (int a = threadIdx.x; a < nT; a += kThreads) word[a] = 0u;
  for (int s0 = 0; s0 < S; s0 += kPlanSlots) {
    const int ns = min(kPlanSlots, S - s0);
    __syncthreads();  // the masks zeroed, or the last chunk walked
    for (int k = threadIdx.x; k < 32 * ns; k += kThreads) {
      const int lane = k / ns, s = k - lane * ns;
      const int e = w * 32 + lane;
      int a = -1;
      if (e < E && valid[e * v_e] != 0.0f) {
        const long long g = gidx[e * g_e + (s0 + s) * g_s];
        if (g >= 0 && g < D) a = static_cast<int>(g / T);
      }
      trow[lane * kPlanStride + s] = a;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int s = 0; s < ns; ++s) {
        const int a = trow[lane * kPlanStride + s];
        const unsigned same = __match_any_sync(0xffffffffu, a);
        if (a >= 0 && lane == __ffs(same) - 1) word[a] |= same;  // one writer per tile row
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < nT; a += kThreads) rows[static_cast<long long>(a) * W + w] = word[a];
}

// The first edge of the mask after edge e (-1 for the first), or -1.
__device__ int next_edge(const unsigned* mask, int W, int e) {
  int w = (e + 1) >> 5;
  if (w >= W) return -1;
  unsigned m = mask[w] & (~0u << ((e + 1) & 31));
  while (m == 0u) {
    if (++w >= W) return -1;
    m = mask[w];
  }
  return (w << 5) + __ffs(m) - 1;
}

__global__ void __launch_bounds__(kThreads) assembly_tiles(
    float* __restrict__ H, float* __restrict__ bvec, const long long* __restrict__ gidx,
    long long g_e, long long g_s, const float* __restrict__ ata, long long a_e, long long a_s,
    long long a_t, const float* __restrict__ atb, long long b_e, long long b_s,
    const float* __restrict__ valid, long long v_e, const unsigned* __restrict__ rows, int S,
    long long D, int T, int nT, int W) {
  extern __shared__ int tile_smem[];
  unsigned* mask = reinterpret_cast<unsigned*>(tile_smem);  // [W] the tile's edges
  int* lr = tile_smem + W;  // [S] the slot's row in the tile, or -1
  int* lc = lr + S;         // [S] the slot's column in the tile, or -1
  int* rnext = lc + S;      // [S] the next slot of the same row, or -1
  int* cnext = rnext + S;   // [S] the next slot of the same column, or -1
  int* rhead = cnext + S;   // [T] each row's first slot, or -1
  int* chead = rhead + T;   // [T] each column's first slot, or -1
  int* rtail = chead + T;   // [T] each row's last slot so far
  int* ctail = rtail + T;   // [T]
  float* acc = reinterpret_cast<float*>(ctail + T);  // [T * T] the tile's sums, one owner each
  const int tid = threadIdx.x, lane = tid & 31;
  const int ta = static_cast<int>(blockIdx.x / nT), tc = static_cast<int>(blockIdx.x % nT);
  int any = 0;
  for (int w = tid; w < W; w += kThreads) {
    const unsigned m = rows[static_cast<long long>(ta) * W + w] & rows[static_cast<long long>(tc) * W + w];
    mask[w] = m;
    any |= m != 0u;
  }
  if (!__syncthreads_or(any)) return;  // no edge touches the tile: H is not read
  const long long r0 = static_cast<long long>(ta) * T, c0 = static_cast<long long>(tc) * T;
  const int nr = static_cast<int>(D - r0 < T ? D - r0 : T);  // the last tiles are ragged
  const int nc = static_cast<int>(D - c0 < T ? D - c0 : T);
  const bool diag = ta == tc;
  const int tt = nr * nc;
  for (int k = tid; k < tt; k += kThreads) acc[k] = H[(r0 + k / nc) * D + c0 + k % nc];
  float bacc = (diag && tid < nr) ? bvec[r0 + tid] : 0.0f;
  // this thread's slots of the next edge, loaded while the current one is summed
  long long pre[kPrefetch];
  auto fetch = [&](int e) {
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const int s = tid + r * kThreads;
      pre[r] = (e >= 0 && s < S) ? gidx[e * g_e + s * g_s] : -1;
    }
  };
  auto place = [&](int s, long long g) {
    lr[s] = (g >= r0 && g < r0 + nr) ? static_cast<int>(g - r0) : -1;
    lc[s] = (g >= c0 && g < c0 + nc) ? static_cast<int>(g - c0) : -1;
  };
  int e = next_edge(mask, W, -1);  // the same in every thread: the loop and its barriers are uniform
  fetch(e);
  while (e >= 0) {
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const int s = tid + r * kThreads;
      if (s < S) place(s, pre[r]);
    }
    for (int s = tid + kPrefetch * kThreads; s < S; s += kThreads) place(s, gidx[e * g_e + s * g_s]);
    __syncthreads();
    const int e_next = next_edge(mask, W, e);
    fetch(e_next);
    if (tid < 64) {  // warp 0 chains the rows, warp 1 the columns, 32 slots at a time
      const bool col = tid >= 32;
      const int* loc = col ? lc : lr;
      int* next = col ? cnext : rnext;
      int* head = col ? chead : rhead;
      int* tail = col ? ctail : rtail;
      for (int i = lane; i < T; i += 32) head[i] = -1;
      __syncwarp();
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        const int r = s < S ? loc[s] : -1;
        const unsigned same = __match_any_sync(0xffffffffu, r);
        const unsigned above = same & ~((2u << lane) - 1u);  // later lanes of the same row
        if (r >= 0) {
          next[s] = above ? s0 + __ffs(above) - 1 : -1;
          if ((same & ((1u << lane) - 1u)) == 0u) {  // the row's first slot in this chunk
            if (head[r] < 0) head[r] = s; else next[tail[r]] = s;
          }
        }
        __syncwarp();
        if (r >= 0 && above == 0u) tail[r] = s;
        __syncwarp();
      }
    }
    __syncthreads();
    const float v = valid[e * v_e];
    const float v2 = v * v;
    const float* blk = ata + e * a_e;
    for (int k = tid; k < tt; k += kThreads) {
      const int i = k / nc, j = k - i * nc;
      const int sr = rhead[i], sc = chead[j];
      if (sr >= 0 && sc >= 0) {
        float sum = 0.0f;
        if (r0 + i <= c0 + j) {
          for (int s = sr; s >= 0; s = rnext[s])
            for (int t = sc; t >= 0; t = cnext[t]) sum += blk[s * a_s + t * a_t];
        } else {
          for (int t = sc; t >= 0; t = cnext[t])
            for (int s = sr; s >= 0; s = rnext[s]) sum += blk[s * a_s + t * a_t];
        }
        acc[k] += v2 * sum;
      }
    }
    if (diag && tid < nr) {
      const int sr = rhead[tid];
      if (sr >= 0) {
        float sum = 0.0f;
        for (int s = sr; s >= 0; s = rnext[s]) sum += atb[e * b_e + s * b_s];
        bacc += v * sum;
      }
    }
    __syncthreads();  // the tables are rewritten for the next edge
    e = e_next;
  }
  for (int k = tid; k < tt; k += kThreads) H[(r0 + k / nc) * D + c0 + k % nc] = acc[k];
  if (diag && tid < nr) bvec[r0 + tid] = bacc;
}

cudaError_t allow_smem(const void* fn, long long bytes) {
  if (bytes <= kSmallSmem) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// The shared memory the two launches need, in bytes: [plan, tiles].
void smem_bytes(int E, int S, long long D, int T, long long* out) {
  const long long nT = (D + T - 1) / T, W = (E + 31) / 32;
  out[0] = (nT + 32LL * kPlanStride) * 4;
  out[1] = (W + 4LL * S + 4LL * T + 1LL * T * T) * 4;
}

}  // namespace

extern "C" const char* assembly_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One assembly on the current device's stream: H [D, D] and b [D]
// (contiguous) updated in place from E edges of S slots: gidx (int64), ata,
// atb and valid (float32) read through their element strides; rows is
// scratch of ceil(D / T) * ceil(E / 32) words. The wrapper
// (solver/graph.py) checks every shape, dtype, device and limit first.
// Returns 0 or a CUDA error code.
extern "C" int assembly_launch(float* H, float* b, const long long* gidx, long long g_e,
                               long long g_s, const float* ata, long long a_e, long long a_s,
                               long long a_t, const float* atb, long long b_e, long long b_s,
                               const float* valid, long long v_e, unsigned* rows, int E, int S,
                               long long D, int T, void* stream) {
  const long long nT = (D + T - 1) / T;
  if (E < 1 || S < 1 || D < 1 || T < 1 || T > kMaxTile || nT * nT > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (E + 31) / 32;
  long long smem[2];
  smem_bytes(E, S, D, T, smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(assembly_plan), smem[0]);
  if (err == cudaSuccess) err = allow_smem(reinterpret_cast<const void*>(assembly_tiles), smem[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  assembly_plan<<<W, kThreads, smem[0], st>>>(gidx, g_e, g_s, valid, v_e, E, S, D, T,
                                             static_cast<int>(nT), W, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  assembly_tiles<<<static_cast<unsigned>(nT * nT), kThreads, smem[1], st>>>(
      H, b, gidx, g_e, g_s, ata, a_e, a_s, a_t, atb, b_e, b_s, valid, v_e, rows, S, D, T,
      static_cast<int>(nT), W);
  return static_cast<int>(cudaGetLastError());
}
