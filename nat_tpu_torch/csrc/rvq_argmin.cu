// Residual-VQ chain for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces nat_tpu/ops/rvq_pallas.py::_rvq_kernel in both of its modes.
// K1, argmin: for each of N layers and each row r of the residual, it picks
//     idx = argmin_k  (|r|^2 - 2 r.c_k) + |c_k|^2          (IEEE fp32, FMA)
// with the lowest index winning ties, then updates r -= c[idx] and
// qsum += c[idx] and writes err = |r|^2 after the update.
// K2, stochastic (rvq_pallas.py:73-89): the same chain, but the code is the
// Gumbel-max sample
//     idx = argmin_k  sqrt(max(d_k, 0)) / tau - g(seed, layer, row, k)
// where g = -log(-log(u)) and u comes from a counter-based Philox4x32-10
// keyed by (seed, layer, row, code).  The TPU seeds its on-chip generator
// per (tile, layer, chunk); a counter-based draw instead gives every
// (row, code) its own number whatever the tiling, so the plain version can
// be fed the same uniforms (rvq_philox_uniforms) and agree code for code.
//
// What bounds it on an H100: at the main path's shapes (N=4, K=4096, D=512,
// M=81 rows per span) one call reads 33.5 MB of codebook and does
// 2*M*N*K*D = 1.36 GFLOP of fp32 FMA work.  At 67 TFLOP/s (fp32, no tensor
// cores) and 3.35 TB/s that is ~20 us of arithmetic against ~10 us of
// memory: fp32 operations bound it.  Tensor cores are not used on purpose:
// TF32 or bf16 products flip argmins (rvq_pallas.py:67-70).
//
// Design: one persistent cooperative launch per call.  Phases, separated by
// grid barriers: init (|x|^2, keys reset), then per layer a distance phase
// and an update phase.  In the distance phase the blocks walk (row tile x
// 32-code chunk) items; a block computes the tile's dot products, reduces
// them to a per-row chunk argmin and merges it into a 64-bit key per row
// with atomicMin.  The key is
//     (order-preserving bits of the score << 32) | code index,
// so the merge is deterministic and the lowest index wins ties whatever
// order the blocks finish in.  In the update phase one warp per row gathers
// c[idx], updates residual and qsum, writes code, err and |r|^2, and resets
// the key.  What this does about the previous design's five costs:
//  1. ten dependent launches per call -> one launch and 2N grid barriers.
//     The grid is one block per item (and at least a warp per row), capped
//     at what the SMs hold at once: idle blocks only make the barriers
//     slower;
//  2. a separate pass over the codebook for |c|^2 -> |c|^2 is summed from
//     the codebook slices the block already stages, as the TPU kernel does
//     per chunk (rvq_pallas.py:66);
//  3. one block per SM and a serial, unprefetched loop over D -> slices of
//     32 depths stream through a ring of 4 shared-memory stages filled by
//     16-byte cp.async copies, so the next slices load while the FMAs
//     run on this one, and four warp groups split each slice's depth (12
//     warps on an SM at M=81, where a single group left the FMA pipes
//     waiting on shared-memory latency);
//  4. 64-row tiles that padded 81 rows to 128 -> the row tile is sized to M
//     on the host (a multiple of 32 up to 96: 81 and 88 -> 96);
//  5. a 4x4 register tile (2 FMAs per shared load) -> 8 rows x 4 codes a
//     thread: 8 + 4 float4 loads for 128 FMAs.
// K2's Gumbel noise for an item is drawn into shared memory while its first
// slices load, so the sampling epilogue adds no Philox rounds to the
// registers of the main loop.  What bounds it now (PERF.md): per layer a
// chain of dependent memory round trips and two barriers (~9 us at M=81),
// and the main loop's shared-memory traffic, 12 floats a thread for each
// 32 FMAs.
// The launch plan (row tile, shared memory, grid) is chosen by the caller
// (nat_tpu_torch/ops/rvq_kernel.py::launch_plan) from the SM count and
// rvq_blocks_per_sm, and checked here.  The arithmetic does not depend on
// the plan: the dot products and |c|^2 are summed in the same order at
// every row tile, so a row gets the same code whatever M its call has.
// No fallback: a refused cooperative launch returns its error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 32;      // codes per item
constexpr int kSlice = 32;      // depth per pipeline stage
constexpr int kStages = 4;      // slices in flight
constexpr int kLd = kSlice + 4; // padded row of a stage: conflict-free float4
constexpr int kRowTileMax = 96;   // 384 threads: up to 168 registers each
constexpr int kSplit = 4;      // warp groups that split a slice's depth
constexpr int kGroupChunks = kSlice / 4 / kSplit;  // float4 depths a group
constexpr int kMaxThreads = kSplit * kRowTileMax;
constexpr int kCsqParts = 4;   // partial sums of |c|^2, at every row tile
constexpr int kGumbelLd = kChunk + 1;  // K2's noise table, padded row
constexpr unsigned long long kNoKey = ~0ull;
// An item's partial dot products reuse the ring (rows 32 to 96).
static_assert(kSplit * 8 * 4 * 32 <= kStages * (32 + kChunk) * kLd, "");
static_assert(kSplit * 8 * 4 * kRowTileMax <=
              kStages * (kRowTileMax + kChunk) * kLd, "");

struct ChainParams {
  const float* x;            // [M, D]
  const float* codebook;     // [N, K, D]
  float* residual;           // [M, D] workspace
  float* rsq;                // [M] workspace: |r|^2 of the current residual
  unsigned long long* keys;  // [M] workspace
  int* codes;                // [N, M]
  float* err;                // [N, M]
  float* qsum;               // [M, D]
  int M, N, K, D;
  int row_tile;              // rows per item, a multiple of 32, <= 96
  int row_tiles;             // ceil(M / row_tile)
  int code_chunks;           // ceil(K / kChunk)
  int vec;                   // 16-byte copies: D % 4 == 0, aligned pointers
  float temperature;
  unsigned int seed_lo, seed_hi;
};

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Philox4x32-10 (Salmon et al., SC'11), first output word.
__device__ __forceinline__ unsigned int philox_first(unsigned int c0,
                                                     unsigned int c1,
                                                     unsigned int c2,
                                                     unsigned int c3,
                                                     unsigned int k0,
                                                     unsigned int k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned int hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// Uniform in [0, 1) from the top 23 bits of the draw for (layer, row, code):
// counter (code, row, layer, 0), key (seed low, seed high).
__device__ __forceinline__ float philox_uniform(unsigned int seed_lo,
                                                unsigned int seed_hi,
                                                int layer, int row, int code) {
  const unsigned int bits = philox_first((unsigned int)code, (unsigned int)row,
                                         (unsigned int)layer, 0u, seed_lo,
                                         seed_hi);
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Stage one depth slice [d0, d0 + kSlice) of the item's row tile (rows
// 0..row_tile-1 of the stage) and code chunk (the kChunk rows after them).
// Anything past M, K or D is zero.  The residual is written inside the
// launch, so it is read through L2 only (cp.async.cg, __ldcg).
__device__ __forceinline__ void load_slice(const ChainParams& p, float* dst,
                                           const float* a_src,
                                           const float* cb, int m0, int k0,
                                           int d0) {
  const int rows = p.row_tile + kChunk;
  if (p.vec) {
    for (int e = threadIdx.x; e < rows * (kSlice / 4); e += blockDim.x) {
      const int r = e / (kSlice / 4), c = (e % (kSlice / 4)) * 4;
      const int d = d0 + c;
      const float* src = a_src;
      bool ok;
      if (r < p.row_tile) {
        ok = m0 + r < p.M && d < p.D;
        if (ok) src = a_src + (size_t)(m0 + r) * p.D + d;
      } else {
        ok = k0 + r - p.row_tile < p.K && d < p.D;
        if (ok) src = cb + (size_t)(k0 + r - p.row_tile) * p.D + d;
      }
      cp_async16(dst + r * kLd + c, src, ok ? 16 : 0);
    }
  } else {
    // A depth that is not a multiple of 4, or an unaligned pointer: plain
    // loads, one float a thread.
    for (int e = threadIdx.x; e < rows * kSlice; e += blockDim.x) {
      const int r = e / kSlice, c = e % kSlice;
      const int d = d0 + c;
      float v = 0.f;
      if (r < p.row_tile) {
        if (m0 + r < p.M && d < p.D)
          v = __ldcg(a_src + (size_t)(m0 + r) * p.D + d);
      } else if (k0 + r - p.row_tile < p.K && d < p.D) {
        v = cb[(size_t)(k0 + r - p.row_tile) * p.D + d];
      }
      dst[r * kLd + c] = v;
    }
  }
}

// One item: the scores of rows [m0, m0 + row_tile) against codes
// [k0, k0 + kChunk), reduced to a per-row key and merged into keys[].
//
// Threads: kSplit x row_tile.  Thread t belongs to depth group
// g = t / row_tile, which takes depth chunks 2g and 2g + 1 (4 floats each)
// of every slice; within the group, tx = t % 8 owns codes tx + 8j (j < 4)
// and ty = (t % row_tile) / 8 owns rows ty + TY*i (i < 8, TY = row_tile / 8).
// A warp is 4 ty x 8 tx: its float4 loads hit 4 (rows) or 8 (codes)
// distinct addresses, in distinct banks with the padded stride kLd.
template <bool kStochastic>
__device__ __forceinline__ void distance_item(const ChainParams& p,
                                              float* smem,
                                              const float* a_src,
                                              const float* cb, int layer,
                                              int m0, int k0) {
  const int tile = p.row_tile, ty_count = tile / 8;
  const int t = threadIdx.x;
  const int group = t / tile, gt = t % tile;
  const int ty = gt / 8, tx = gt % 8;
  const int stage_floats = (tile + kChunk) * kLd;
  float* csq_part = smem + kStages * stage_floats;   // [kCsqParts][kChunk]
  float* gumbel = csq_part + kCsqParts * kChunk;     // [tile][kGumbelLd]
  const int cs_code = t % kChunk, cs_part = t / kChunk;
  const int slices = (p.D + kSlice - 1) / kSlice;

  __syncthreads();  // the previous item's readers of shared memory are done

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float cs = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices)
      load_slice(p, smem + s * stage_floats, a_src, cb, m0, k0, s * kSlice);
    cp_async_commit();
  }
  if constexpr (kStochastic) {
    // K2's Gumbel noise for the item, drawn while the first slices load:
    // g = -log(-log(u)), u clipped to [1e-7, 1 - 1e-7] as in the plain
    // version.
    for (int e = t; e < tile * kChunk; e += blockDim.x) {
      const int r = e / kChunk, c = e % kChunk;
      float g = 0.f;
      if (m0 + r < p.M && k0 + c < p.K) {
        float u = philox_uniform(p.seed_lo, p.seed_hi, layer, m0 + r, k0 + c);
        u = fminf(fmaxf(u, 1e-7f), 1.f - 1e-7f);
        g = -logf(-logf(u));
      }
      gumbel[r * kGumbelLd + c] = g;
    }
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // Refill the stage the whole block finished with in step s - 1.
    const int next = s + kStages - 1;
    if (next < slices)
      load_slice(p, smem + (next % kStages) * stage_floats, a_src, cb, m0,
                 k0, next * kSlice);
    cp_async_commit();

    const float* as = smem + (s % kStages) * stage_floats;
    const float* bs = as + tile * kLd;
#pragma unroll
    for (int q = 0; q < kGroupChunks; ++q) {
      const int d = (group * kGroupChunks + q) * 4;
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + ty_count * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + (tx + 8 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fmaf_rn(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].w, b[j].w, acc[i][j]);
        }
    }
    // |c|^2 of the chunk from the same slice: thread t < 128 sums code
    // t % 32 over depth chunks t / 32 and t / 32 + 4, whatever the tile.
    // Rolled: K2 has no registers to spare for a second float4.
    if (cs_part < kCsqParts) {
#pragma unroll 1
      for (int q = cs_part; q < kSlice / 4; q += kCsqParts) {
        const float4 v = *reinterpret_cast<const float4*>(bs + cs_code * kLd + 4 * q);
        cs = __fmaf_rn(v.x, v.x, cs);
        cs = __fmaf_rn(v.y, v.y, cs);
        cs = __fmaf_rn(v.z, v.z, cs);
        cs = __fmaf_rn(v.w, v.w, cs);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to gather partial sums

  // Every group writes its partial sums of all 8 rows; group g then
  // finishes rows 2g and 2g + 1 as ((p0 + p1) + p2) + p3 over the groups,
  // the same order whichever group sums.
  float4* part = reinterpret_cast<float4*>(smem);    // [kSplit][8][tile]
  if (cs_part < kCsqParts) csq_part[cs_part * kChunk + cs_code] = cs;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    part[(group * 8 + i) * tile + gt] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  float csq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float c = 0.f;
#pragma unroll
    for (int q = 0; q < kCsqParts; ++q) c += csq_part[q * kChunk + tx + 8 * j];
    csq[j] = c;
  }
  // Rolled: the partial sums come from shared memory.
#pragma unroll 1
  for (int k = 0; k < 8 / kSplit; ++k) {
    const int i = group * (8 / kSplit) + k;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < kSplit; ++h) {
      const float4 o = part[(h * 8 + i) * tile + gt];
      if (h == 0) {
        dot[0] = o.x; dot[1] = o.y; dot[2] = o.z; dot[3] = o.w;
      } else {
        dot[0] = __fadd_rn(dot[0], o.x);
        dot[1] = __fadd_rn(dot[1], o.y);
        dot[2] = __fadd_rn(dot[2], o.z);
        dot[3] = __fadd_rn(dot[3], o.w);
      }
    }
    const int gm = m0 + ty + ty_count * i;
    unsigned long long best = kNoKey;
    if (gm < p.M) {
      const float rs = __ldcg(p.rsq + gm);
      float score[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        // Same rounding as the reference: (|r|^2 - 2 r.c) + |c|^2; the
        // product by 2 is exact, so the fma rounds once like a subtract.
        score[j] = __fadd_rn(__fmaf_rn(-2.f, dot[j], rs), csq[j]);
      if constexpr (kStochastic) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = k0 + tx + 8 * j;
          // sqrt(max(d, 0)) / tau - g, in the plain version's order.
          const float sample = __fsub_rn(
              __fdiv_rn(__fsqrt_rn(fmaxf(score[j], 0.f)), p.temperature),
              gumbel[(ty + ty_count * i) * kGumbelLd + tx + 8 * j]);
          const unsigned long long key =
              ((unsigned long long)ordered_bits(sample) << 32) | (unsigned int)gk;
          if (gk < p.K) best = key < best ? key : best;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = k0 + tx + 8 * j;
          const unsigned long long key =
              ((unsigned long long)ordered_bits(score[j]) << 32) | (unsigned int)gk;
          if (gk < p.K) best = key < best ? key : best;
        }
      }
    }
    // The 8 lanes sharing ty hold the row's 32 candidates.
    for (int off = 4; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other < best ? other : best;
    }
    if (tx == 0 && best != kNoKey) atomicMin(p.keys + gm, best);
  }
}

// Gather the winner of layer n for each row, update residual and qsum,
// write code, err and |r|^2, reset the key.  One warp per row.
__device__ __forceinline__ void update_rows(const ChainParams& p,
                                            const float* cb, int n) {
  const int warps = gridDim.x * (blockDim.x / 32);
  const int lane = threadIdx.x % 32;
  const float* r_in = n == 0 ? p.x : p.residual;
  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       row < p.M; row += warps) {
    const unsigned long long key = __ldcg(p.keys + row);
    int idx = (int)(key & 0xffffffffull);
    if (key == kNoKey || idx >= p.K) idx = 0;  // unreachable for finite inputs
    const size_t base = (size_t)row * p.D;
    const float* c = cb + (size_t)idx * p.D;
    float s = 0.f;
    if (p.vec) {
      for (int d = 4 * lane; d < p.D; d += 128) {
        const float4 cv = *reinterpret_cast<const float4*>(c + d);
        float4 rv = __ldcg(reinterpret_cast<const float4*>(r_in + base + d));
        float4 qv = n == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : __ldcg(reinterpret_cast<const float4*>(p.qsum + base + d));
        rv.x -= cv.x; rv.y -= cv.y; rv.z -= cv.z; rv.w -= cv.w;
        qv.x += cv.x; qv.y += cv.y; qv.z += cv.z; qv.w += cv.w;
        __stcg(reinterpret_cast<float4*>(p.residual + base + d), rv);
        __stcg(reinterpret_cast<float4*>(p.qsum + base + d), qv);
        s = __fmaf_rn(rv.x, rv.x, s);
        s = __fmaf_rn(rv.y, rv.y, s);
        s = __fmaf_rn(rv.z, rv.z, s);
        s = __fmaf_rn(rv.w, rv.w, s);
      }
    } else {
      for (int d = lane; d < p.D; d += 32) {
        const float cv = c[d];
        const float rv = __ldcg(r_in + base + d) - cv;
        const float qv = (n == 0 ? 0.f : __ldcg(p.qsum + base + d)) + cv;
        __stcg(p.residual + base + d, rv);
        __stcg(p.qsum + base + d, qv);
        s = __fmaf_rn(rv, rv, s);
      }
    }
    s = warp_sum(s);
    if (lane == 0) {
      p.codes[(size_t)n * p.M + row] = idx;
      p.err[(size_t)n * p.M + row] = s;
      p.rsq[row] = s;
      p.keys[row] = kNoKey;
    }
  }
}

template <bool kStochastic>
__global__ void __launch_bounds__(kMaxThreads)
rvq_chain_kernel(const __grid_constant__ ChainParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();

  // Init: |x|^2 per row and no key yet.  One warp per row.
  const int warps = gridDim.x * (blockDim.x / 32);
  const int lane = threadIdx.x % 32;
  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       row < p.M; row += warps) {
    const float* xr = p.x + (size_t)row * p.D;
    float s = 0.f;
    for (int d = lane; d < p.D; d += 32) s = __fmaf_rn(xr[d], xr[d], s);
    s = warp_sum(s);
    if (lane == 0) {
      p.rsq[row] = s;
      p.keys[row] = kNoKey;
    }
  }
  grid.sync();

  const int items = p.row_tiles * p.code_chunks;
  for (int n = 0; n < p.N; ++n) {
    const float* cb = p.codebook + (size_t)n * p.K * p.D;
    const float* a_src = n == 0 ? p.x : p.residual;
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      distance_item<kStochastic>(
          p, smem, a_src, cb, n, (item % p.row_tiles) * p.row_tile,
          (item / p.row_tiles) * kChunk);
    grid.sync();
    update_rows(p, cb, n);
    if (n + 1 < p.N) grid.sync();
  }
}

// The uniforms K2 draws, written out: out [N, M, K].
__global__ void rvq_philox_uniforms_kernel(float* __restrict__ out, int M,
                                           int K, long long total,
                                           unsigned int seed_lo,
                                           unsigned int seed_hi) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long per_layer = (long long)M * K;
  const int layer = (int)(i / per_layer);
  const long long rest = i % per_layer;
  out[i] = philox_uniform(seed_lo, seed_hi, layer, (int)(rest / K),
                          (int)(rest % K));
}

// Shared memory one block needs: the ring, the |c|^2 partial sums and
// K2's noise table.
int smem_needed(int row_tile) {
  return 4 * (kStages * (row_tile + kChunk) * kLd + kCsqParts * kChunk +
              row_tile * kGumbelLd);
}

const void* chain_kernel(bool stochastic) {
  return stochastic ? (const void*)rvq_chain_kernel<true>
                    : (const void*)rvq_chain_kernel<false>;
}

int launch_chain(bool stochastic, const float* x, const float* codebook,
                 float* residual, float* rsq, unsigned long long* keys,
                 int* codes, float* err, float* qsum, int M, int N, int K,
                 int D, int row_tile, int smem_bytes, int grid_blocks,
                 int vec, float temperature, unsigned long long seed,
                 cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (row_tile < 32 || row_tile > kRowTileMax || row_tile % 32 != 0 ||
      smem_bytes < smem_needed(row_tile) ||
      smem_bytes > smem_needed(kRowTileMax) || grid_blocks < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (vec && (D % 4 != 0 || (uintptr_t)x % 16 != 0 ||
              (uintptr_t)codebook % 16 != 0 || (uintptr_t)residual % 16 != 0 ||
              (uintptr_t)qsum % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  ChainParams p;
  p.x = x; p.codebook = codebook; p.residual = residual; p.rsq = rsq;
  p.keys = keys; p.codes = codes; p.err = err; p.qsum = qsum;
  p.M = M; p.N = N; p.K = K; p.D = D;
  p.row_tile = row_tile;
  p.row_tiles = (M + row_tile - 1) / row_tile;
  p.code_chunks = (K + kChunk - 1) / kChunk;
  p.vec = vec;
  p.temperature = temperature;
  p.seed_lo = (unsigned int)(seed & 0xffffffffull);
  p.seed_hi = (unsigned int)(seed >> 32);
  void* args[] = {(void*)&p};
  // A grid larger than the card holds at once is refused here
  // (cudaErrorCooperativeLaunchTooLarge), never cut.
  return (int)cudaLaunchCooperativeKernel(chain_kernel(stochastic),
                                          grid_blocks, kSplit * row_tile,
                                          args, (size_t)smem_bytes, stream);
}

}  // namespace

extern "C" {

// How many blocks of the chain kernel (stochastic: K2, else K1) at
// row_tile (32, 64 or 96) one SM holds at once, into *out.  It also raises
// the kernel's dynamic shared-memory limit on the current device to what
// the largest row tile needs, so call it once per device and mode before
// the first launch.  Returns its CUDA error (0 = success).
int rvq_blocks_per_sm(int stochastic, int row_tile, int* out) {
  if (row_tile < 32 || row_tile > kRowTileMax || row_tile % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const void* fn = chain_kernel(stochastic != 0);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_needed(kRowTileMax));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kSplit * row_tile, smem_needed(row_tile));
}

// x [M, D] and codebook [N, K, D], fp32 and contiguous.
// Workspace: residual [M, D] fp32, rsq [M] fp32, keys [M] u64.
// Outputs: codes [N, M] int32, err [N, M] fp32, qsum [M, D] fp32.
// Plan (rvq_kernel.py::launch_plan): row_tile (a multiple of 32, <= 96),
// smem_bytes (dynamic shared memory a block), grid_blocks (1 to what the
// SMs hold at once, from rvq_blocks_per_sm), vec (1: 16-byte copies,
// which need D % 4 == 0 and 16-byte aligned x, codebook, residual, qsum).
// One cooperative launch on `stream`; returns its CUDA error (0 = success).
int rvq_argmin_encode(const float* x, const float* codebook, float* residual,
                      float* rsq, unsigned long long* keys, int* codes,
                      float* err, float* qsum, int M, int N, int K, int D,
                      int row_tile, int smem_bytes, int grid_blocks, int vec,
                      void* stream) {
  return launch_chain(false, x, codebook, residual, rsq, keys, codes, err,
                      qsum, M, N, K, D, row_tile, smem_bytes, grid_blocks,
                      vec, 1.f, 0ull, (cudaStream_t)stream);
}

// K2: the same buffers and plan, plus the temperature (> 0) and the seed.
int rvq_sample_encode(const float* x, const float* codebook, float* residual,
                      float* rsq, unsigned long long* keys, int* codes,
                      float* err, float* qsum, int M, int N, int K, int D,
                      int row_tile, int smem_bytes, int grid_blocks, int vec,
                      float temperature, unsigned long long seed,
                      void* stream) {
  if (!(temperature > 0.f)) return (int)cudaErrorInvalidValue;
  return launch_chain(true, x, codebook, residual, rsq, keys, codes, err,
                      qsum, M, N, K, D, row_tile, smem_bytes, grid_blocks,
                      vec, temperature, seed, (cudaStream_t)stream);
}

// The uniforms rvq_sample_encode draws for (seed, N layers, M rows, K codes):
// out [N, M, K] fp32, for the plain version on the card.
int rvq_philox_uniforms(float* out, int M, int N, int K,
                        unsigned long long seed, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * M * K;
  const int threads = 256;
  rvq_philox_uniforms_kernel<<<(unsigned int)((total + threads - 1) / threads),
                               threads, 0, (cudaStream_t)stream>>>(
      out, M, K, total, (unsigned int)(seed & 0xffffffffull),
      (unsigned int)(seed >> 32));
  return (int)cudaGetLastError();
}

const char* rvq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
