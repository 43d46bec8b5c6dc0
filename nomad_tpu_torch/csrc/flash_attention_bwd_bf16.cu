// Masked multi-head attention backward in single-pass bf16 products with
// f32 accumulation, head width 64: kernel K2b (dQ) and kernel K3b (dK, dV),
// fed by one prologue kernel that folds their operands.
//
// Replaces nomad_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel at their own default precision
// (jax.lax.Precision.DEFAULT, :194-199, :233-238), the flavour that the
// "balanced" and "fast" configs differentiate through. Per (batch, head),
// over the keys t < lengths[b]:
//   s = (bf16(q) . bf16(k)) / sqrt(D),  p = exp(s - LSE)       (f32)
//   dp = bf16(dO) . bf16(v)^T,  ds = p o (dp - Di)               (f32)
//   K2b: dQ = Σ bf16(ds) . bf16(k) / sqrt(D)
//   K3b: dV = Σ bf16(p)^T . bf16(dO),  dK = Σ bf16(ds)^T . bf16(q) / sqrt(D)
// Every product rounds its operands to nearest-even bf16 and accumulates
// in f32; exp, the mask, Di and LSE stay f32. Di = rowsum(dO o O) is one
// plain PyTorch reduction ahead of the launches, as the JAX package
// computes it outside its kernels. K2 and K3 (flash_attention_bwd.cu) are
// the f32 flavour.
//
// Two I/O flavours from one template: q, k, v, dO and the outputs in f32,
// or in bf16 (the trainer's fast_bf16, where the TPU kernels read bf16
// blocks through astype(float32), :189-190, :230-231, and store dQ, dK and
// dV in the inputs' dtype, :219, :267-268). Only the prologue reads the
// inputs: it rounds f32 ones and copies bf16 ones, so both flavours run
// the one bf16 body on the same bits, and the bf16 flavour's outputs are
// the f32 flavour's on the upcast inputs, rounded once, by construction.
//
// What bounds them on an H100: by the bound, bytes. At the training shape
// [24, 499, 12, 64] the work reads ~0.17 GB of f32 q, k, v, dO for each of
// the two gradients (0.05 ms at 3.35 TB/s) against 14 * D FLOP per (query,
// key) pair together, 0.06 ms for both on the bf16 tensor cores at 989
// TFLOP/s; K2b and K3b themselves read the prologue's bf16 fold, half of
// those bytes, and the prologue reads the f32 inputs once. A block that
// loads, rounds and stores each tile itself and waits on it before its
// products is bound by that latency instead, and every block of a (batch,
// head) would re-read and re-round the same f32 tiles. With the design
// below what sets the pace is the products and the f32 elementwise work
// (exp, dS) between them, which a block does not overlap with its own
// products: the TMA ring hides behind them.
//
// Design:
//   * The prologue (flash_bwd_fold_bf16_kernel) writes bf16 copies of q,
//     k, v and dO once per backward call, folded head-major [B*H, T64, 64]
//     with T padded to T64, a multiple of 64, by zeros: the JAX package's
//     _fold_args layout (nomad_tpu/ops/flash_attention.py:143-161). Rows
//     of k and v at or past lengths[b] are written as 0, because inside
//     the tensor core 0 * NaN is NaN. It also copies LSE and Di into
//     [B*H, T64] f32 with zeros past T. Every tile the kernels read is then
//     one 64-row TMA box that never crosses a head and needs no mask.
//   * K2b: one block per 64 query rows, head and batch row: one consumer
//     warpgroup (4 warps, 16 rows a warp) and one producer warp, 3 blocks
//     an SM. The block's Q and dO rows come in once by TMA in the 128-byte
//     swizzle; LSE and Di stay in registers. The producer keeps a ring of 3
//     stages of (K, V) tiles full by TMA, one "full" and one "empty"
//     mbarrier a stage, only the tiles below the row's bound. S = Q K^T and
//     dP = dO V^T run on wgmma m64n64k16 from shared memory, in two commit
//     groups, so exp of S runs while dP is in flight; dS = P o (dP - Di) on
//     the f32 accumulators is rounded into register A fragments, and dQ +=
//     dS K runs on wgmma with A from registers and B the same K tile read
//     MN-major. A stage is released once the wgmma that last reads it has
//     completed (the next tile's first wait).
//   * K3b mirrors it, 2 blocks an SM (four accumulators): K and V of its
//     64 key rows stay resident; the ring streams every (Q, dO) tile of
//     the batch row with its 64 LSE and Di values (bulk copies). S^T = K
//     Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q. Keys past the bound
//     get p = 0 by select and dK = dV = 0; a block wholly past the bound
//     writes zeros and loads nothing.
//   * exp is taken of every element and the mask is a select, none on a
//     full tile: under `ok ? expf(x) : 0` the compiler branched per
//     element, which cost half of each kernel. No instruction writes an
//     accumulator between its wgmmas (S's first k-step does not
//     accumulate), or ptxas serialises them.
//   * The f32 sums keep the mma.sync kernels' order: each product runs its
//     four 16-deep k-steps in ascending order, tiles ascending, from
//     nothing (S, dP) or a zero accumulator (dQ, dK, dV), and wgmma's
//     per-element sums are mma.sync's (K4b kept K1b's bits the same way),
//     so the outputs are theirs bit for bit.
//   * No atomics: every dQ, dK and dV element is one thread's sum in a
//     fixed order, so a rerun gives the same bits. expf, not __expf, to
//     stay within f32 rounding of the plain version. A wait on an mbarrier
//     that outlasts ~2 s traps instead of holding the card.
// Launches on the caller's stream and allocates nothing: the caller hands
// in the fold's buffers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace nomad::sm90;

constexpr int kD = 64;                           // head width
constexpr int kRows = 64;                        // rows of a block = rows of a tile
constexpr int kConsumers = 4;                    // warps of the consumer warpgroup
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kStages = 3;                       // the ring
constexpr int kDqBlocks = 3;                     // per SM (__launch_bounds__): K2b
constexpr int kDkvBlocks = 2;                    // and K3b, with its four accumulators
constexpr int kTile = kRows * kD;                // bf16 values of a tile
constexpr uint32_t kTileBytes = kTile * 2;       // 8 KB
constexpr int kFoldThreads = 256;

struct Pair {  // two tiles in the 128-byte swizzle: K2b's (K, V), K3b's (Q, dO)
  __nv_bfloat16 a[kTile];
  __nv_bfloat16 b[kTile];
};
struct Smem {
  Pair resident;        // K2b: Q and dO of its query rows; K3b: K and V of its key rows
  Pair ring[kStages];   // the streamed tiles
  float lse[kStages][kRows];  // K3b: each streamed tile's LSE and Di
  float di[kStages][kRows];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t rows;        // the resident tiles have landed
};
// the tiles start on 1,024-byte boundaries (the swizzle atom); the
// dynamic shared memory is aligned by hand, hence the extra 1,024 bytes
constexpr int kSmemBytes = sizeof(Smem) + 1024;
static_assert(sizeof(Pair) % 1024 == 0, "swizzle atoms");
static_assert(kSmemBytes == 68152, "ops/flash_attention.py::BWD_BF16_SMEM_BYTES");

__device__ __forceinline__ Smem& shared_smem() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  return *reinterpret_cast<Smem*>(smem_raw + (((base + 1023) & ~1023u) - base));
}

__device__ __forceinline__ void init_barriers(Smem& sm) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < kStages; ++j) {
      mbar_init(&sm.full[j], 1);
      mbar_init(&sm.empty[j], kConsumers);  // one arrival a consumer warp
    }
    mbar_init(&sm.rows, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// ---- the prologue ----

// Block x of 6 B H: for x / (B H) = n < 4, rows t < T64 of folded tensor n
// (q, k, v, dO) of (batch, head) bh = x % (B H), rounded to bf16 (copied
// for bf16 inputs), 0 at t >= T and, for k and v, at t >= lengths[b]
// (attention_wgmma.cuh::fold_rows, K1b's prologue's too); for n = 4, 5,
// LSE and Di of bh, 0 at t >= T.
template <typename IO>
__global__ void __launch_bounds__(kFoldThreads)
flash_bwd_fold_bf16_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                           const IO* __restrict__ v, const IO* __restrict__ dout,
                           long long sqb, long long sqt, long long sqh,
                           long long skb, long long skt, long long skh,
                           long long svb, long long svt, long long svh,
                           long long sdb, long long sdt, long long sdh,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           const int* __restrict__ lengths, __nv_bfloat16* __restrict__ fold,
                           float* __restrict__ ld, int T, int H, int T64) {
  const int BH = gridDim.x / 6;
  const int n = blockIdx.x / BH;
  const int bh = blockIdx.x - n * BH;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long rows = static_cast<long long>(BH) * T64;  // rows of one folded tensor
  if (n >= 4) {
    const float* src = (n == 4 ? lse : di) + static_cast<long long>(bh) * T;
    float* dst = ld + (n - 4) * rows + static_cast<long long>(bh) * T64;
    for (int t = threadIdx.x; t < T64; t += kFoldThreads) dst[t] = t < T ? src[t] : 0.f;
    return;
  }
  const IO* x = n == 0 ? q : n == 1 ? k : n == 2 ? v : dout;
  const long long sb = n == 0 ? sqb : n == 1 ? skb : n == 2 ? svb : sdb;
  const long long st = n == 0 ? sqt : n == 1 ? skt : n == 2 ? svt : sdt;
  const long long sh = n == 0 ? sqh : n == 1 ? skh : n == 2 ? svh : sdh;
  const int bound = n == 1 || n == 2 ? min(max(lengths[b], 0), T) : T;
  fold_rows(x + b * sb + h * sh, st, bound, T64,
            fold + (n * rows + static_cast<long long>(bh) * T64) * kD, kFoldThreads);
}

// ---- the two kernels' shared parts ----

// Rows row and row + 8 of the accumulators acc (times scale; d[4j + 2i +
// e] is row row + 8i, column 8j + 2 (lane % 4) + e) into out (rows `st`
// elements apart), rows below `end` only; rounded once to nearest-even
// bf16 in the bf16 flavour.
template <typename IO>
__device__ __forceinline__ void store_rows(IO* out, long long st, int row, int end,
                                           const float (&acc)[32], float scale) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row + 8 * i;
    if (t >= end) continue;
    IO* orow = out + static_cast<long long>(t) * st;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = acc[4 * j + 2 * i] * scale, b = acc[4 * j + 2 * i + 1] * scale;
      if constexpr (std::is_same_v<IO, float>) {
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * c) = make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c) = __floats2bfloat162_rn(a, b);
      }
    }
  }
}

// issue (not wait) d = A . B^T over the head width, both tiles K-major in
// shared memory: the four 16-deep k-steps in ascending order, the first
// one not accumulating (no instruction writes d between the wgmmas), one
// commit group
__device__ __forceinline__ void issue_nt(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_m64n64(d, a + 2 * kk, b + 2 * kk, kk > 0);
  wgmma_commit();
}

// issue acc += bf16(X) . B over the tile's 64 rows, X in A fragments (k-step
// kk: rows 16kk .. 16kk + 15 of B), B a tile [row][d] read MN-major; one
// commit group
__device__ __forceinline__ void issue_nn(float (&acc)[32], const uint32_t (&xa)[4][4],
                                         const __nv_bfloat16* tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64_rs(acc, xa[kk], sw128_desc(smem_u32(tile + 16 * kk * kD)));
  }
  wgmma_commit();
}

// p[e] = exp(s[e] * scale - lse(e)) of one tile's accumulators, 0 where
// ok(e) is false (kMasked: a key past the bound, a query past T). exp is
// taken everywhere and the mask is a select, so a tile costs no branch;
// a masked element's exp (inf, say) is dropped, never multiplied.
template <bool kMasked, typename Lse, typename Ok>
__device__ __forceinline__ void probs(float (&p)[32], const float (&s)[32], float scale, Lse lse,
                                      Ok ok) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float x = expf(s[e] * scale - lse(e));
    p[e] = !kMasked || ok(e) ? x : 0.f;
  }
}

// ---- K2b ----

template <typename IO>
__global__ void __launch_bounds__(kThreads, kDqBlocks)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm, const float* __restrict__ ld,
                         const int* __restrict__ lengths, IO* __restrict__ dq, int T, int T64,
                         float scale) {
  Smem& sm = shared_smem();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int rows = gridDim.z * H * T64;  // rows of one folded tensor (< 2^29: the launcher)
  const int base = (b * H + h) * T64;    // row 0 of this (batch, head)
  const int r0 = blockIdx.x * kRows;
  const int len = min(max(lengths[b], 0), T);
  const int tiles = (len + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  init_barriers(sm);

  if (warp == kConsumers) {  // the producer warp: lane 0 keeps the ring full
    if (lane == 0 && tiles > 0) {
      mbar_expect_tx(&sm.rows, 2 * kTileBytes);
      tma_2d(sm.resident.a, &tm, 0, base + r0, &sm.rows, 0);             // Q
      tma_2d(sm.resident.b, &tm, 0, 3 * rows + base + r0, &sm.rows, 0);  // dO
      for (int s = 0; s < tiles; ++s) {
        const int j = s % kStages;
        if (s >= kStages) mbar_wait(&sm.empty[j], (s / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[j], 2 * kTileBytes);
        tma_2d(sm.ring[j].a, &tm, 0, rows + base + s * kRows, &sm.full[j], 0);      // K
        tma_2d(sm.ring[j].b, &tm, 0, 2 * rows + base + s * kRows, &sm.full[j], 0);  // V
      }
    }
    return;
  }

  const int c = lane & 3;
  const int row0 = r0 + 16 * warp + (lane >> 2);  // and row0 + 8
  float row_lse[2], row_di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = ld[base + row0 + 8 * i];
    row_di[i] = ld[rows + base + row0 + 8 * i];
  }
  float acc[32];  // dQ
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (tiles > 0) {
    mbar_wait(&sm.rows, 0);
    const uint64_t dq_desc = sw128_desc(smem_u32(sm.resident.a));
    const uint64_t do_desc = sw128_desc(smem_u32(sm.resident.b));
    float s[32] = {}, dp[32] = {}, p[32];
    uint32_t dsa[4][4] = {};
    for (int tile = 0; tile < tiles; ++tile) {
      const int j = tile % kStages;
      mbar_wait(&sm.full[j], (tile / kStages) & 1);
      issue_nt(s, dq_desc, sw128_desc(smem_u32(sm.ring[j].a)));   // S = Q K^T, unscaled
      issue_nt(dp, do_desc, sw128_desc(smem_u32(sm.ring[j].b)));  // dP = dO V^T
      wgmma_wait<1>();  // S, and the last tile's dQ product: its stage is free
      fence_regs(s);
      fence_regs(acc);
      fence_regs(dsa);
      if (tile >= 1 && tile - 1 + kStages < tiles && lane == 0) {
        mbar_arrive(&sm.empty[(tile - 1) % kStages]);
      }
      // element e: row 16 warp + lane / 4 + 8 (e / 2 % 2), key key0 + 8 (e / 4) + 2c + e % 2
      const int key0 = tile * kRows;
      const auto lse = [&](int e) { return row_lse[(e >> 1) & 1]; };
      const auto ok = [&](int e) { return key0 + 8 * (e / 4) + 2 * c + (e & 1) < len; };
      if (key0 + kRows <= len) {
        probs<false>(p, s, scale, lse, ok);
      } else {
        probs<true>(p, s, scale, lse, ok);
      }
      wgmma_wait<0>();  // dP
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const float d = row_di[r & 1];
          dsa[kk][r] = pack_bf16(p[e] * (dp[e] - d), p[e + 1] * (dp[e + 1] - d));
        }
      }
      issue_nn(acc, dsa, sm.ring[j].a);  // dQ += bf16(dS) . bf16(K)
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dsa);
  }
  store_rows(dq + (static_cast<long long>(b) * T * H + h) * kD, static_cast<long long>(H) * kD,
             row0, T, acc, scale);
}

// ---- K3b ----

template <typename IO>
__global__ void __launch_bounds__(kThreads, kDkvBlocks)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm, const float* __restrict__ ld,
                          const int* __restrict__ lengths, IO* __restrict__ dk,
                          IO* __restrict__ dv, int T, int T64, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int r0 = blockIdx.x * kRows;
  const int len = min(max(lengths[b], 0), T);
  const long long so = static_cast<long long>(H) * kD;
  IO* dkb = dk + (static_cast<long long>(b) * T * H + h) * kD;
  IO* dvb = dv + (static_cast<long long>(b) * T * H + h) * kD;
  if (r0 >= len) {  // every key row of the block past the bound: dK = dV = 0
    for (int u = threadIdx.x; u < kRows * (kD / 2); u += kThreads) {
      const int t = r0 + u / (kD / 2);
      if (t >= T) break;
      const int col = 2 * (u % (kD / 2));
      if constexpr (std::is_same_v<IO, float>) {
        *reinterpret_cast<float2*>(dkb + t * so + col) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dvb + t * so + col) = make_float2(0.f, 0.f);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dkb + t * so + col) = __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dvb + t * so + col) = __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    return;
  }
  Smem& sm = shared_smem();
  const int rows = gridDim.z * H * T64;
  const int base = (b * H + h) * T64;
  const int tiles = T64 / kRows;  // every query tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  init_barriers(sm);

  if (warp == kConsumers) {  // the producer warp: lane 0 keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(&sm.rows, 2 * kTileBytes);
      tma_2d(sm.resident.a, &tm, 0, rows + base + r0, &sm.rows, 0);      // K
      tma_2d(sm.resident.b, &tm, 0, 2 * rows + base + r0, &sm.rows, 0);  // V
      for (int s = 0; s < tiles; ++s) {
        const int j = s % kStages;
        if (s >= kStages) mbar_wait(&sm.empty[j], (s / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[j], 2 * kTileBytes + 2 * kRows * 4);
        tma_2d(sm.ring[j].a, &tm, 0, base + s * kRows, &sm.full[j], 0);             // Q
        tma_2d(sm.ring[j].b, &tm, 0, 3 * rows + base + s * kRows, &sm.full[j], 0);  // dO
        bulk_copy(sm.lse[j], ld + base + s * kRows, kRows * 4, &sm.full[j]);
        bulk_copy(sm.di[j], ld + rows + base + s * kRows, kRows * 4, &sm.full[j]);
      }
    }
    return;
  }

  const int c = lane & 3;
  const int row0 = r0 + 16 * warp + (lane >> 2);  // and row0 + 8
  const bool key_ok[2] = {row0 < len, row0 + 8 < len};
  const bool full_rows = r0 + kRows <= len;
  float gk[32], gv[32];  // dK, dV
#pragma unroll
  for (int i = 0; i < 32; ++i) gk[i] = gv[i] = 0.f;
  mbar_wait(&sm.rows, 0);
  const uint64_t k_desc = sw128_desc(smem_u32(sm.resident.a));
  const uint64_t v_desc = sw128_desc(smem_u32(sm.resident.b));
  float s[32] = {}, dpt[32] = {}, p[32];
  uint32_t pa[4][4] = {}, dsa[4][4] = {};
  for (int tile = 0; tile < tiles; ++tile) {
    const int j = tile % kStages;
    mbar_wait(&sm.full[j], (tile / kStages) & 1);
    issue_nt(s, k_desc, sw128_desc(smem_u32(sm.ring[j].a)));    // S^T = K Q^T, unscaled
    issue_nt(dpt, v_desc, sw128_desc(smem_u32(sm.ring[j].b)));  // dP^T = V dO^T
    wgmma_wait<1>();  // S^T, and the last tile's dV and dK products: its stage is free
    fence_regs(s);
    fence_regs(gk);
    fence_regs(gv);
    fence_regs(pa);
    fence_regs(dsa);
    if (tile >= 1 && tile - 1 + kStages < tiles && lane == 0) {
      mbar_arrive(&sm.empty[(tile - 1) % kStages]);
    }
    // element e: key row 16 warp + lane / 4 + 8 (e / 2 % 2), query q0 + col(e)
    const int q0 = tile * kRows;
    const auto col = [&](int e) { return 8 * (e / 4) + 2 * c + (e & 1); };
    const auto lse = [&](int e) { return sm.lse[j][col(e)]; };
    const auto ok = [&](int e) { return key_ok[(e >> 1) & 1] && q0 + col(e) < T; };
    if (full_rows && q0 + kRows <= T) {
      probs<false>(p, s, scale, lse, ok);
    } else {
      probs<true>(p, s, scale, lse, ok);
    }
    wgmma_wait<0>();  // dP^T
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r;
        pa[kk][r] = pack_bf16(p[e], p[e + 1]);
        dsa[kk][r] = pack_bf16(p[e] * (dpt[e] - sm.di[j][col(e)]),
                               p[e + 1] * (dpt[e + 1] - sm.di[j][col(e + 1)]));
      }
    }
    issue_nn(gv, pa, sm.ring[j].b);   // dV += bf16(P^T) . bf16(dO)
    issue_nn(gk, dsa, sm.ring[j].a);  // dK += bf16(dS^T) . bf16(Q)
  }
  wgmma_wait<0>();
  fence_regs(gk);
  fence_regs(gv);
  fence_regs(pa);
  fence_regs(dsa);
  // rows past the bound: their p was 0, so 0 here; written as 0 all the same
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key_ok[i]) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      gk[4 * jj + 2 * i] = gk[4 * jj + 2 * i + 1] = 0.f;
      gv[4 * jj + 2 * i] = gv[4 * jj + 2 * i + 1] = 0.f;
    }
  }
  store_rows(dkb, so, row0, T, gk, scale);
  store_rows(dvb, so, row0, T, gv, 1.f);
}

// ---- host side ----

int padded(int T) { return (T + kRows - 1) / kRows * kRows; }

cudaError_t check_args(int B, int T, int H, int D) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  // TMA's row coordinates are 32-bit: the four folded tensors' rows
  if (4ll * B * H * padded(T) > INT_MAX / 4) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename IO>
cudaError_t configure_kernels() {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<IO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<IO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  return err;
}

cudaError_t configure() {
  static bool done = false;
  if (!done) {
    cudaError_t err = configure_kernels<float>();
    if (err == cudaSuccess) err = configure_kernels<__nv_bfloat16>();
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

// the folded q, k, v, dO ([4 B H T64, 64] bf16) as one tensor map, 64-row
// boxes in the 128-byte swizzle
cudaError_t fold_map(CUtensorMap* map, const void* fold, int B, int H, int T) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD),
                              4ull * B * H * static_cast<cuuint64_t>(padded(T))};
  const cuuint64_t strides[1] = {2ull * kD};
  return make_map(map, fold, 2, dims, strides, kRows);
}

// the kernels' launch plan, checked against the caller's
cudaError_t check_plan(int rows_per_block, int threads, int smem_bytes) {
  return rows_per_block == kRows && threads == kThreads && smem_bytes == kSmemBytes
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <typename IO>
void launch_fold(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* di, const void* lengths, void* fold, void* ld, int B, int T, int H,
                 const long long (&st)[12], cudaStream_t stream) {
  flash_bwd_fold_bf16_kernel<IO><<<6 * B * H, kFoldThreads, 0, stream>>>(
      static_cast<const IO*>(q), static_cast<const IO*>(k), static_cast<const IO*>(v),
      static_cast<const IO*>(dout), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(fold), static_cast<float*>(ld), T, H, padded(T));
}

// K2b and K3b on the fold through one tensor map, on the caller's stream
cudaError_t launch_dq(const CUtensorMap& tm, const void* ld, const void* lengths, void* dq,
                      int B, int T, int H, float scale, int bf16_io, cudaStream_t s) {
  const dim3 grid(padded(T) / kRows, H, B);
  if (bf16_io) {
    flash_bwd_dq_bf16_kernel<__nv_bfloat16><<<grid, kThreads, kSmemBytes, s>>>(
        tm, static_cast<const float*>(ld), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(dq), T, padded(T), scale);
  } else {
    flash_bwd_dq_bf16_kernel<float><<<grid, kThreads, kSmemBytes, s>>>(
        tm, static_cast<const float*>(ld), static_cast<const int*>(lengths),
        static_cast<float*>(dq), T, padded(T), scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_dkv(const CUtensorMap& tm, const void* ld, const void* lengths, void* dk,
                       void* dv, int B, int T, int H, float scale, int bf16_io, cudaStream_t s) {
  const dim3 grid(padded(T) / kRows, H, B);
  if (bf16_io) {
    flash_bwd_dkv_bf16_kernel<__nv_bfloat16><<<grid, kThreads, kSmemBytes, s>>>(
        tm, static_cast<const float*>(ld), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, padded(T), scale);
  } else {
    flash_bwd_dkv_bf16_kernel<float><<<grid, kThreads, kSmemBytes, s>>>(
        tm, static_cast<const float*>(ld), static_cast<const int*>(lengths),
        static_cast<float*>(dk), static_cast<float*>(dv), T, padded(T), scale);
  }
  return cudaGetLastError();
}

// what every K2b/K3b entry checks: the arguments and the caller's plan
cudaError_t check_call(int B, int T, int H, int D, int rows_per_block, int threads,
                       int smem_bytes) {
  const cudaError_t err = check_args(B, T, H, D);
  return err == cudaSuccess ? check_plan(rows_per_block, threads, smem_bytes) : err;
}

// the kernels' shared memory set, then the fold's tensor map
cudaError_t prepare(CUtensorMap* tm, const void* fold, int B, int T, int H) {
  const cudaError_t err = configure();
  return err == cudaSuccess ? fold_map(tm, fold, B, H, T) : err;
}

template <typename IO>
int occupancy(int dkv, int* blocks_per_sm) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dkv) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_bwd_dkv_bf16_kernel<IO>, kThreads, kSmemBytes));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_bwd_dq_bf16_kernel<IO>, kThreads, kSmemBytes));
}

}  // namespace

// The prologue: q, k, v, dout [B, T, H, 64] with unit stride on the last
// axis, f32 (bf16_io = 0; the other strides, in elements, multiples of 4)
// or bf16 (bf16_io = 1; multiples of 8), 16-byte aligned; lse, di: f32 [B,
// H, T] contiguous; lengths: int32 [B]. Writes fold: bf16 [4, B * H, T64,
// 64] (q, k, v, dO folded head-major, T64 = T rounded up to 64; zeros at t
// >= T and, for k and v, at t >= lengths[b]) and ld: f32 [2, B * H, T64]
// (LSE, Di; zeros at t >= T), both 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int nomad_flash_attention_bwd_bf16_fold(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* di, const void* lengths, void* fold, void* ld, int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sdb, long long sdt, long long sdh,
    int bf16_io, void* stream) {
  const cudaError_t err = check_args(B, T, H, D);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const long long st[12] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh};
  auto run = bf16_io ? launch_fold<__nv_bfloat16> : launch_fold<float>;
  run(q, k, v, dout, lse, di, lengths, fold, ld, B, T, H, st, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K2b on the prologue's fold and ld; lengths: int32 [B]; dq: [B, T, H, 64]
// contiguous, f32 (bf16_io = 0) or bf16 (1). The launch plan
// (ops/flash_attention.py::flash_bwd_bf16_launch_plan): rows per block,
// threads and dynamic shared memory, checked against the kernel's own.
// Returns cudaGetLastError().
extern "C" int nomad_flash_attention_bwd_bf16_dq(const void* fold, const void* ld,
                                                 const void* lengths, void* dq, int B, int T,
                                                 int H, int D, int rows_per_block, int threads,
                                                 int smem_bytes, float scale, int bf16_io,
                                                 void* stream) {
  cudaError_t err = check_call(B, T, H, D, rows_per_block, threads, smem_bytes);
  if (err != cudaSuccess || B == 0 || T == 0 || H == 0) return err;
  CUtensorMap tm;
  err = prepare(&tm, fold, B, T, H);
  if (err != cudaSuccess) return err;
  return launch_dq(tm, ld, lengths, dq, B, T, H, scale, bf16_io,
                   static_cast<cudaStream_t>(stream));
}

// K3b, as K2b; dk, dv: [B, T, H, 64] contiguous, f32 or bf16.
extern "C" int nomad_flash_attention_bwd_bf16_dkv(const void* fold, const void* ld,
                                                  const void* lengths, void* dk, void* dv, int B,
                                                  int T, int H, int D, int rows_per_block,
                                                  int threads, int smem_bytes, float scale,
                                                  int bf16_io, void* stream) {
  cudaError_t err = check_call(B, T, H, D, rows_per_block, threads, smem_bytes);
  if (err != cudaSuccess || B == 0 || T == 0 || H == 0) return err;
  CUtensorMap tm;
  err = prepare(&tm, fold, B, T, H);
  if (err != cudaSuccess) return err;
  return launch_dkv(tm, ld, lengths, dk, dv, B, T, H, scale, bf16_io,
                    static_cast<cudaStream_t>(stream));
}

// The whole backward in one call, as the port's wrapper runs it: the
// prologue, K2b and K3b on one stream, one tensor map for both (the
// arguments of the three entries above). Returns the first error.
extern "C" int nomad_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* di, const void* lengths, void* fold, void* ld, void* dq, void* dk, void* dv,
    int B, int T, int H, int D, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh, long long sdb,
    long long sdt, long long sdh, int rows_per_block, int threads, int smem_bytes, float scale,
    int bf16_io, void* stream) {
  cudaError_t err = check_call(B, T, H, D, rows_per_block, threads, smem_bytes);
  if (err != cudaSuccess || B == 0 || T == 0 || H == 0) return err;
  CUtensorMap tm;
  err = prepare(&tm, fold, B, T, H);
  if (err != cudaSuccess) return err;
  const long long st[12] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fold_run = bf16_io ? launch_fold<__nv_bfloat16> : launch_fold<float>;
  fold_run(q, k, v, dout, lse, di, lengths, fold, ld, B, T, H, st, s);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_dq(tm, ld, lengths, dq, B, T, H, scale, bf16_io, s);
  if (err == cudaSuccess) {
    err = launch_dkv(tm, ld, lengths, dk, dv, B, T, H, scale, bf16_io, s);
  }
  return static_cast<int>(err);
}

// Resident blocks per SM of K2b (dkv = 0) or K3b (dkv = 1), of their f32
// (bf16_io = 0) or bf16 (1) I/O flavour, at their dynamic shared memory; 0
// if it cannot run.
extern "C" int nomad_flash_attention_bwd_bf16_occupancy(int dkv, int bf16_io,
                                                        int* blocks_per_sm) {
  return bf16_io ? occupancy<__nv_bfloat16>(dkv, blocks_per_sm)
                 : occupancy<float>(dkv, blocks_per_sm);
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
