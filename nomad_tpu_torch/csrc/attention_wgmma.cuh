// The bf16 attention key loop on wgmma that K1b (flash_attention_bf16.cu)
// and the phase 2 of K4b and K4h (fused_attention_bf16.cu) share, and the
// row fold that K1b's and K2b/K3b's prologues (flash_attention_bwd_bf16.cu)
// share.
//
// One consumer warpgroup (4 warps, 16 query rows a warp) attends its 64
// query rows, held bf16 in one 128-byte-swizzled tile of shared memory
// (Q / sqrt(D), rounded), over 64-key tiles of K and V, each 64 rows of 128
// bytes in the same swizzle:
//   * S = Q . K^T by wgmma m64n64k16 from shared memory, the four 16-deep
//     k-steps in ascending order, the first not accumulating (no
//     instruction writes S between its wgmmas, or ptxas serialises them);
//   * the online softmax on the f32 accumulator fragments against the
//     running maximum: exp2f of every element, the mask a select on a tile
//     the bound cuts (under `ok ? exp2f(x) : 0` the compiler branched per
//     element); none on a full tile;
//   * P rounded to bf16 into register A fragments, O += P . V by wgmma with
//     A from registers and V MN-major;
//   * the scores of the next tile and their softmax run while P . V of this
//     one is in flight.
// The per-element sums are mma.sync m16n8k16's in the same order (k-steps
// and key tiles ascending), so O and LSE are the bits of the mma.sync K1b
// that this loop replaced.
//
// With Passes = 3 (K4h, the TPU kernel's "high3") every operand comes as a
// hi and a lo bf16 plane (hi = bf16(a), lo = bf16(a - hi)) and each product
// is three passes into one f32 accumulator, k-step by k-step: hi.hi, hi.lo,
// lo.hi (the lo.lo term is dropped, as the TPU kernel's _dot drops it); P is
// split in registers into two A fragments.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace nomad {
namespace sm90 {

constexpr int kAttnRows = 64;  // query rows of a warpgroup = keys of a tile = head width
constexpr float kAttnNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct KeyTile {  // K then V of 64 keys, each 64 rows of 128 bytes in the swizzle
  __nv_bfloat16 k[kAttnRows * kAttnRows];
  __nv_bfloat16 v[kAttnRows * kAttnRows];
};
struct KeyTileHL {  // the same as hi and lo planes: K hi, K lo, V hi, V lo
  __nv_bfloat16 k[2][kAttnRows * kAttnRows];
  __nv_bfloat16 v[2][kAttnRows * kAttnRows];
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the consumer warpgroup's own barrier (a producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// S = Q . K^T of one key tile, issued and committed (not waited): both
// K-major (d contiguous); s[4j + 2i + e] row 16 warp + lane / 4 + 8i, key
// 8j + 2 (lane % 4) + e. Passes = 3: Q's planes at dq and dq_lo, K's in
// kt.k[0] and kt.k[1]
template <int Passes, class Tile>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint64_t dq, uint64_t dq_lo,
                                             const Tile& kt) {
  if constexpr (Passes == 1) {
    const uint64_t dk = sw128_desc(smem_u32(kt.k));
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAttnRows / 16; ++kk) wgmma_m64n64(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
  } else {
    const uint64_t dk = sw128_desc(smem_u32(kt.k[0]));
    const uint64_t dk_lo = sw128_desc(smem_u32(kt.k[1]));
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAttnRows / 16; ++kk) {
      wgmma_m64n64(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
      wgmma_m64n64(s, dq + 2 * kk, dk_lo + 2 * kk);
      wgmma_m64n64(s, dq_lo + 2 * kk, dk + 2 * kk);
    }
    wgmma_commit();
  }
}

// O += bf16(P) . bf16(V), issued and committed: k-step kk covers keys
// 16kk .. 16kk + 15, whose A fragments pa[kk] are the P fragments of key
// tiles 2kk and 2kk + 1; V's rows (keys) of 128 bytes are B MN-major,
// 8-key atoms 1,024 bytes apart. Passes = 3: P's lo fragments in pl, V's
// planes in kt.v[0] and kt.v[1]
template <int Passes, class Tile>
__device__ __forceinline__ void issue_values(float (&acc)[32], const uint32_t (&pa)[4][4],
                                             const uint32_t (&pl)[4][4], const Tile& kt) {
  fence_regs(acc);
  wgmma_fence();
  if constexpr (Passes == 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64_rs(acc, pa[kk], sw128_desc(smem_u32(kt.v + 16 * kk * kAttnRows)));
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(smem_u32(kt.v[0] + 16 * kk * kAttnRows));
      const uint64_t dv_lo = sw128_desc(smem_u32(kt.v[1] + 16 * kk * kAttnRows));
      wgmma_m64n64_rs(acc, pa[kk], dv);
      wgmma_m64n64_rs(acc, pa[kk], dv_lo);
      wgmma_m64n64_rs(acc, pl[kk], dv);
    }
  }
  wgmma_commit();
}

// the online softmax of one tile's scores s (keys key0 + ..., those >= len
// masked unless the whole tile is valid, kFull): updates the row maxima m
// and this thread's share of the row sums l, gives each row's rescale
// factor for O, and P rounded to bf16 as wgmma A fragments (k-step kk
// takes key tiles 2kk and 2kk + 1; Passes = 3: P's hi plane in pa, its lo
// plane in pl, l the sum of the unrounded p). exp2f is taken of every
// element and a masked one dropped by select: a masked key's row of K is
// 0, so its score is finite. It only reads s, so that ptxas keeps P . V,
// whose accumulators are elsewhere, in flight around it.
template <bool kFull, int Passes>
__device__ __forceinline__ void softmax_tile(const float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[4][4],
                                             uint32_t (&pl)[4][4], int key0, int len, int c) {
  float p[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kFull || key0 + 8 * jj + 2 * c + e < len;
        mx = fmaxf(mx, ok ? s[4 * jj + 2 * i + e] : kAttnNegInf);
      }
    }
    mx = quad_max(mx);
    alpha[i] = exp2f((m[i] - mx) * kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kFull || key0 + 8 * jj + 2 * c + e < len;
        const float x = exp2f((s[4 * jj + 2 * i + e] - mx) * kLog2e);
        const float v = ok ? x : 0.f;
        p[4 * jj + 2 * i + e] = v;
        sum += v;
      }
    }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = mx;
  }
  if constexpr (Passes == 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1], pa[kk][r], pl[kk][r]);
      }
    }
  }
}

// the same, choosing the unmasked form where every key of the tile is valid
template <int Passes>
__device__ __forceinline__ void softmax_tile(const float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[4][4],
                                             uint32_t (&pl)[4][4], int key0, int len, int c) {
  if (key0 + kAttnRows <= len) {
    softmax_tile<true, Passes>(s, m, l, alpha, pa, pl, key0, len, c);
  } else {
    softmax_tile<false, Passes>(s, m, l, alpha, pa, pl, key0, len, c);
  }
}

// The key loop of the consumer warpgroup over `tiles` key tiles (keys
// 64t .. 64t + 63 of tile t, those >= len masked), Q's descriptor dq (and
// with Passes = 3 its lo plane's, dq_lo; at(t) then a KeyTileHL): acc
// (O, acc[4j + 2i + e] row 16 warp + lane / 4 + 8i, d 8j + 2 (lane % 4) +
// e), m and l (this thread's share of each row's sum) carried in and out.
// The caller supplies where tile t lies and when it may be read:
//   at(t)      the tile in shared memory;
//   wait(t)    returns once tile t may be read by wgmma (called in order);
//   begin(t)   at the start of iteration t (t + 1 is waited on next);
//   release(t) once nothing reads tile t any more (its P . V complete).
template <int Passes = 1, class At, class Wait, class Begin, class Release>
__device__ __forceinline__ void attend_tiles(float (&acc)[32], float (&m)[2], float (&l)[2],
                                             uint64_t dq, int tiles, int len, At at, Wait wait,
                                             Begin begin, Release release, uint64_t dq_lo = 0) {
  static_assert(Passes == 1 || Passes == 3, "one bf16 pass, or high3's three");
  const int c = threadIdx.x & 3;
  float alpha[2];
  float s[32] = {};  // written by wgmma alone from here on
  uint32_t pa[4][4], pn[4][4];  // P of the tile in P . V, of the next one
  uint32_t pal[4][4], pnl[4][4];  // their lo planes (Passes = 3)
  if (tiles > 0) {
    wait(0);
    issue_scores<Passes>(s, dq, dq_lo, at(0));
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<Passes>(s, m, l, alpha, pn, pnl, 0, len, c);
  }
  for (int tile = 0; tile < tiles; ++tile) {
    // here: P of `tile` in pn, O rescaled to its maximum
    const bool next = tile + 1 < tiles;
    begin(tile);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // read by P . V until it completes
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
      if constexpr (Passes == 3) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pal[kk][r] = pnl[kk][r];
      }
    }
    if (next) {
      wait(tile + 1);
      issue_scores<Passes>(s, dq, dq_lo, at(tile + 1));
    }
    issue_values<Passes>(acc, pa, pal, at(tile));
    wgmma_wait<1>();  // the scores of tile + 1; P . V of tile still in flight
    fence_regs(s);
    if (next) softmax_tile<Passes>(s, m, l, alpha, pn, pnl, (tile + 1) * kAttnRows, len, c);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if constexpr (Passes == 3) fence_regs(pal);
    if (next) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * jj + 2 * i] *= alpha[i];
          acc[4 * jj + 2 * i + 1] *= alpha[i];
        }
      }
    }
    release(tile);
  }
}

// Rows t < T64 of one (batch, head) of x (row stride st elements, unit
// stride along the 64 values of a row) into dst [T64, 64] as bf16: rounded
// to nearest-even from f32, copied from bf16; rows at t >= bound written
// 0. 8 values a thread and step, by the block's `threads` threads.
template <typename IO>
__device__ __forceinline__ void fold_rows(const IO* __restrict__ x, long long st, int bound,
                                          int T64, __nv_bfloat16* __restrict__ dst, int threads) {
  for (int u = threadIdx.x; u < T64 * (kAttnRows / 8); u += threads) {
    const int t = u / (kAttnRows / 8);
    const int col = 8 * (u % (kAttnRows / 8));
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (t < bound) {
      const IO* src = x + t * st + col;
      if constexpr (std::is_same_v<IO, float>) {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 c = *reinterpret_cast<const float4*>(src + 4);
        out = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(c.x, c.y),
                         pack_bf16(c.z, c.w));
      } else {
        out = *reinterpret_cast<const uint4*>(src);
      }
    }
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(t) * kAttnRows + col) = out;
  }
}

}  // namespace sm90
}  // namespace nomad
