// The bf16 attention key loop on wgmma that K1b and K1-bf16
// (flash_attention_bf16.cu) and the phase 2 of K4b, K4h and K4-bf16
// (fused_attention_bf16.cu) share, and the row fold that K1b's and
// K2b/K3b's prologues (flash_attention_bwd_bf16.cu) share.
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
// The flavours differ in their bf16 passes, SPasses for S and VPasses for
// P . V (AttnPasses below):
//   * (1, 1), K1b and K4b: one pass each, as above.
//   * (3, 3), K4h (the TPU kernel's "high3"): every operand a hi and a lo
//     plane (hi = bf16(a), lo = bf16(a - hi)) and each product three passes
//     into one f32 accumulator, k-step by k-step: hi.hi, hi.lo, lo.hi (the
//     lo.lo term is dropped, as the TPU kernel's _dot drops it); P is split
//     in registers into two A fragments.
//   * (1, 3), K1-bf16 ("highest" on bf16 q, k, v): S is one pass, exact
//     products of the bf16 operands summed in f32; p is scaled by 2^16
//     (exact) and split in registers into three bf16 planes (hopper.cuh::
//     split3_bf16, whose sum is the scaled p exactly), and P . V is three
//     passes against the bf16 V, one a plane (lo, mid, hi: the small terms
//     first), into a zeroed accumulator of the tile's own that is added to
//     O's in f32 once the passes complete (the tensor core's f32
//     accumulation drifts over many passes: K4h's finding).
//   * (6, 6), K4-bf16 ("highest" on a bf16 x, whose Q, K and V are f32):
//     Q, K and V come as three planes each, scaled by 2^16 (the caller's),
//     and S takes the six terms of XLA's bf16 x 6 decomposition of HIGHEST,
//     mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi (the small terms first;
//     the terms dropped are under 2^-24 relative), scaled back by 2^-32
//     before the softmax; P is split as K1-bf16's and P . V takes the same
//     six terms against V's planes into the tile's own accumulator.
// With three planes of P, l is the sum of the unscaled, unrounded p, and
// the caller scales O back (AttnPasses::kOScale, times V's own scale).

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
struct KeyTile3 {  // the same as three planes: K hi, mid, lo, then V's
  __nv_bfloat16 k[3][kAttnRows * kAttnRows];
  __nv_bfloat16 v[3][kAttnRows * kAttnRows];
};

// One flavour's passes: SPasses for S = Q . K^T, VPasses for O += P . V
template <int SPasses, int VPasses>
struct AttnPasses {
  static_assert((SPasses == 1 && VPasses == 1) || (SPasses == 3 && VPasses == 3) ||
                    (SPasses == 1 && VPasses == 3) || (SPasses == 6 && VPasses == 6),
                "K1b/K4b (1, 1), K4h (3, 3), K1-bf16 (1, 3) or K4-bf16 (6, 6)");
  // P in three planes, scaled by kSplitScale, each tile's P . V summed apart
  static constexpr bool kPlanes3 = VPasses != 1 && SPasses != 3;
  static constexpr float kSplitScale = 65536.f;  // 2^16: every plane on bf16's grid
  // S's planes' scale (Q's and K's 2^16 each) taken back before the softmax
  static constexpr float kSScale = 1.f / (kSplitScale * kSplitScale);
  // O's accumulator over O, but for V's own scale: P's split
  static constexpr float kOScale = kPlanes3 ? 1.f / kSplitScale : 1.f;
  // the next tile's scores and softmax once this tile's P . V has
  // completed, not while it is in flight: K1-bf16, whose planes of P and
  // the tile's own sum beside the next tile's scores would outgrow the 168
  // registers a thread of 2 blocks an SM may have (ptxas spilled); the
  // other block of the SM keeps the tensor cores busy meanwhile
  static constexpr bool kSerial = SPasses == 1 && VPasses == 3;
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

// Term u of the six-pass product a . b (XLA's bf16 x 6 for HIGHEST), the
// small terms first: (plane of a, plane of b) = (mid, mid), (lo, hi),
// (hi, lo), (mid, hi), (hi, mid), (hi, hi); planes 0 hi, 1 mid, 2 lo
__host__ __device__ constexpr int six_a(int u) {
  return u == 0 ? 1 : u == 1 ? 2 : u == 3 ? 1 : 0;
}
__host__ __device__ constexpr int six_b(int u) {
  return u == 0 ? 1 : u == 2 ? 2 : u == 4 ? 1 : 0;
}

// S = Q . K^T of one key tile, issued and committed (not waited): both
// K-major (d contiguous); s[4j + 2i + e] row 16 warp + lane / 4 + 8i, key
// 8j + 2 (lane % 4) + e. dq[n]: Q's plane n (SPasses = 3: hi, lo; 6: hi,
// mid, lo), K's in kt.k[n]
template <int SPasses, class Tile>
__device__ __forceinline__ void issue_scores(float (&s)[32], const uint64_t (&dq)[3],
                                             const Tile& kt) {
  if constexpr (SPasses == 1) {
    const uint64_t dk = sw128_desc(smem_u32(kt.k));
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAttnRows / 16; ++kk) wgmma_m64n64(s, dq[0] + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
  } else if constexpr (SPasses == 3) {
    const uint64_t dk = sw128_desc(smem_u32(kt.k[0]));
    const uint64_t dk_lo = sw128_desc(smem_u32(kt.k[1]));
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAttnRows / 16; ++kk) {
      wgmma_m64n64(s, dq[0] + 2 * kk, dk + 2 * kk, kk > 0);
      wgmma_m64n64(s, dq[0] + 2 * kk, dk_lo + 2 * kk);
      wgmma_m64n64(s, dq[1] + 2 * kk, dk + 2 * kk);
    }
    wgmma_commit();
  } else {
    // the six terms (Q plane, K plane), the small ones first
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const uint64_t dk = sw128_desc(smem_u32(kt.k[six_b(u)]));
#pragma unroll
      for (int kk = 0; kk < kAttnRows / 16; ++kk) {
        wgmma_m64n64(s, dq[six_a(u)] + 2 * kk, dk + 2 * kk, u > 0 || kk > 0);
      }
    }
    wgmma_commit();
  }
}

// A tile's P as wgmma A fragments, plane by plane (k-step kk takes key
// tiles 2kk and 2kk + 1): plane 0 the rounded P (VPasses = 1) or hi, then
// lo (K4h) or mid, lo (three planes)
struct PPlanes {
  uint32_t f[3][4][4];
};

template <int N>
__device__ __forceinline__ void fence_planes(PPlanes& p) {
#pragma unroll
  for (int n = 0; n < N; ++n) fence_regs(p.f[n]);
}

// O += bf16(P) . bf16(V), issued and committed: k-step kk covers keys
// 16kk .. 16kk + 15, whose A fragments are p.f[n][kk]; V's rows (keys) of
// 128 bytes are B MN-major, 8-key atoms 1,024 bytes apart. K4h: P's hi and
// lo planes against V's, kt.v[0] and kt.v[1], into acc. Three planes of P
// (K1-bf16 against the one V tile, K4-bf16's six terms against V's three
// planes): into part, the tile's own sum, whose first pass does not
// accumulate
template <int SPasses, int VPasses, class Tile>
__device__ __forceinline__ void issue_values(float (&acc)[32], float (&part)[32],
                                             const PPlanes& p, const Tile& kt) {
  if constexpr (VPasses == 1) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64_rs(acc, p.f[0][kk], sw128_desc(smem_u32(kt.v + 16 * kk * kAttnRows)));
    }
  } else if constexpr (SPasses == 3) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(smem_u32(kt.v[0] + 16 * kk * kAttnRows));
      const uint64_t dv_lo = sw128_desc(smem_u32(kt.v[1] + 16 * kk * kAttnRows));
      wgmma_m64n64_rs(acc, p.f[0][kk], dv);
      wgmma_m64n64_rs(acc, p.f[0][kk], dv_lo);
      wgmma_m64n64_rs(acc, p.f[1][kk], dv);
    }
  } else if constexpr (VPasses == 3) {  // lo, mid, hi against the one V tile
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int n = 2; n >= 0; --n) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64_rs(part, p.f[n][kk], sw128_desc(smem_u32(kt.v + 16 * kk * kAttnRows)),
                        n < 2 || kk > 0);
      }
    }
  } else {  // the six terms (P plane, V plane), the small ones first
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 6; ++u) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64_rs(part, p.f[six_a(u)][kk],
                        sw128_desc(smem_u32(kt.v[six_b(u)] + 16 * kk * kAttnRows)),
                        u > 0 || kk > 0);
      }
    }
  }
  wgmma_commit();
}

// the online softmax of one tile's scores s (keys key0 + ..., those >= len
// masked unless the whole tile is valid, kFull): updates the row maxima m
// and this thread's share of the row sums l, gives each row's rescale
// factor for O, and P: rounded to bf16 as wgmma A fragments in pn.f[0]
// (VPasses = 1), split into K4h's hi and lo planes in pn.f[0], pn.f[1],
// or with three planes of P, as f32 times kSplitScale in pf, split at the
// start of the tile's P . V (k-step kk takes key tiles 2kk and 2kk + 1).
// l is the sum of the unrounded (and unscaled) p. SPasses = 6: the scores
// times kSScale. exp2f is taken of every element and a masked one dropped
// by select: a masked key's row of K is 0, so its score is finite. It
// only reads s, so that ptxas keeps P . V, whose accumulators are
// elsewhere, in flight around it.
template <bool kFull, int SPasses, int VPasses>
__device__ __forceinline__ void softmax_tile(const float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], PPlanes& pn, float (&pf)[32],
                                             int key0, int len, int c) {
  using P = AttnPasses<SPasses, VPasses>;
  const auto score = [&](int e) {
    if constexpr (SPasses == 6) {
      return s[e] * P::kSScale;
    } else {
      return s[e];
    }
  };
  float p[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kFull || key0 + 8 * jj + 2 * c + e < len;
        mx = fmaxf(mx, ok ? score(4 * jj + 2 * i + e) : kAttnNegInf);
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
        const float x = exp2f((score(4 * jj + 2 * i + e) - mx) * kLog2e);
        const float v = ok ? x : 0.f;
        p[4 * jj + 2 * i + e] = v;
        sum += v;
      }
    }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = mx;
  }
  if constexpr (P::kPlanes3) {
#pragma unroll
    for (int e = 0; e < 32; ++e) pf[e] = p[e] * P::kSplitScale;
  } else if constexpr (VPasses == 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pn.f[0][kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1], pn.f[0][kk][r], pn.f[1][kk][r]);
      }
    }
  }
}

// the same, choosing the unmasked form where every key of the tile is valid
template <int SPasses, int VPasses>
__device__ __forceinline__ void softmax_tile(const float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], PPlanes& pn, float (&pf)[32],
                                             int key0, int len, int c) {
  if (key0 + kAttnRows <= len) {
    softmax_tile<true, SPasses, VPasses>(s, m, l, alpha, pn, pf, key0, len, c);
  } else {
    softmax_tile<false, SPasses, VPasses>(s, m, l, alpha, pn, pf, key0, len, c);
  }
}

// A hook that does nothing (attend_tiles' `begin` or `issued`)
struct NoHook {
  __device__ __forceinline__ void operator()(int) const {}
};

// The key loop of the consumer warpgroup over `tiles` key tiles (keys
// 64t .. 64t + 63 of tile t, those >= len masked), Q's planes' descriptors
// dq (issue_scores; at(t) then a KeyTile, KeyTileHL or KeyTile3 as the
// flavour's planes): acc (O, acc[4j + 2i + e] row 16 warp + lane / 4 + 8i,
// d 8j + 2 (lane % 4) + e; with three planes of P, times kSplitScale and
// V's own scale), m and l (this thread's share of each row's sum) carried
// in and out. The caller supplies where tile t lies and when it may be
// read:
//   at(t)      the tile in shared memory;
//   wait(t)    returns once tile t may be read by wgmma (called in order);
//   begin(t)   at the start of iteration t (t + 1 is waited on next);
//   issued(t)  once iteration t's products are issued (in flight);
//   release(t) once nothing reads tile t any more (its P . V complete).
template <int SPasses, int VPasses, class At, class Wait, class Begin, class Issued,
          class Release>
__device__ __forceinline__ void attend_tiles(float (&acc)[32], float (&m)[2], float (&l)[2],
                                             const uint64_t (&dq)[3], int tiles, int len, At at,
                                             Wait wait, Begin begin, Issued issued,
                                             Release release) {
  using P = AttnPasses<SPasses, VPasses>;
  constexpr int kPPlanes = P::kPlanes3 ? 3 : VPasses == 1 ? 1 : 2;
  const int c = threadIdx.x & 3;
  float alpha[2];
  float s[32] = {};  // written by wgmma alone from here on
  PPlanes pa, pn;  // P of the tile in P . V, of the next one (but for three planes)
  float pf[32] = {};    // three planes: the next tile's P, scaled, before its split
  float part[32] = {};  // three planes: a tile's P . V, written by wgmma alone
  if (tiles > 0) {
    wait(0);
    issue_scores<SPasses>(s, dq, at(0));
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<SPasses, VPasses>(s, m, l, alpha, pn, pf, 0, len, c);
  }
  for (int tile = 0; tile < tiles; ++tile) {
    // here: P of `tile` in pn (pf), O rescaled to its maximum
    const bool next = tile + 1 < tiles;
    begin(tile);
    if constexpr (!P::kPlanes3) {
#pragma unroll
      for (int n = 0; n < kPPlanes; ++n) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // read by P . V until it completes
#pragma unroll
          for (int r = 0; r < 4; ++r) pa.f[n][kk][r] = pn.f[n][kk][r];
        }
      }
    }
    if (next && !P::kSerial) {
      wait(tile + 1);
      issue_scores<SPasses>(s, dq, at(tile + 1));
    }
    if constexpr (P::kPlanes3) {  // the split runs while any scores are in flight
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split3_bf16(pf[8 * kk + 2 * r], pf[8 * kk + 2 * r + 1], pa.f[0][kk][r], pa.f[1][kk][r],
                      pa.f[2][kk][r]);
        }
      }
    }
    issue_values<SPasses, VPasses>(acc, part, pa, at(tile));
    issued(tile);
    if constexpr (P::kSerial) {
      wgmma_wait<0>();  // P . V of tile
    } else {
      wgmma_wait<1>();  // the scores of tile + 1; P . V of tile still in flight
      fence_regs(s);
      if (next) softmax_tile<SPasses, VPasses>(s, m, l, alpha, pn, pf, (tile + 1) * kAttnRows, len, c);
      wgmma_wait<0>();
    }
    if constexpr (P::kPlanes3) {
      fence_regs(part);
      fence_planes<kPPlanes>(pa);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
    } else {
      fence_regs(acc);
      fence_planes<kPPlanes>(pa);
    }
    if constexpr (P::kSerial) {
      if (next) {  // the scores of tile + 1 and their softmax
        wait(tile + 1);
        issue_scores<SPasses>(s, dq, at(tile + 1));
        wgmma_wait<0>();
        fence_regs(s);
        softmax_tile<SPasses, VPasses>(s, m, l, alpha, pn, pf, (tile + 1) * kAttnRows, len, c);
      }
    }
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
