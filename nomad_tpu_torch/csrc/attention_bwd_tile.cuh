// The backward tile shared by K2 (dQ) and K3 (dK, dV) in
// flash_attention_bwd.cu: head width 64, float32, a block of 4 warps.
//
// A block holds 16 * RT rows of two operands in shared memory (K2: Q
// pre-scaled by 1/sqrt(D) and dO; K3: K pre-scaled and V) and streams
// 32-row tiles of the other two (K2: K and V; K3: Q and dO). Each warp owns
// 4 * RT of the resident rows; each thread owns RT of them (rows
// warp * 4 * RT + lane / 8 + 4 i) and, of every streamed tile, the rows
// lane % 8 + 8 j, j < 4, as K1's tile does (attention_tile.cuh):
//   * dot_block forms an RT x 4 block of S (or of dP) from a resident
//     operand and a streamed one (8 16-byte loads per 64 FMAs at RT = 4);
//   * the caller turns them into P = exp(S - LSE) and dS = P o (dP - Di)
//     and writes them into its warp's rows of a shared slice, then
//     __syncwarp() (no block barrier);
//   * accumulate adds slice . tile into an RT x 8 block of the output
//     (columns 4 (lane % 8) and 32 + 4 (lane % 8); 12 loads per 128 FMAs).
// K3's tile is K2's with rows and columns swapped: rows are keys, the
// streamed tile's rows are queries, and the slice holds P^T, then dS^T.
// f32 FMA only ("exact": no TF32, no tensor cores).

#pragma once

#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace nomad {

// Row strides (floats) of the resident rows and of the P/dS slices. A warp
// reads 4 rows of either at one column (the 8 lanes of a row at one
// address), which shared memory serves in one pass only when the 4 rows'
// words lie in different banks. The slice does that with 4 spare words a
// row (its stores 2-way conflicted). The resident rows stay unpadded and
// swizzle their 16-byte chunks instead: chunk c of row r lives at chunk
// c ^ (r & 3) (resident_col), which saves 2 KB a block for one XOR a load
// and brings both kernels' 64-row blocks to 76,800 B, 3 to an SM.
constexpr int kLdR = kD;
constexpr int kLdS = kBK + 4;

// Float offset of column d (a multiple of 4) of resident row r.
__device__ __forceinline__ int resident_col(int r, int d) { return d ^ (4 * (r & 3)); }

// Row i of the calling thread within a block of 16 * RT rows; for RT = 4
// this is tile_row(i).
template <int RT>
__device__ __forceinline__ int bwd_row(int i) {
  return (threadIdx.x >> 5) * (4 * RT) + ((threadIdx.x & 31) >> 3) + 4 * i;
}

// A 4-byte cp.async (the LSE and Di rows, which need not be 16-byte
// aligned); src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

// The S/dP part of both kernels: out[i][j] = rows[bwd_row(i)] . cols[tx + 8 j]
// over the 64 columns; rows is [16 * RT][kLdR] (swizzled), cols [kBK][kLd].
template <int RT>
__device__ __forceinline__ void dot_block(const float* __restrict__ rows,
                                          const float (*__restrict__ cols)[kLd],
                                          float (&out)[RT][kKT]) {
  const int tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < kKT; ++j) out[i][j] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 a[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = bwd_row<RT>(i);
      a[i] = *reinterpret_cast<const float4*>(rows + r * kLdR + resident_col(r, d));
    }
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const float4 c = *reinterpret_cast<const float4*>(&cols[tx + 8 * j][d]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        out[i][j] = fmaf(a[i].x, c.x, out[i][j]);
        out[i][j] = fmaf(a[i].y, c.y, out[i][j]);
        out[i][j] = fmaf(a[i].z, c.z, out[i][j]);
        out[i][j] = fmaf(a[i].w, c.w, out[i][j]);
      }
    }
  }
}

// acc[i][0..3] += w[bwd_row(i)] . x[:, c0 .. c0 + 3] and acc[i][4..7] the
// same at c0 + 32, over the kBK columns of the slice w ([16 * RT][kLdS])
// and the rows of the tile x ([kBK][kLd]). The caller's __syncwarp()
// after writing w also keeps ptxas from holding the tile's words in
// registers from dot_block to here (which spills).
template <int RT>
__device__ __forceinline__ void accumulate(const float (*__restrict__ w)[kLdS],
                                           const float (*__restrict__ x)[kLd],
                                           float (&acc)[RT][8]) {
  const int c0 = tile_col0();
#pragma unroll 2
  for (int kk = 0; kk < kBK; kk += 4) {
    float4 p[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) p[i] = *reinterpret_cast<const float4*>(&w[bwd_row<RT>(i)][kk]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x0 = *reinterpret_cast<const float4*>(&x[kk + u][c0]);
      const float4 x1 = *reinterpret_cast<const float4*>(&x[kk + u][c0 + 32]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
        acc[i][0] = fmaf(pu, x0.x, acc[i][0]);
        acc[i][1] = fmaf(pu, x0.y, acc[i][1]);
        acc[i][2] = fmaf(pu, x0.z, acc[i][2]);
        acc[i][3] = fmaf(pu, x0.w, acc[i][3]);
        acc[i][4] = fmaf(pu, x1.x, acc[i][4]);
        acc[i][5] = fmaf(pu, x1.y, acc[i][5]);
        acc[i][6] = fmaf(pu, x1.z, acc[i][6]);
        acc[i][7] = fmaf(pu, x1.w, acc[i][7]);
      }
    }
  }
}

}  // namespace nomad
