// The key loop shared by K1 (flash_attention.cu) and K4
// (fused_attention.cu): masked online-softmax attention of a tile of 64
// query rows against the first `len` keys of one (batch, head), head width
// 64, float32, on a block of 4 warps.
//
// A register-tiled SIMT attention tile. Each warp owns 16 query rows; each
// thread owns 4 of them (rows w*16 + lane/8 + 4i) and, of every 32-key
// tile, the keys lane%8 + 8j: it computes a 4 x 4 block of S = Q.K^T from
// shared-memory Q and K (8 16-byte loads per 64 FMAs), and a 4 x 8 block of
// O += P.V (output columns 4*(lane%8) and 32 + 4*(lane%8); 12 loads per 128
// FMAs). The row max and row sum of the online softmax combine across the
// 8 lanes of a row by xor shuffles; P passes to P.V through a per-warp slice
// of shared memory (__syncwarp, no block barrier). The caller's `stage`
// fills tile j + 1 while tile j computes: K1 with cp.async from device
// memory, K4 from its cluster's shared memory. expf, not __expf, to stay
// within f32 rounding of the plain versions; no tensor cores ("exact").
//
// The loop stops at `len`, so masked keys are never read: a NaN in a
// padded row of k or v cannot reach a valid row. Inside the last tile the
// keys past the bound are zero-filled in shared memory by `stage` and get
// weight 0 by select (score -1e30, p = 0), never by multiplying a loaded
// value.

#pragma once

#include <cuda_runtime.h>

namespace nomad {

constexpr int kD = 64;         // head width
constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // query rows per tile: 16 per warp, 4 per thread
constexpr int kBK = 32;        // keys per shared-memory tile
constexpr int kLd = kD + 4;    // row stride of Q, K and V tiles in floats (no bank conflict)
constexpr int kKT = kBK / 8;   // keys of a tile per thread
constexpr int kLdP = kBK + 8;  // row stride of the P slice
constexpr float kNegInf = -1e30f;

// Double-buffered K/V tiles and the P slices, in the caller's shared memory.
struct KeyTiles {
  float k[2][kBK][kLd];
  float v[2][kBK][kLd];
  float p[kBQ][kLdP];
};

// One thread's share of the tile: 4 rows x 8 output columns, and each row's
// running maximum and sum (equal on the 8 lanes of a row).
struct RowState {
  float acc[4][8];
  float m[4];
  float l[4];
};

// Row i of the calling thread within the 64-row tile, and its first output
// column (the second is col0 + 32).
__device__ __forceinline__ int tile_row(int i) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 3) + 4 * i;
}
__device__ __forceinline__ int tile_col0() { return 4 * (threadIdx.x & 7); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Accumulates st over keys [0, len) for the 64 rows of qs ([kBQ][kLd],
// pre-scaled by 1/sqrt(D), visible to the block after the loop's first
// barrier). stage(j, k, v) fills keys j*kBK .. j*kBK + kBK - 1 of the K and V
// tiles k, v ([kBK][kLd]), zeros past len, with plain stores or cp.async
// (committed here). Every thread of the block calls it with the same len;
// a warp with `active` false only loads and waits (its rows belong to no
// output), which keeps the barriers whole.
template <class Stage>
__device__ __forceinline__ void attend_keys(const float* __restrict__ qs, int len, bool active,
                                            Stage&& stage, KeyTiles& kt, RowState& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) st.acc[i][c] = 0.f;
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
  }
  const int tiles = (len + kBK - 1) / kBK;
  if (tiles == 0) return;
  const int tx = threadIdx.x & 7;
  const int c0 = tile_col0();
  stage(0, kt.k[0], kt.v[0]);
  cp_async_commit();
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) stage(j + 1, kt.k[(j + 1) & 1], kt.v[(j + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    if (active) {
      const float(*ks)[kLd] = kt.k[j & 1];
      const float(*vs)[kLd] = kt.v[j & 1];
      const int n = min(kBK, len - j * kBK);
      float s[4][kKT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < kKT; ++jj) s[i][jj] = 0.f;
      }
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + tile_row(i) * kLd + d);
#pragma unroll
        for (int jj = 0; jj < kKT; ++jj) {
          const float4 b = *reinterpret_cast<const float4*>(&ks[tx + 8 * jj][d]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][jj] = fmaf(a[i].x, b.x, s[i][jj]);
            s[i][jj] = fmaf(a[i].y, b.y, s[i][jj]);
            s[i][jj] = fmaf(a[i].z, b.z, s[i][jj]);
            s[i][jj] = fmaf(a[i].w, b.w, s[i][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = st.m[i];
#pragma unroll
        for (int jj = 0; jj < kKT; ++jj) {
          s[i][jj] = tx + 8 * jj < n ? s[i][jj] : kNegInf;
          mx = fmaxf(mx, s[i][jj]);
        }
        mx = row_max8(mx);
        const float alpha = expf(st.m[i] - mx);
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kKT; ++jj) {
          s[i][jj] = tx + 8 * jj < n ? expf(s[i][jj] - mx) : 0.f;
          sum += s[i][jj];
          kt.p[tile_row(i)][tx + 8 * jj] = s[i][jj];
        }
        st.l[i] = st.l[i] * alpha + row_sum8(sum);
        st.m[i] = mx;
#pragma unroll
        for (int c = 0; c < 8; ++c) st.acc[i][c] *= alpha;
      }
      __syncwarp();  // the warp's P rows are written
#pragma unroll 2
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(&kt.p[tile_row(i)][kk]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v0 = *reinterpret_cast<const float4*>(&vs[kk + u][c0]);
          const float4 v1 = *reinterpret_cast<const float4*>(&vs[kk + u][c0 + 32]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
            st.acc[i][0] = fmaf(pu, v0.x, st.acc[i][0]);
            st.acc[i][1] = fmaf(pu, v0.y, st.acc[i][1]);
            st.acc[i][2] = fmaf(pu, v0.z, st.acc[i][2]);
            st.acc[i][3] = fmaf(pu, v0.w, st.acc[i][3]);
            st.acc[i][4] = fmaf(pu, v1.x, st.acc[i][4]);
            st.acc[i][5] = fmaf(pu, v1.y, st.acc[i][5]);
            st.acc[i][6] = fmaf(pu, v1.z, st.acc[i][6]);
            st.acc[i][7] = fmaf(pu, v1.w, st.acc[i][7]);
          }
        }
      }
    }
    __syncthreads();  // tile j's buffers and the P slices are free again
  }
}

// Writes the 4 x 8 share of O (normalised by 1/l; 0 for a row with no
// valid key) for the rows r < rows of the tile: row r goes to out(r), a
// float pointer to its 64 outputs, 16-byte aligned.
template <class Out>
__device__ __forceinline__ void write_rows(const RowState& st, int rows, Out&& out) {
  const int c0 = tile_col0();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tile_row(i);
    if (r >= rows) continue;
    const float inv = st.l[i] > 0.f ? 1.f / st.l[i] : 0.f;
    float* op = out(r);
    const float* a = st.acc[i];
    *reinterpret_cast<float4*>(op + c0) = make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
    *reinterpret_cast<float4*>(op + c0 + 32) =
        make_float4(a[4] * inv, a[5] * inv, a[6] * inv, a[7] * inv);
  }
}

}  // namespace nomad
