// The key loop shared by K1 (flash_attention.cu) and K4
// (fused_attention.cu): masked online-softmax attention of one query row
// per thread against the first `len` keys of one (batch, head), head
// width 64, float32.
//
// Each thread holds its query row q (pre-scaled by 1/sqrt(D)) and its
// output accumulator in registers. K and V pass through shared memory in
// 64-key tiles, loaded by all threads of the block; every lane of a warp
// reads the same key row, so each 16-byte shared load is a broadcast that
// feeds 4 FMAs, and no [T, T] score tile exists. The softmax advances in
// steps of 16 keys: one rescale of the accumulator per step, not per key.
// expf, not __expf, to stay within f32 rounding of the plain versions.
//
// The loop stops at `len`, so masked keys are never read: a NaN in a
// padded row of k or v cannot reach a valid row. Inside the last tile the
// keys past the bound are zero-filled in shared memory and get weight 0
// by select (score -1e30), never by multiplying a loaded value.

#pragma once

#include <cuda_runtime.h>

namespace nomad {

constexpr int kD = 64;       // head width
constexpr int kD4 = kD / 4;  // float4 words per row
constexpr int kBK = 64;      // keys per shared-memory tile
constexpr int kCH = 16;      // keys per online-softmax step
constexpr float kNegInf = -1e30f;

// Accumulates the unnormalised output `acc`, the running maximum `m` and
// the running sum `l` of one query row over keys [0, len): key j's row is
// kbase + j * skt (and vbase + j * svt), 16-byte aligned. Every one of the
// block's kThreads threads must call it with the same len (it holds
// __syncthreads); ks and vs are kBK x kD4 float4 words of shared memory.
template <int kThreads>
__device__ __forceinline__ void attend_keys(const float4 (&qr)[kD4], float4 (&acc)[kD4],
                                            float& m, float& l, const float* kbase,
                                            long long skt, const float* vbase,
                                            long long svt, int len, float4 (*ks)[kD4],
                                            float4 (*vs)[kD4]) {
  for (int k0 = 0; k0 < len; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBK * kD4; idx += kThreads) {
      const int r = idx / kD4;
      const int c = idx % kD4;
      const int key = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (key < len) {
        kv = reinterpret_cast<const float4*>(kbase + key * skt)[c];
        vv = reinterpret_cast<const float4*>(vbase + key * svt)[c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    const int n = min(kBK, len - k0);
    for (int j0 = 0; j0 < n; j0 += kCH) {
      float s[kCH];
#pragma unroll
      for (int j = 0; j < kCH; ++j) s[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kD4; ++i) {
        const float4 a = qr[i];
#pragma unroll
        for (int j = 0; j < kCH; ++j) {
          const float4 kk = ks[j0 + j][i];
          s[j] = fmaf(a.x, kk.x, s[j]);
          s[j] = fmaf(a.y, kk.y, s[j]);
          s[j] = fmaf(a.z, kk.z, s[j]);
          s[j] = fmaf(a.w, kk.w, s[j]);
        }
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        s[j] = j0 + j < n ? s[j] : kNegInf;
        m_new = fmaxf(m_new, s[j]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kD4; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        s[j] = j0 + j < n ? expf(s[j] - m_new) : 0.f;
        l += s[j];
      }
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const float p = s[j];
#pragma unroll
        for (int i = 0; i < kD4; ++i) {
          const float4 vv = vs[j0 + j][i];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
      m = m_new;
    }
  }
}

}  // namespace nomad
