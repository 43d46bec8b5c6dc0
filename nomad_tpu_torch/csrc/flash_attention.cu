// Masked multi-head attention forward, float32, head width 64 (kernel K1).
//
// Replaces nomad_tpu/ops/flash_attention.py::_flash_kernel (launched by
// _flash_folded, entered through mha_pallas): per (batch, head) the scores
// (q / sqrt(D)) . k over the first lengths[b] keys, softmax, times v; writes
// O and LSE = m + log(l), the log-sum-exp the backward kernels will need.
//
// What bounds it on an H100: operations. At the main-path shape
// (B=96, T=511, H=12, D=64) it does 4*B*H*T^2*D = 77 GFLOP against 603 MB
// of q/k/v/o traffic; in f32 without tensor cores ("exact" forbids TF32)
// that is 1.15 ms at 67 TFLOP/s against 0.18 ms of memory time.
//
// Design, for that bound:
//   * q, k, v are read in place through their [B, T, H, D] strides (the TPU
//     kernel needed a fold/pad copy to [B*H, T_pad, D] first, which cost it
//     its in-model lead); O is written [B, T, H, D], LSE [B, H, T].
//   * One block per (128-query tile, head, batch); one thread per query row,
//     whose q (pre-scaled by 1/sqrt(D)) and output accumulator stay in
//     registers. K and V pass through shared memory in 64-key tiles; every
//     lane of a warp reads the same key row, so each 16-byte shared load is
//     a broadcast that feeds 4 FMAs, and no [T, T] score tile exists at all.
//   * Online softmax in steps of 16 keys: one rescale of the accumulator per
//     step, not per key. expf/logf, not the fast intrinsics, to stay within
//     f32 rounding of the plain version.
//   * The key loop stops at lengths[b], so masked keys are never read: a
//     NaN in a padded row of k or v cannot reach a valid row. Inside the
//     last tile the keys past the bound are zero-filled in shared memory and
//     get weight 0 by select (score -1e30), never by multiplying a loaded
//     value. The same loop covers T = 511 and T = 4095.
//   * Every query row t < T is written, finite, padded rows included (they
//     attend over the valid keys like any row). A row with no valid key
//     (lengths[b] == 0) gets O = 0 and LSE = -1e30.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;       // head width
constexpr int kD4 = kD / 4;  // float4 words per row
constexpr int kBQ = 128;     // query rows per block (one per thread)
constexpr int kBK = 64;      // keys per shared-memory tile
constexpr int kCH = 16;      // keys per online-softmax step
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ o, float* __restrict__ lse, int T, int H,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh,
                 long long svb, long long svt, long long svh,
                 long long sob, long long sot, long long soh, float scale) {
  __shared__ float4 ks[kBK][kD4];
  __shared__ float4 vs[kBK][kD4];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t = blockIdx.x * kBQ + threadIdx.x;
  const int len = min(max(lengths[b], 0), T);

  float4 qr[kD4];
  float4 acc[kD4];
  if (t < T) {
    const float4* qp = reinterpret_cast<const float4*>(q + b * sqb + t * sqt + h * sqh);
#pragma unroll
    for (int i = 0; i < kD4; ++i) {
      const float4 a = qp[i];
      qr[i] = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kD4; ++i) qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kD4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf;
  float l = 0.f;

  const float* kbase = k + b * skb + h * skh;
  const float* vbase = v + b * svb + h * svh;
  for (int k0 = 0; k0 < len; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBK * kD4; idx += kBQ) {
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

  if (t < T) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float4* op = reinterpret_cast<float4*>(o + b * sob + t * sot + h * soh);
#pragma unroll
    for (int i = 0; i < kD4; ++i) {
      op[i] = make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
    }
    lse[(static_cast<long long>(b) * H + h) * T + t] = l > 0.f ? m + logf(l) : kNegInf;
  }
}

}  // namespace

// q, k, v, o: [B, T, H, 64] f32 with unit stride on the last axis and the
// other strides (in elements) multiples of 4, 16-byte aligned; lengths:
// int32 [B]; lse: f32 [B, H, T] contiguous. Returns cudaGetLastError().
extern "C" int nomad_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* lse, int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh, float scale, void* stream) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kBQ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(o), static_cast<float*>(lse), T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
