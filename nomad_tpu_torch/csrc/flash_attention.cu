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
//     registers, through the key loop of attention_tile.cuh (shared with
//     K4): K and V in 64-key shared-memory tiles read as broadcasts, an
//     online softmax in steps of 16 keys, no [T, T] score tile.
//   * The key loop stops at lengths[b], so masked keys are never read: a
//     NaN in a padded row of k or v cannot reach a valid row. The same loop
//     covers T = 511 and T = 4095. logf, not the fast intrinsic, for LSE.
//   * Every query row t < T is written, finite, padded rows included (they
//     attend over the valid keys like any row). A row with no valid key
//     (lengths[b] == 0) gets O = 0 and LSE = -1e30.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using nomad::kBK;
using nomad::kD;
using nomad::kD4;
using nomad::kNegInf;
constexpr int kBQ = 128;  // query rows per block (one per thread)

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

  nomad::attend_keys<kBQ>(qr, acc, m, l, k + b * skb + h * skh, skt,
                          v + b * svb + h * svh, svt, len, ks, vs);

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
