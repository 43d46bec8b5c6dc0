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
// that is 1.15 ms at 67 TFLOP/s against 0.18 ms of memory time. So the
// FMA pipes must be kept busy: operands from shared memory must feed many
// FMAs each, and loads must not stall them.
//
// Design, for that bound:
//   * q, k, v are read in place through their [B, T, H, D] strides (the TPU
//     kernel needed a fold/pad copy to [B*H, T_pad, D] first, which cost it
//     its in-model lead); O is written [B, T, H, D], LSE [B, H, T].
//   * One block of 4 warps per (64-query tile, head, batch). The query
//     tile (pre-scaled by 1/sqrt(D)) sits in shared memory, and the key
//     loop of attention_tile.cuh (shared with K4) runs register-tiled: each
//     thread computes 4 x 4 scores and 4 x 8 outputs per 32-key tile, with
//     the softmax's row max and sum combined by shuffles. An earlier design
//     gave each thread one query row in registers (242 registers, 2 blocks
//     per SM, 4 FMAs per shared load): it reached a third of the bound.
//   * K and V tiles are double-buffered with cp.async: tile j + 1 loads
//     while tile j computes; keys past lengths[b] are zero-filled by the
//     copy (source size 0), never read.
//   * The key loop stops at lengths[b], so masked keys are never read: a
//     NaN in a padded row of k or v cannot reach a valid row. The same loop
//     covers T = 50, 511 and 4095. logf, not the fast intrinsic, for LSE.
//   * Every query row t < T is written, finite, padded rows included (they
//     attend over the valid keys like any row). A row with no valid key
//     (lengths[b] == 0) gets O = 0 and LSE = -1e30.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using nomad::kBK;
using nomad::kBQ;
using nomad::kD;
using nomad::kLd;
using nomad::kNegInf;
using nomad::kThreads;

struct Smem {
  float q[kBQ][kLd];
  nomad::KeyTiles kt;
};
constexpr int kSmemBytes = sizeof(Smem);
constexpr int kMinBlocks = 3;  // per SM: 3 x 62,464 bytes of shared memory

__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ o, float* __restrict__ lse, int T, int H,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh,
                 long long svb, long long svt, long long svh,
                 long long sob, long long sot, long long soh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int len = min(max(lengths[b], 0), T);
  const int tid = threadIdx.x;

  // the query tile, scaled; rows past T are 0 and never written
  for (int idx = tid; idx < kBQ * (kD / 4); idx += kThreads) {
    const int r = idx / (kD / 4);
    const int c = idx % (kD / 4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) {
      a = reinterpret_cast<const float4*>(q + b * sqb + (q0 + r) * sqt + h * sqh)[c];
      a = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    }
    *reinterpret_cast<float4*>(&sm.q[r][4 * c]) = a;
  }

  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  auto stage = [&](int j, float (*ks)[kLd], float (*vs)[kLd]) {
#pragma unroll
    for (int e = 0; e < kBK * (kD / 4) / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / (kD / 4);
      const int c = idx % (kD / 4);
      const int key = j * kBK + r;
      const bool ok = key < len;
      nomad::cp_async16(&ks[r][4 * c], ok ? kb + key * skt + 4 * c : kb, ok ? 16 : 0);
      nomad::cp_async16(&vs[r][4 * c], ok ? vb + key * svt + 4 * c : vb, ok ? 16 : 0);
    }
  };
  nomad::RowState st;
  nomad::attend_keys(&sm.q[0][0], len, q0 + (tid >> 5) * 16 < T, stage, sm.kt, st);

  nomad::write_rows(st, T - q0, [&](int r) { return o + b * sob + (q0 + r) * sot + h * soh; });
  if ((tid & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + nomad::tile_row(i);
      if (t < T) {
        lse[(static_cast<long long>(b) * H + h) * T + t] =
            st.l[i] > 0.f ? st.m[i] + logf(st.l[i]) : kNegInf;
      }
    }
  }
}

cudaError_t configure() {  // dynamic shared memory above 48 KB, once
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

}  // namespace

// q, k, v, o: [B, T, H, 64] f32 with unit stride on the last axis and the
// other strides (in elements) multiples of 4, 16-byte aligned; lengths:
// int32 [B]; lse: f32 [B, H, T] contiguous. smem_bytes: the wrapper's plan
// (ops/flash_attention.py::flash_launch_plan), checked against the
// kernel's. Returns cudaGetLastError().
extern "C" int nomad_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* lse, int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh, float scale, int smem_bytes, void* stream) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535 ||
      smem_bytes != kSmemBytes) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(o), static_cast<float*>(lse), T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of K1 per SM at its shared memory (0 if it cannot run).
extern "C" int nomad_flash_attention_fwd_occupancy(int* blocks_per_sm) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_kernel, kThreads,
                                                      kSmemBytes);
  return static_cast<int>(err);
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
