// Projection-fused masked multi-head attention, float32, head width 64
// (kernel K4).
//
// Replaces nomad_tpu/ops/fused_attention.py::_fused_kernel (launched by
// _fused_call, entered through fused_qkv_attention): for each (batch b,
// head h) the head's projections Q = (x Wq_h^T + bq_h) / sqrt(D), K and V
// likewise, then masked softmax attention of every query row over the
// keys t < lengths[b]; O is written per head. The out-projection stays
// outside, one matrix product, as in the JAX package.
//
// What bounds it on an H100: operations. At the scoring shape (B = 96,
// T = 511, 499 keys valid, H = 12, model width 768) it does 246 GFLOP
// (Q for every row 57.9, K and V for the valid rows 113.0, attention
// 75.2) against 308 MB of x, weights and O: 3.7 ms at 67 TFLOP/s in f32
// without tensor cores ("exact" forbids TF32) against 0.09 ms of memory
// time.
//
// Design, for the card rather than the TPU:
//   * The TPU kernel ran its q-block grid axis in order and built K_h and
//     V_h into VMEM scratch at q-block 0 for the later q-blocks to reuse.
//     Blocks on the card run in no order, and K_h alone is 256 KB at
//     T = 1024, more than a block's 227 KB of shared memory. So one block
//     per (head, batch) runs both phases itself, a loop taking the place
//     of the sequential axis, and K_h/V_h live in a workspace in device
//     memory that the wrapper allocates ([3, B, H, T, 64]: Q, K, V).
//   * Phase 1 projects, 64 rows of x at a time, Q for every row and K and
//     V for the chunks that hold a valid key (rows of such a chunk past
//     the bound are projected and never read). A shared-memory-tiled f32
//     GEMM: 32-wide slices of the model axis of x (64 rows) and of the
//     head's weight rows (64 per tensor) are staged row-major with a
//     padded stride, so the float4 stores and the float4 reads along the
//     model axis meet no bank conflict; each thread keeps 8 rows x 12
//     columns (4 of each tensor) in registers, 20 16-byte shared loads per
//     384 FMAs. In nn.Linear's [out, in] layout the head's weights are
//     rows h*64 .. h*64+63, contiguous: no per-call transpose.
//   * Phase 2 starts after __syncthreads, which orders the block's global
//     writes for the block; it reads back only its own slice of the
//     workspace, which it has just written (mostly from the 50 MB L2).
//     For each 128-query tile it runs K1's key loop (attention_tile.cuh):
//     one thread per query row, an online softmax stopping at lengths[b].
//     The JAX kernel's single pass over all keys is the same function;
//     only the rounding differs.
//   * Every query row t < T is written, finite, padded rows included: the
//     loop covers T with no divisibility rule, so no tail is left out (the
//     JAX package once left rows >= 512 uncomputed). A row with no valid
//     key gets O = 0. Keys past the bound never enter the softmax, so
//     garbage in padded rows of x changes no valid row. No atomics: the
//     results are deterministic.
//   * Registers: the key loop holds q and the accumulator (128 floats) and
//     the GEMM 96 accumulators plus 80 operands; the two phases do not
//     overlap, so the kernel needs what K1 needs.
// Later redesign: keep K_h/V_h on chip (a cluster of 8 blocks reaches
// ~1.8 MB of shared memory as distributed shared memory, enough for both
// at T = 1024), then wgmma once a precision mode allows TF32 or bf16.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

using nomad::kBK;
using nomad::kD;
using nomad::kD4;
using nomad::kNegInf;
constexpr int kThreads = 128;  // threads per block; phase 2: one per query row
constexpr int kRows = 64;      // rows of x per phase-1 chunk
constexpr int kSlice = 32;     // model-axis floats per phase-1 step
constexpr int kLd = kSlice + 4;  // shared row stride in floats
constexpr int kMaxT = 1024;

struct ProjSmem {
  float x[kRows][kLd];
  float w[3 * kD][kLd];
};
struct AttnSmem {
  float4 ks[kBK][kD4];
  float4 vs[kBK][kD4];
};
union Smem {
  ProjSmem proj;
  AttnSmem attn;
};

// Rows r0 .. r0+63 of xb ([T, DM], row-major) times the head's 64 rows of
// the first NT of w (each [DM_out, DM]), plus the bias; tensor 0 (Q) is
// scaled. Writes rows < T of out[g] ([T, 64]). Every thread of the block
// calls it with the same r0.
template <int NT>
__device__ __forceinline__ void project_chunk(const float* __restrict__ xb,
                                              const float* const (&w)[3],
                                              const float* const (&bias)[3],
                                              float* const (&out)[3], int r0, int T,
                                              int DM, int h, float scale, ProjSmem& sm) {
  const int tx = threadIdx.x % 16;  // columns tx + 16 j of each tensor
  const int ty = threadIdx.x / 16;  // rows r0 + ty + 8 i
  float acc[8][NT * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int n = 0; n < NT * 4; ++n) acc[i][n] = 0.f;
  }

  for (int k0 = 0; k0 < DM; k0 += kSlice) {
    __syncthreads();  // the previous slice is no longer read
    for (int idx = threadIdx.x; idx < kRows * (kSlice / 4); idx += kThreads) {
      const int row = idx / (kSlice / 4);
      const int c = idx % (kSlice / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + row < T) {
        val = *reinterpret_cast<const float4*>(xb + static_cast<long long>(r0 + row) * DM +
                                               k0 + 4 * c);
      }
      *reinterpret_cast<float4*>(&sm.x[row][4 * c]) = val;
    }
#pragma unroll
    for (int g = 0; g < NT; ++g) {  // unrolled: w[g] is indexed statically, never spilled
      for (int idx = threadIdx.x; idx < kD * (kSlice / 4); idx += kThreads) {
        const int row = idx / (kSlice / 4);
        const int c = idx % (kSlice / 4);
        *reinterpret_cast<float4*>(&sm.w[g * kD + row][4 * c]) =
            *reinterpret_cast<const float4*>(
                w[g] + static_cast<long long>(h * kD + row) * DM + k0 + 4 * c);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kSlice; kk += 4) {
      float4 a[8];
      float4 bw[NT * 4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(&sm.x[ty + 8 * i][kk]);
#pragma unroll
      for (int n = 0; n < NT * 4; ++n) {
        bw[n] = *reinterpret_cast<const float4*>(&sm.w[(n / 4) * kD + tx + 16 * (n % 4)][kk]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int n = 0; n < NT * 4; ++n) {
          acc[i][n] = fmaf(a[i].x, bw[n].x, acc[i][n]);
          acc[i][n] = fmaf(a[i].y, bw[n].y, acc[i][n]);
          acc[i][n] = fmaf(a[i].z, bw[n].z, acc[i][n]);
          acc[i][n] = fmaf(a[i].w, bw[n].w, acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NT * 4; ++n) {
    const int g = n / 4;
    const int col = tx + 16 * (n % 4);
    const float bb = bias[g][h * kD + col];
    const float s = g == 0 ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + ty + 8 * i;
      if (row < T) out[g][static_cast<long long>(row) * kD + col] = (acc[i][n] + bb) * s;
    }
  }
}

// ws is written and read back in one launch, so it is not __restrict__:
// no read of it may go through the non-coherent read-only cache.
__global__ void __launch_bounds__(kThreads)
fused_qkv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                     const float* __restrict__ bq, const float* __restrict__ wk,
                     const float* __restrict__ bk, const float* __restrict__ wv,
                     const float* __restrict__ bv, const int* __restrict__ lengths,
                     float* ws, float* __restrict__ o, int B, int T, int H,
                     int DM, long long sob, long long sot, long long soh, float scale) {
  __shared__ Smem sm;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(max(lengths[b], 0), T);
  const long long plane = static_cast<long long>(T) * kD;  // one (batch, head) slice
  float* qw = ws + (static_cast<long long>(b) * H + h) * plane;
  float* kw = qw + static_cast<long long>(B) * H * plane;
  float* vw = kw + static_cast<long long>(B) * H * plane;
  const float* xb = x + static_cast<long long>(b) * T * DM;
  const float* const w[3] = {wq, wk, wv};
  const float* const bias[3] = {bq, bk, bv};
  float* const out[3] = {qw, kw, vw};

  // phase 1: Q for every row, K and V for the chunks holding a valid key
  for (int r0 = 0; r0 < T; r0 += kRows) {
    if (r0 < len) {
      project_chunk<3>(xb, w, bias, out, r0, T, DM, h, scale, sm.proj);
    } else {
      project_chunk<1>(xb, w, bias, out, r0, T, DM, h, scale, sm.proj);
    }
  }
  __syncthreads();  // the workspace rows written above are visible to the block

  // phase 2: K1's key loop for each 128-query tile
  for (int q0 = 0; q0 < T; q0 += kThreads) {
    const int t = q0 + threadIdx.x;
    float4 qr[kD4];
    float4 acc[kD4];
    if (t < T) {
      const float4* qp = reinterpret_cast<const float4*>(qw + static_cast<long long>(t) * kD);
#pragma unroll
      for (int i = 0; i < kD4; ++i) qr[i] = qp[i];
    } else {
#pragma unroll
      for (int i = 0; i < kD4; ++i) qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kD4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = kNegInf;
    float l = 0.f;

    nomad::attend_keys<kThreads>(qr, acc, m, l, kw, kD, vw, kD, len, sm.attn.ks, sm.attn.vs);

    if (t < T) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      float4* op = reinterpret_cast<float4*>(o + b * sob + t * sot + h * soh);
#pragma unroll
      for (int i = 0; i < kD4; ++i) {
        op[i] = make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
      }
    }
  }
}

}  // namespace

// x: [B, T, DM] f32 contiguous, DM = H * 64; wq, wk, wv: [DM, DM] f32
// contiguous (nn.Linear's [out, in]); bq, bk, bv: [DM]; lengths: int32
// [B]; ws: f32 workspace of 3 * B * H * T * 64 floats; o: [B, T, H, 64]
// addressed through its strides (in elements; unit stride on the last
// axis, the others multiples of 4, 16-byte aligned). T <= 1024. Returns
// cudaGetLastError().
extern "C" int nomad_fused_qkv_attention_fwd(
    const void* x, const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* lengths, void* ws, void* o, int B, int T,
    int H, int DM, long long sob, long long sot, long long soh, float scale, void* stream) {
  if (B < 0 || T < 0 || H < 0 || DM != H * kD || T > kMaxT || B > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const dim3 grid(H, B);
  fused_qkv_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wq),
      static_cast<const float*>(bq), static_cast<const float*>(wk),
      static_cast<const float*>(bk), static_cast<const float*>(wv),
      static_cast<const float*>(bv), static_cast<const int*>(lengths),
      static_cast<float*>(ws), static_cast<float*>(o), B, T, H, DM, sob, sot, soh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
