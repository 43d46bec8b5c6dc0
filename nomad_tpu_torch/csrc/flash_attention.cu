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
//
// f32 tensors only: bf16 ones at "highest" or "high" run K1-bf16
// (flash_attention_bf16.cu, the same products on the tensor cores).
// Launches on the caller's stream and allocates nothing.
//
// K1r (flash_fwd_kernel<true>; added for WavLM, no TPU source) is K1's
// template with its bias flag on: WavLM's gated relative-position bias,
// s_ij = (q_i / sqrt(D)) . k_j + g[b, h, i] * r[h, j - i + T - 1], added to
// each score after the product (rounded as two operations, the product
// and the sum, as the plain version computes it) and before the mask. g
// [B, H, T] takes one register per query row; of r [H, 2T - 1] a 64 x 32
// tile reads the 95 offsets -(63) .. 31 around key tile j's first key
// less the query tile's first row, staged by 4-byte cp.async beside the
// K/V tile (zero outside the table) and double-buffered with it. The
// bias adds ~2 operations a score to K1's 256 (bound: operations, as
// K1), and 95 floats of shared memory a key tile. K1's own instantiation
// (flash_fwd_kernel<false>) compiles without the hook (NoBias) and reads
// neither g nor r: its bits are as before.

#include <cuda_runtime.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using nomad::kBK;
using nomad::kBQ;
using nomad::kD;
using nomad::kLd;
using nomad::kNegInf;
using nomad::kThreads;

// the window of r a 64-query x 32-key tile reads: offsets j - i from
// -(kBQ - 1) to kBK - 1, 95 values in a 96-float slot
constexpr int kWin = kBQ + kBK;

struct Smem {
  float q[kBQ][kLd];
  nomad::KeyTiles kt;
};
struct SmemRel {
  float q[kBQ][kLd];
  nomad::KeyTiles kt;
  float win[2][kWin];
};
constexpr int kSmemBytes = sizeof(Smem);
constexpr int kSmemRelBytes = sizeof(SmemRel);
constexpr int kMinBlocks = 3;  // per SM: 3 x 62,464 bytes of shared memory (K1r 63,232)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

// K1r's bias on a thread's scores of key tile j: g_i * r[offset], the
// offset's window slot kc - r + 63 for key column kc and tile row r.
struct RelBias {
  static constexpr bool kOn = true;
  const float (*win)[kWin];
  float g[4];
  __device__ __forceinline__ void operator()(int j, float (&s)[4][nomad::kKT]) const {
    const float* w = win[j & 1];
    const int tx = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int base = tx - nomad::tile_row(i) + kBQ - 1;
#pragma unroll
      for (int jj = 0; jj < nomad::kKT; ++jj) {
        s[i][jj] = __fadd_rn(s[i][jj], __fmul_rn(g[i], w[base + 8 * jj]));
      }
    }
  }
};

// K1 (kRel false: g and rtab, which is r, are not read) and K1r.
template <bool kRel>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ rtab, const int* __restrict__ lengths,
                 float* __restrict__ o, float* __restrict__ lse, int T, int H,
                 long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh,
                 long long svb, long long svt, long long svh,
                 long long sob, long long sot, long long soh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<std::conditional_t<kRel, SmemRel, Smem>*>(smem_raw);

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
      a = nomad::load4(q + b * sqb + (q0 + r) * sqt + h * sqh + 4 * c);
      a = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    }
    *reinterpret_cast<float4*>(&sm.q[r][4 * c]) = a;
  }

  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  auto stage = [&](int j, float (*ks)[kLd], float (*vs)[kLd]) {
    constexpr int kPer = kBK * (kD / 4) / kThreads;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / (kD / 4);
      const int c = idx % (kD / 4);
      const int key = j * kBK + r;
      const bool ok = key < len;
      nomad::cp_async16(&ks[r][4 * c], ok ? kb + key * skt + 4 * c : kb, ok ? 16 : 0);
      nomad::cp_async16(&vs[r][4 * c], ok ? vb + key * svt + 4 * c : vb, ok ? 16 : 0);
    }
    if constexpr (kRel) {
      if (tid < kWin - 1) {  // offset j*kBK - q0 - 63 + tid, column + T - 1 of r
        const float* rb = rtab + static_cast<long long>(h) * (2 * T - 1);
        const int col = j * kBK - q0 - (kBQ - 1) + tid + T - 1;
        const bool ok = col >= 0 && col <= 2 * T - 2;
        cp_async4(&sm.win[j & 1][tid], ok ? rb + col : rb, ok ? 4 : 0);
      }
    }
  };
  nomad::RowState st;
  const bool active = q0 + (tid >> 5) * 16 < T;
  if constexpr (kRel) {
    RelBias bias{sm.win, {}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + nomad::tile_row(i);
      bias.g[i] = t < T ? g[(static_cast<long long>(b) * H + h) * T + t] : 0.f;
    }
    nomad::attend_keys(&sm.q[0][0], len, active, stage, sm.kt, st, bias);
  } else {
    nomad::attend_keys(&sm.q[0][0], len, active, stage, sm.kt, st);
  }

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

template <class Kernel>
cudaError_t configure(Kernel kernel, int smem_bytes) {  // dynamic shared memory above 48 KB
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

cudaError_t configure() {  // K1's, once
  static bool done = false;
  if (!done) {
    const cudaError_t err = configure(flash_fwd_kernel<false>, kSmemBytes);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

cudaError_t configure_rel() {  // K1r's, once
  static bool done = false;
  if (!done) {
    const cudaError_t err = configure(flash_fwd_kernel<true>, kSmemRelBytes);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

void launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
            void* lse, int B, int T, int H,
            long long sqb, long long sqt, long long sqh,
            long long skb, long long skt, long long skh,
            long long svb, long long svt, long long svh,
            long long sob, long long sot, long long soh, float scale, cudaStream_t stream) {
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<false><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      nullptr, nullptr, static_cast<const int*>(lengths), static_cast<float*>(o),
      static_cast<float*>(lse), T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale);
}

}  // namespace

// q, k, v, o: f32 [B, T, H, 64] with unit stride on the last axis (the
// other strides, in elements, multiples of 4), 16-byte aligned; lengths:
// int32 [B]; lse:
// f32 [B, H, T] contiguous. smem_bytes: the wrapper's plan
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
  launch(q, k, v, lengths, o, lse, B, T, H, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot,
         soh, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of K1 per SM at its shared memory (0 if it cannot run).
extern "C" int nomad_flash_attention_fwd_occupancy(int* blocks_per_sm) {
  const cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_kernel<false>, kThreads, kSmemBytes));
}

// K1r: as nomad_flash_attention_fwd, with g f32 [B, H, T] and r f32
// [H, 2T - 1], both contiguous; smem_bytes the wrapper's plan for K1r.
extern "C" int nomad_flash_attention_rel_fwd(
    const void* q, const void* k, const void* v, const void* g, const void* r,
    const void* lengths, void* o, void* lse, int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh, float scale, int smem_bytes, void* stream) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535 ||
      smem_bytes != kSmemRelBytes) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const cudaError_t err = configure_rel();
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<true><<<grid, kThreads, kSmemRelBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(r), static_cast<const int*>(lengths),
      static_cast<float*>(o), static_cast<float*>(lse), T, H, sqb, sqt, sqh, skb, skt, skh, svb,
      svt, svh, sob, sot, soh, scale);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of K1r per SM at its shared memory (0 if it cannot run).
extern "C" int nomad_flash_attention_rel_fwd_occupancy(int* blocks_per_sm) {
  const cudaError_t err = configure_rel();
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_kernel<true>, kThreads, kSmemRelBytes));
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
