// Masked multi-head attention backward, float32, head width 64: kernel K2
// (dQ) and kernel K3 (dK, dV).
//
// Replaces nomad_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (launched by _flash_bwd_folded from
// _mha_pallas_bwd). Both recompute P = exp(s - LSE) from the forward's
// log-sum-exp, with s = (q / sqrt(D)) . k over the first lengths[b] keys:
//   dP = dO . V^T,  dS = P o (dP - Di),  Di = rowsum(dO o O)
//   K2: dQ = dS . K / sqrt(D)
//   K3: dK = dS^T . Q / sqrt(D),  dV = P^T . dO
// Di is one plain PyTorch reduction ahead of both launches, as the JAX
// package computes it outside its kernels.
//
// What bounds them on an H100: operations. Per (query row, valid key) pair
// K2 does 6*D FLOP (s, dP, dQ) and K3 8*D (s, dP, dK, dV), 14*D together
// against the forward's 4*D; in f32 without tensor cores ("exact" forbids
// TF32) that is 0.96 ms at 67 TFLOP/s for the [24, 499, 12, 64] training
// shape against 0.12 ms of memory time (405 MB for the pair). At the loss
// shape [32, 50, 12, 64] each is a few microseconds of either, so launch
// and tail effects dominate there.
//
// Design, for that bound:
//   * The TPU's split of the work, so no block reduces across blocks and
//     no atomics are needed: K2 runs one block per (64-query tile, head,
//     batch) and loops over 64-key tiles of K and V in shared memory; it
//     owns dQ. K3 runs one block per (64-key tile, head, batch) and loops
//     over 64-query tiles of Q, dO, LSE and Di in shared memory; it owns
//     dK and dV.
//   * Registers: a thread-per-row layout like K1's would hold 192 floats
//     (K2: q, dO, dQ) or 256 (K3: k, v, dK, dV) and spill. So the head
//     axis is split across 2 lanes per row: 96 floats a lane in K2 (166
//     registers), 128 in K3 (252 registers, no spills; 4 lanes a key row
//     need fewer registers but compute each exp 4 times and add a shuffle
//     round, and ran slower). A lane holds the float4 words
//     c = w * lanes + part, interleaved, so the lanes of a row read
//     neighbouring 16-byte words of a shared-memory row (no bank conflict)
//     and every row of the warp reads the same words (broadcast). Partial
//     dot products meet through __shfl_xor_sync, 8 rows' worth at a time,
//     and the 8 rows' words are read from shared memory twice (once for
//     the dot products, once for the accumulation) rather than held.
//   * Masking, K1's contract: keys at or past lengths[b] are never read
//     (the tile is zero-filled in shared memory and P is 0 there by
//     select), so a NaN there reaches no output; their dK and dV are
//     written as 0. A batch row with lengths[b] == 0 (LSE = -1e30) gets
//     dQ = dK = dV = 0 without forming exp(s - LSE). Padded query rows
//     (t >= lengths[b]) attended the valid keys in the forward, so their
//     dO reaches dK and dV like any row's.
//   * q, k, v and dO are read in place through their [B, T, H, D] strides;
//     dQ, dK, dV are written contiguous [B, T, H, D]; LSE and Di are
//     [B, H, T]. expf, not __expf, to stay within f32 rounding of the plain
//     version.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;              // head width
constexpr int kD4 = kD / 4;         // float4 words per row
constexpr int kLanes = 2;           // lanes per query row (K2) or key row (K3)
constexpr int kWords = kD4 / kLanes;  // float4 words per lane
constexpr int kRows = 64;           // rows a block owns
constexpr int kThreads = kRows * kLanes;
constexpr int kTile = 64;           // rows per shared-memory tile of the loop
constexpr int kCH = 8;              // rows whose partial dot products meet at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& y) {
  y.x = fmaf(s, x.x, y.x);
  y.y = fmaf(s, x.y, y.y);
  y.z = fmaf(s, x.z, y.z);
  y.w = fmaf(s, x.w, y.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// The accumulation loop reads again the shared-memory words the dot-product
// loop just read. Without a fence between the two, ptxas keeps every word
// live in registers across them and spills (255 registers and 2.6-3.6 KB
// of spill stores per thread); an empty asm with a memory clobber does not
// reach ptxas, the warp barrier does.
__device__ __forceinline__ void reload_shared() { __syncwarp(); }

// The full dot product from the two lanes' halves (lanes 2r and 2r + 1).
static_assert(kLanes == 2, "pair_sum combines two lanes");
__device__ __forceinline__ float pair_sum(float x) { return x + __shfl_xor_sync(kFull, x, 1); }

// ---------------- K2: dQ ----------------

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ lengths, float* __restrict__ dq,
                    int T, int H,
                    long long sqb, long long sqt, long long sqh,
                    long long skb, long long skt, long long skh,
                    long long svb, long long svt, long long svh,
                    long long sdb, long long sdt, long long sdh, float scale) {
  __shared__ float4 ks[kTile][kD4];
  __shared__ float4 vs[kTile][kD4];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int part = threadIdx.x % kLanes;
  const int t = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int len = min(max(lengths[b], 0), T);
  const bool live = t < T;

  // a row past T computes on zeros (P = 1, dS = 0) and is not written
  float4 qr[kWords], dor[kWords], acc[kWords];
  float lse_t = 0.f, di_t = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const float4* qp = reinterpret_cast<const float4*>(q + b * sqb + t * sqt + h * sqh);
    const float4* dp = reinterpret_cast<const float4*>(dout + b * sdb + t * sdt + h * sdh);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      qr[w] = scale4(qp[w * kLanes + part], scale);
      dor[w] = dp[w * kLanes + part];
    }
    const long long r = (static_cast<long long>(b) * H + h) * T + t;
    lse_t = lse[r];
    di_t = di[r];
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) qr[w] = dor[w] = zero;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) acc[w] = zero;

  const float* kbase = k + b * skb + h * skh;
  const float* vbase = v + b * svb + h * svh;
  for (int k0 = 0; k0 < len; k0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kTile * kD4; idx += kThreads) {
      const int r = idx / kD4;
      const int c = idx % kD4;
      const int key = k0 + r;
      float4 kv = zero, vv = zero;
      if (key < len) {
        kv = reinterpret_cast<const float4*>(kbase + key * skt)[c];
        vv = reinterpret_cast<const float4*>(vbase + key * svt)[c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    const int n = min(kTile, len - k0);
    for (int j0 = 0; j0 < n; j0 += kCH) {
      float s[kCH], dp[kCH];
#pragma unroll
      for (int j = 0; j < kCH; ++j) s[j] = dp[j] = 0.f;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int c = w * kLanes + part;
#pragma unroll
        for (int j = 0; j < kCH; ++j) {
          s[j] = dot4(qr[w], ks[j0 + j][c], s[j]);
          dp[j] = dot4(dor[w], vs[j0 + j][c], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        s[j] = pair_sum(s[j]);
        dp[j] = pair_sum(dp[j]);
        const float p = j0 + j < n ? expf(s[j] - lse_t) : 0.f;
        s[j] = p * (dp[j] - di_t);  // dS
      }
      reload_shared();
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) axpy4(s[j], ks[j0 + j][w * kLanes + part], acc[w]);
      }
    }
  }

  if (live) {
    float4* out = reinterpret_cast<float4*>(dq + ((static_cast<long long>(b) * T + t) * H + h) * kD);
#pragma unroll
    for (int w = 0; w < kWords; ++w) out[w * kLanes + part] = scale4(acc[w], scale);
  }
}

// ---------------- K3: dK, dV ----------------

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ lengths, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int H,
                     long long sqb, long long sqt, long long sqh,
                     long long skb, long long skt, long long skh,
                     long long svb, long long svt, long long svh,
                     long long sdb, long long sdt, long long sdh, float scale) {
  __shared__ float4 qs[kTile][kD4];
  __shared__ float4 dos[kTile][kD4];
  __shared__ float lses[kTile];
  __shared__ float dis[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int part = threadIdx.x % kLanes;
  const int key = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int len = min(max(lengths[b], 0), T);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long out_off = ((static_cast<long long>(b) * T + key) * H + h) * kD;

  if (blockIdx.x * kRows >= len) {  // no valid key in this block: zeros
    if (key < T) {
      float4* dkp = reinterpret_cast<float4*>(dk + out_off);
      float4* dvp = reinterpret_cast<float4*>(dv + out_off);
#pragma unroll
      for (int w = 0; w < kWords; ++w) dkp[w * kLanes + part] = dvp[w * kLanes + part] = zero;
    }
    return;
  }

  const bool valid = key < len;
  float4 kr[kWords], vr[kWords], dkr[kWords], dvr[kWords];
  if (valid) {
    const float4* kp = reinterpret_cast<const float4*>(k + b * skb + key * skt + h * skh);
    const float4* vp = reinterpret_cast<const float4*>(v + b * svb + key * svt + h * svh);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      kr[w] = scale4(kp[w * kLanes + part], scale);
      vr[w] = vp[w * kLanes + part];
    }
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) kr[w] = vr[w] = zero;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) dkr[w] = dvr[w] = zero;

  const float* qbase = q + b * sqb + h * sqh;
  const float* dbase = dout + b * sdb + h * sdh;
  const float* lbase = lse + (static_cast<long long>(b) * H + h) * T;
  const float* ibase = di + (static_cast<long long>(b) * H + h) * T;
  for (int q0 = 0; q0 < T; q0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kTile * kD4; idx += kThreads) {
      const int r = idx / kD4;
      const int c = idx % kD4;
      const int t = q0 + r;
      float4 qv = zero, dv4 = zero;
      if (t < T) {
        qv = reinterpret_cast<const float4*>(qbase + t * sqt)[c];
        dv4 = reinterpret_cast<const float4*>(dbase + t * sdt)[c];
      }
      qs[r][c] = qv;
      dos[r][c] = dv4;
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int t = q0 + r;
      lses[r] = t < T ? lbase[t] : 0.f;
      dis[r] = t < T ? ibase[t] : 0.f;
    }
    __syncthreads();

    const int n = min(kTile, T - q0);
    for (int i0 = 0; i0 < n; i0 += kCH) {
      float s[kCH], dp[kCH];
#pragma unroll
      for (int i = 0; i < kCH; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int c = w * kLanes + part;
#pragma unroll
        for (int i = 0; i < kCH; ++i) {
          s[i] = dot4(kr[w], qs[i0 + i][c], s[i]);
          dp[i] = dot4(vr[w], dos[i0 + i][c], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kCH; ++i) {
        s[i] = pair_sum(s[i]);
        dp[i] = pair_sum(dp[i]);
        const float p = valid && i0 + i < n ? expf(s[i] - lses[i0 + i]) : 0.f;
        dp[i] = p * (dp[i] - dis[i0 + i]);  // dS
        s[i] = p;
      }
      reload_shared();
#pragma unroll
      for (int i = 0; i < kCH; ++i) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int c = w * kLanes + part;
          axpy4(s[i], dos[i0 + i][c], dvr[w]);
          axpy4(dp[i], qs[i0 + i][c], dkr[w]);
        }
      }
    }
  }

  if (key < T) {
    float4* dkp = reinterpret_cast<float4*>(dk + out_off);
    float4* dvp = reinterpret_cast<float4*>(dv + out_off);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      dkp[w * kLanes + part] = valid ? scale4(dkr[w], scale) : zero;
      dvp[w * kLanes + part] = valid ? dvr[w] : zero;
    }
  }
}

bool bad_shape(int B, int T, int H, int D) {
  return D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535;
}

}  // namespace

// q, k, v, dout: [B, T, H, 64] f32 with unit stride on the last axis and the
// other strides (in elements) multiples of 4, 16-byte aligned; lse, di:
// f32 [B, H, T] contiguous; lengths: int32 [B]; dq: f32 [B, T, H, 64]
// contiguous. Returns cudaGetLastError().
extern "C" int nomad_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* lengths, void* dq,
    int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(lengths), static_cast<float*>(dq), T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale);
  return static_cast<int>(cudaGetLastError());
}

// As above; dk, dv: f32 [B, T, H, 64] contiguous.
extern "C" int nomad_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* lengths, void* dk, void* dv,
    int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, float scale, void* stream) {
  if (bad_shape(B, T, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(lengths), static_cast<float*>(dk),
      static_cast<float*>(dv), T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
