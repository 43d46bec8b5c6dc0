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
// shape against 0.12 ms of memory time. So shared-memory operands must feed
// many FMAs each, and enough warps must be resident to hide the loads'
// latency. At the loss crop [32, 50, 12, 64] each kernel is a few
// microseconds of either: there the launch and the tail decide.
//
// Design, for that bound:
//   * The TPU's split of the work: K2 owns dQ, K3 owns dK and dV, so no
//     block reduces across blocks. No atomics and no workspace: every
//     output element is one thread's sum in a fixed order, so two calls
//     give the same bits. (One kernel forming S and dP once and adding dQ
//     with atomics would do 10*D FLOP a pair, not 14*D, but its dQ would
//     change from run to run.)
//   * The register-tiled backward tile of attention_bwd_tile.cuh, K1's
//     layout: 4 warps, each thread an RT x 4 block of S and of dP from
//     shared memory, then an RT x 8 block of the output. K2's block holds
//     64 query rows of Q (pre-scaled) and dO and streams 32-key tiles of K
//     and V; K3's block holds 64 key rows of K (pre-scaled) and V and
//     streams 32-query tiles of Q and dO (LSE and Di ride in the Q tile's
//     spare columns), and keeps 64 accumulators a thread (dK and dV). P and
//     dS pass to the products through a per-warp shared slice (__syncwarp,
//     no block barrier); K3 reuses one slice, P^T for dV and then dS^T for
//     dK, and forms dP^T only after dV, so one block of scores is live at
//     a time. Per 32-row tile a warp makes 352 16-byte loads for 3,072 FMAs
//     a thread in K2 and 448 for 4,096 in K3, against one load per 4 FMAs
//     in the earlier design, which gave each row 2 lanes and formed every
//     score as a dot product against shared memory (a third of the bound).
//   * Occupancy: both 64-row blocks take 76,800 B of shared memory (the
//     resident rows swizzled instead of padded, K3's single slice) and at
//     most 168 registers, 3 blocks (12 warps) per SM with no spills.
//   * The streamed tiles are double-buffered with cp.async: tile j + 1
//     loads while tile j computes, behind one block barrier a tile; rows
//     past the bound (keys at or past lengths[b] in K2, queries past T in
//     K3) are zero-filled by the copy (source size 0), never read.
//   * At T <= 64 (the loss crop's T' = 50) 64-row blocks would leave 384
//     blocks at [32, 50] for 0.97 waves on 132 SMs; there each block owns
//     32 rows (RT = 2), 55,808 B, 768 blocks for 1.94 waves. 16-row blocks
//     (RT = 1) make twice the loads per FMA and ran slower. The launch plan
//     is ops/flash_attention.py::flash_bwd_launch_plan; the launchers refuse
//     any other.
//   * Masking, K1's contract: keys at or past lengths[b] are never read
//     and get P = 0 by select, so a NaN there reaches no output; their dK
//     and dV are written as 0. A batch row with lengths[b] == 0 (LSE =
//     -1e30) gets dQ = dK = dV = 0 without forming exp(s - LSE). Padded
//     query rows (t >= lengths[b]) attended the valid keys in the forward,
//     so their dO reaches dK and dV like any row's.
//   * q, k, v and dO are read in place through their [B, T, H, D] strides;
//     dQ, dK, dV are written contiguous [B, T, H, D]; LSE and Di are
//     [B, H, T]. expf, not __expf, to stay within f32 rounding of the plain
//     version.
//
// f32 tensors only: on bf16 ones (bf16 activations at a "highest" or
// "high" attention island) the same gradients, f32-exact on the upcast
// inputs, run on the tensor cores as K2-bf16 and K3-bf16
// (flash_attention_bwd_bf16.cu).
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

#include "attention_bwd_tile.cuh"

namespace {

using nomad::kBK;
using nomad::kD;
using nomad::kKT;
using nomad::kLd;
using nomad::kLdR;
using nomad::kLdS;
using nomad::kThreads;
constexpr int kD4 = kD / 4;    // float4 words per row
constexpr int kStages = 2;     // streamed tiles in flight
constexpr int kSmallT = 64;    // up to this T a block owns 16 * kSmallRT rows
constexpr int kSmallRT = 2;

constexpr int kMinBlocks = 3;  // per SM, both kernels (__launch_bounds__)

template <int RT>
struct DqSmem {
  float q[16 * RT][kLdR];       // Q rows, pre-scaled by 1/sqrt(D)
  float dout[16 * RT][kLdR];    // dO rows
  float k[kStages][kBK][kLd];   // key tiles in flight
  float v[kStages][kBK][kLd];
  float ds[16 * RT][kLdS];      // dS, one slice per warp
};

template <int RT>
struct DkvSmem {
  float k[16 * RT][kLdR];       // K rows, pre-scaled by 1/sqrt(D)
  float v[16 * RT][kLdR];       // V rows
  float q[kStages][kBK][kLd];   // query tiles in flight; columns kD, kD + 1: LSE, Di
  float dout[kStages][kBK][kLd];
  float pds[16 * RT][kLdS];     // P^T, then dS^T: one slice per warp
};

// Copies rows r0 .. r0 + 16 RT - 1 of x (row stride sx, in elements) into
// dst (laid out by nomad::resident_col), times scale; rows at or past
// `end` are 0 and never read.
template <int RT>
__device__ __forceinline__ void load_rows(float (*dst)[kLdR], const float* x, long long sx, int r0,
                                          int end, float scale) {
  for (int idx = threadIdx.x; idx < 16 * RT * kD4; idx += kThreads) {
    const int r = idx / kD4;
    const int c = idx % kD4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < end) {
      a = nomad::load4(x + (r0 + r) * sx + 4 * c);
      a = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    }
    *reinterpret_cast<float4*>(&dst[r][nomad::resident_col(r, 4 * c)]) = a;
  }
}

// Rows j*kBK .. j*kBK + kBK - 1 of x and y into the tiles xs, ys by
// cp.async; rows at or past `end` are zero-filled and not read.
__device__ __forceinline__ void stage_rows(float (*xs)[kLd], float (*ys)[kLd], const float* x,
                                           long long sx, const float* y, long long sy, int j,
                                           int end) {
  constexpr int kPer = kBK * kD4 / kThreads;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / kD4;
    const int c = idx % kD4;
    const int row = j * kBK + r;
    const bool ok = row < end;
    nomad::cp_async16(&xs[r][4 * c], ok ? x + row * sx + 4 * c : x, ok ? 16 : 0);
    nomad::cp_async16(&ys[r][4 * c], ok ? y + row * sy + 4 * c : y, ok ? 16 : 0);
  }
}

// Stores the thread's RT x 8 block of a [B, T, H, 64] output for the rows
// r0 + bwd_row(i) < T, times scale, or 0 where zero(row) holds.
template <int RT, class Zero>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[RT][8], int b, int h,
                                           int T, int H, int r0, float scale, Zero&& zero) {
  const int c0 = nomad::tile_col0();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int t = r0 + nomad::bwd_row<RT>(i);
    if (t >= T) continue;
    const float f = zero(t) ? 0.f : scale;
    float* op = out + ((static_cast<long long>(b) * T + t) * H + h) * kD;
    const float* a = acc[i];
    nomad::store4(op + c0, a[0] * f, a[1] * f, a[2] * f, a[3] * f);
    nomad::store4(op + c0 + 32, a[4] * f, a[5] * f, a[6] * f, a[7] * f);
  }
}

// ---------------- K2: dQ ----------------

template <int RT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ lengths, float* __restrict__ dq,
                    int T, int H,
                    long long sqb, long long sqt, long long sqh,
                    long long skb, long long skt, long long skh,
                    long long svb, long long svt, long long svh,
                    long long sdb, long long sdt, long long sdh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<RT>& sm = *reinterpret_cast<DqSmem<RT>*>(smem_raw);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * 16 * RT;
  const int len = min(max(lengths[b], 0), T);
  const int tx = threadIdx.x & 7;

  load_rows<RT>(sm.q, q + b * sqb + h * sqh, sqt, t0, T, scale);
  load_rows<RT>(sm.dout, dout + b * sdb + h * sdh, sdt, t0, T, 1.f);
  // a row past T computes on zeros (P = 1, dS = 0) and is not written
  float lse_r[RT], di_r[RT], acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int t = t0 + nomad::bwd_row<RT>(i);
    const long long r = (static_cast<long long>(b) * H + h) * T + t;
    lse_r[i] = t < T ? lse[r] : 0.f;
    di_r[i] = t < T ? di[r] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const bool active = t0 + (threadIdx.x >> 5) * 4 * RT < T;  // the warp has a row
  const int tiles = (len + kBK - 1) / kBK;
  auto stage = [&](int j) {
    if (j < tiles) stage_rows(sm.k[j % kStages], sm.v[j % kStages], kb, skt, vb, svt, j, len);
    nomad::cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) stage(j);
  for (int j = 0; j < tiles; ++j) {
    nomad::cp_async_wait<kStages - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();  // ... and every thread's, the resident rows too; tile j - 1 is done
    stage(j + kStages - 1);  // into the buffers of tile j - 1
    if (active) {
      const float(*ks)[kLd] = sm.k[j % kStages];
      float s[RT][kKT], dp[RT][kKT];
      nomad::dot_block<RT>(&sm.q[0][0], ks, s);                    // S
      nomad::dot_block<RT>(&sm.dout[0][0], sm.v[j % kStages], dp);  // dP
      const int n = min(kBK, len - j * kBK);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int jj = 0; jj < kKT; ++jj) {
          const float p = tx + 8 * jj < n ? expf(s[i][jj] - lse_r[i]) : 0.f;
          sm.ds[nomad::bwd_row<RT>(i)][tx + 8 * jj] = p * (dp[i][jj] - di_r[i]);
        }
      }
      __syncwarp();  // the warp's dS rows are written
      nomad::accumulate<RT>(sm.ds, ks, acc);
    }
  }
  store_rows<RT>(dq, acc, b, h, T, H, t0, scale, [](int) { return false; });
}

// ---------------- K3: dK, dV ----------------

template <int RT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ lengths, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int H,
                     long long sqb, long long sqt, long long sqh,
                     long long skb, long long skt, long long skh,
                     long long svb, long long svt, long long svh,
                     long long sdb, long long sdt, long long sdh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<RT>& sm = *reinterpret_cast<DkvSmem<RT>*>(smem_raw);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * 16 * RT;
  const int len = min(max(lengths[b], 0), T);
  const int tx = threadIdx.x & 7;
  auto past = [len](int key) { return key >= len; };

  float dka[RT][8], dva[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  if (key0 >= len) {  // no valid key in this block: zeros
    store_rows<RT>(dk, dka, b, h, T, H, key0, 0.f, past);
    store_rows<RT>(dv, dva, b, h, T, H, key0, 0.f, past);
    return;
  }

  load_rows<RT>(sm.k, k + b * skb + h * skh, skt, key0, len, scale);
  load_rows<RT>(sm.v, v + b * svb + h * svh, svt, key0, len, 1.f);
  // the thread's rows are key0 + bwd_row(0) + 4 i: the first `valid` are keys
  const int valid = (len - key0 - nomad::bwd_row<RT>(0) + 3) >> 2;

  const float* qb = q + b * sqb + h * sqh;
  const float* db = dout + b * sdb + h * sdh;
  const float* lb = lse + (static_cast<long long>(b) * H + h) * T;
  const float* ib = di + (static_cast<long long>(b) * H + h) * T;
  const int tiles = (T + kBK - 1) / kBK;
  auto stage = [&](int j) {
    if (j < tiles) {
      const int buf = j % kStages;
      stage_rows(sm.q[buf], sm.dout[buf], qb, sqt, db, sdt, j, T);
      const int r = threadIdx.x % kBK;
      const int t = j * kBK + r;
      const bool ok = t < T;
      if (threadIdx.x < kBK) {
        nomad::cp_async4(&sm.q[buf][r][kD], ok ? lb + t : lb, ok ? 4 : 0);
      } else if (threadIdx.x < 2 * kBK) {
        nomad::cp_async4(&sm.q[buf][r][kD + 1], ok ? ib + t : ib, ok ? 4 : 0);
      }
    }
    nomad::cp_async_commit();
  };
  const bool active = key0 + (threadIdx.x >> 5) * 4 * RT < len;  // the warp has a valid key
  for (int j = 0; j < kStages - 1; ++j) stage(j);
  for (int j = 0; j < tiles; ++j) {
    const int buf = j % kStages;
    nomad::cp_async_wait<kStages - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();  // ... and every thread's, the resident rows too; tile j - 1 is done
    stage(j + kStages - 1);  // into the buffers of tile j - 1
    if (active) {
      const float(*qs)[kLd] = sm.q[buf];
      const float(*ds)[kLd] = sm.dout[buf];
      // S^T, then P^T into the slice and dV; then dP^T, and dS^T in place
      // of P^T (each thread its own entries) and dK: one block of scores
      // live at a time beside the 64 accumulators
      float s[RT][kKT];
      nomad::dot_block<RT>(&sm.k[0][0], qs, s);  // S^T
      const int n = min(kBK, T - j * kBK);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int jj = 0; jj < kKT; ++jj) {
          const int c = tx + 8 * jj;
          sm.pds[nomad::bwd_row<RT>(i)][c] =
              i < valid && c < n ? expf(s[i][jj] - qs[c][kD]) : 0.f;
        }
      }
      __syncwarp();  // the warp's P rows are written
      nomad::accumulate<RT>(sm.pds, ds, dva);
      nomad::dot_block<RT>(&sm.v[0][0], ds, s);  // dP^T
      __syncwarp();  // the warp's P rows are read
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int jj = 0; jj < kKT; ++jj) {
          const int c = tx + 8 * jj;
          float& e = sm.pds[nomad::bwd_row<RT>(i)][c];
          e = e * (s[i][jj] - qs[c][kD + 1]);  // dS = P o (dP - Di)
        }
      }
      __syncwarp();  // the warp's dS rows are written
      nomad::accumulate<RT>(sm.pds, qs, dka);
    }
  }
  store_rows<RT>(dk, dka, b, h, T, H, key0, scale, past);
  store_rows<RT>(dv, dva, b, h, T, H, key0, 1.f, past);
}

// The plan's rule (ops/flash_attention.py::flash_bwd_launch_plan): rows a
// block owns, and each kernel's dynamic shared memory.
int plan_rows(int T) { return T <= kSmallT ? 16 * kSmallRT : 64; }
int smem_bytes_for(bool dkv, int rows) {
  if (dkv) return rows == 64 ? sizeof(DkvSmem<4>) : sizeof(DkvSmem<kSmallRT>);
  return rows == 64 ? sizeof(DqSmem<4>) : sizeof(DqSmem<kSmallRT>);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t configure() {  // dynamic shared memory above 48 KB, once
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_dq_kernel<4>, sizeof(DqSmem<4>))) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dq_kernel<kSmallRT>, sizeof(DqSmem<kSmallRT>))) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dkv_kernel<4>, sizeof(DkvSmem<4>))) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dkv_kernel<kSmallRT>, sizeof(DkvSmem<kSmallRT>))) != cudaSuccess) return err;
  done = true;
  return cudaSuccess;
}

// Shape and plan checks shared by both launchers.
cudaError_t check_launch(bool dkv, int B, int T, int H, int D, int rows_per_block, int smem_bytes) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535 ||
      rows_per_block != plan_rows(T) || smem_bytes != smem_bytes_for(dkv, rows_per_block)) {
    return cudaErrorInvalidValue;
  }
  return configure();
}

}  // namespace

// q, k, v, dout: f32 [B, T, H, 64] with unit stride on the last axis (the
// other strides, in elements, multiples of 4), 16-byte aligned; lse, di:
// f32 [B, H, T] contiguous; lengths: int32 [B]; dq: f32 [B, T, H, 64]
// contiguous. rows_per_block and smem_bytes: the wrapper's plan
// (ops/flash_attention.py::flash_bwd_launch_plan), checked against the
// kernel's. Returns cudaGetLastError().
extern "C" int nomad_flash_attention_bwd_dq(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* di, const int* lengths, float* dq,
    int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, float scale,
    int rows_per_block, int smem_bytes, void* stream) {
  const cudaError_t err = check_launch(false, B, T, H, D, rows_per_block, smem_bytes);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const dim3 grid((T + rows_per_block - 1) / rows_per_block, H, B);
  auto kernel = rows_per_block == 64 ? flash_bwd_dq_kernel<4> : flash_bwd_dq_kernel<kSmallRT>;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, di, lengths, dq, T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale);
  return static_cast<int>(cudaGetLastError());
}

// As above; dk, dv: f32 [B, T, H, 64] contiguous.
extern "C" int nomad_flash_attention_bwd_dkv(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* di, const int* lengths, float* dk, float* dv,
    int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, float scale,
    int rows_per_block, int smem_bytes, void* stream) {
  const cudaError_t err = check_launch(true, B, T, H, D, rows_per_block, smem_bytes);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const dim3 grid((T + rows_per_block - 1) / rows_per_block, H, B);
  auto kernel =
      rows_per_block == 64 ? flash_bwd_dkv_kernel<4> : flash_bwd_dkv_kernel<kSmallRT>;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, di, lengths, dk, dv, T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of K2 (dkv = 0) or K3 (dkv = 1) for a plan of
// rows_per_block rows, at its shared memory (0 if it cannot run).
extern "C" int nomad_flash_attention_bwd_occupancy(int dkv, int rows_per_block,
                                                   int* blocks_per_sm) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  if (rows_per_block != 16 * kSmallRT && rows_per_block != 64) return cudaErrorInvalidValue;
  const int smem = smem_bytes_for(dkv != 0, rows_per_block);
  if (dkv) {
    auto kernel =
        rows_per_block == 64 ? flash_bwd_dkv_kernel<4> : flash_bwd_dkv_kernel<kSmallRT>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
  } else {
    auto kernel = rows_per_block == 64 ? flash_bwd_dq_kernel<4> : flash_bwd_dq_kernel<kSmallRT>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
  }
  return static_cast<int>(err);
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
