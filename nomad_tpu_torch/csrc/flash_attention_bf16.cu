// Masked multi-head attention forward, single-pass bf16 products with f32
// accumulation and an f32 softmax, head width 64 (kernel K1b), fed by a
// prologue kernel that folds K and V to bf16 once per call.
//
// Replaces nomad_tpu/ops/flash_attention.py::_flash_kernel at its own
// default precision (jax.lax.Precision.DEFAULT, :55-61), the flavour that
// attention_impl "auto"/"pallas" and the "balanced" and "fast" configs run:
// both products take operands rounded to bf16 and accumulate in f32. Per
// (batch, head): s = bf16(q / sqrt(D)) . bf16(k) over the first lengths[b]
// keys, p = exp(s - m) in f32, l = sum of the unrounded p, O = bf16(p) .
// bf16(v) / l, LSE = m + log(l). K1 (flash_attention.cu) is the f32 flavour.
//
// Two I/O flavours from one template: q, k, v and O in f32, or in bf16 (the
// trainer's fast_bf16, where the TPU kernel reads bf16 blocks through
// astype(float32), :50, :67-68, and stores O in q's dtype, :76, :101). Only
// the prologue and the Q loads read the inputs: the prologue rounds f32 K
// and V and copies bf16 ones, each consumer rounds q / 8 (exact scale) as
// it loads it, so both flavours run the one bf16 body on the same bits and
// the bf16 flavour's O is the f32 flavour's on the upcast inputs, rounded
// once, by construction; LSE stays f32.
//
// What bounds it on an H100: by the bound, bytes. At the scoring shape (B =
// 96, T = 511, 499 keys valid, H = 12) the work reads ~0.28 GB of valid f32
// K/V and 0.15 GB of q and writes 0.15 GB of O and LSE (0.17 ms at 3.35
// TB/s), against 77 GFLOP that the bf16 tensor cores do in 0.08 ms at 989
// TFLOP/s. A block that loads, rounds and stores each K/V tile itself and
// waits on it before its products (the mma.sync design this replaced) is
// bound by that latency instead, and every query block of a (batch, head)
// re-reads and re-rounds the same f32 tiles. Here the prologue reads K and
// V once, the kernel reads half those bytes, and the copies run behind the
// products; what sets the pace is the products and the softmax between
// them.
//
// Design:
//   * The prologue (flash_fwd_fold_bf16_kernel) writes k and v as bf16
//     [2, B*H, T64, 64], folded head-major with T padded to T64, a multiple
//     of 64, by zeros (the JAX package folds before its forward too,
//     _fold_args, nomad_tpu/ops/flash_attention.py:143-161); rows at or past
//     lengths[b] are 0, because inside the tensor core 0 * NaN is NaN. Every
//     K/V tile is then one 64-row TMA box that never crosses a head and
//     needs no mask. Its rows are folded by the code K2b/K3b's prologue runs
//     (attention_wgmma.cuh::fold_rows).
//   * The kernel: one block per 64 query rows, head and batch row: a
//     consumer warpgroup (4 warps, 16 rows a warp) and a producer warp.
//     The consumers load their Q rows through q's strides, scale by 1/8,
//     round to bf16 and store them in the 128-byte swizzle that wgmma reads.
//     One thread of the producer warp keeps a ring of kStages (K, V) tile
//     pairs full by TMA, one "full" and one "empty" mbarrier a stage, only
//     the tiles below ceil(lengths[b] / 64).
//   * The consumers run K4b's key loop (attention_wgmma.cuh::attend_tiles):
//     S by wgmma from shared memory, the online softmax on the accumulator
//     fragments (exp2f of every element, the mask a select on the bound's
//     tile), P into register A fragments, O += P . V by wgmma, the next
//     tile's scores in flight beside this tile's P . V; a stage is released
//     once its P . V has completed. Its sums are mma.sync's in the same
//     order, so O and LSE are the bits of the mma.sync K1b this replaced.
//     The online softmax rounds p against the running maximum, where the
//     TPU kernel's single pass rounds it against the final one: the same
//     bf16 error class, not the same bits.
//   * Every query row t < T is written, finite, padded rows included. A row
//     with no valid key (lengths[b] == 0) gets O = 0 and LSE = -1e30. No
//     atomics: a rerun gives the same bits. A wait on an mbarrier that
//     outlasts ~2 s traps instead of holding the card.
// Launches on the caller's stream and allocates nothing: the caller hands
// in the fold's buffer.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace nomad::sm90;

constexpr int kD = 64;                           // head width
constexpr int kRows = 64;                        // query rows of a block = keys of a tile
constexpr int kConsumers = 4;                    // warps of the consumer warpgroup
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kStages = 4;                       // the ring
constexpr int kMinBlocks = 3;                    // per SM (__launch_bounds__): <= 136 registers
constexpr int kTile = kRows * kD;                // bf16 values of a tile
constexpr uint32_t kTileBytes = kTile * 2;       // 8 KB
constexpr int kFoldThreads = 256;

struct Smem {
  __nv_bfloat16 q[kTile];  // the block's Q rows / sqrt(D), bf16, in the swizzle
  KeyTile ring[kStages];   // the streamed (K, V) tiles
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
// the tiles start on 1,024-byte boundaries (the swizzle atom); the
// dynamic shared memory is aligned by hand, hence the extra 1,024 bytes
constexpr int kSmemBytes = sizeof(Smem) + 1024;
static_assert(kTileBytes % 1024 == 0 && sizeof(KeyTile) % 1024 == 0, "swizzle atoms");
static_assert(kSmemBytes == 74816, "ops/flash_attention.py::FWD_BF16_SMEM_BYTES");

// ---- the prologue ----

// Block x of 2 B H: rows t < T64 of k (x / (B H) = 0) or v (1) of (batch,
// head) bh = x % (B H), rounded to bf16 (copied for bf16 inputs), 0 at t >=
// lengths[b].
template <typename IO>
__global__ void __launch_bounds__(kFoldThreads)
flash_fwd_fold_bf16_kernel(const IO* __restrict__ k, const IO* __restrict__ v,
                           long long skb, long long skt, long long skh,
                           long long svb, long long svt, long long svh,
                           const int* __restrict__ lengths, __nv_bfloat16* __restrict__ fold,
                           int T, int H, int T64) {
  const int BH = gridDim.x / 2;
  const int n = blockIdx.x / BH;
  const int bh = blockIdx.x - n * BH;
  const int b = bh / H;
  const int h = bh - b * H;
  const IO* x = n == 0 ? k + b * skb + h * skh : v + b * svb + h * svh;
  fold_rows(x, n == 0 ? skt : svt, min(max(lengths[b], 0), T), T64,
            fold + (static_cast<long long>(n) * BH + bh) * T64 * kD, kFoldThreads);
}

// ---- the kernel ----

template <typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm, const IO* __restrict__ q,
                      const int* __restrict__ lengths, IO* __restrict__ o,
                      float* __restrict__ lse, int T, int T64, long long sqb, long long sqt,
                      long long sqh, long long sob, long long sot, long long soh, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (((base + 1023) & ~1023u) - base));
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int r0 = blockIdx.x * kRows;
  const int len = min(max(lengths[b], 0), T);
  const int tiles = (len + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int j = 0; j < kStages; ++j) {
      mbar_init(&sm.full[j], 1);
      mbar_init(&sm.empty[j], kConsumers);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer warp: lane 0 keeps the ring full
    if (lane == 0) {
      const int krow = (b * H + h) * T64;             // key 0 of this (batch, head) in the fold
      const int vrow = gridDim.z * H * T64 + krow;    // < 2^31: the launcher
      for (int s = 0; s < tiles; ++s) {
        const int j = s % kStages;
        if (s >= kStages) mbar_wait(&sm.empty[j], (s / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[j], 2 * kTileBytes);
        tma_2d(sm.ring[j].k, &tm, 0, krow + s * kRows, &sm.full[j], 0);
        tma_2d(sm.ring[j].v, &tm, 0, vrow + s * kRows, &sm.full[j], 0);
      }
    }
    return;
  }

  if (tiles > 0) {
    // Q / sqrt(D) rounded to bf16 into the swizzled tile, 8 values a thread
    // and step: rows tid / 8 + 16e, columns 8 (tid % 8) ..; rows past T 0
    const int col = 8 * (threadIdx.x & 7);
#pragma unroll
    for (int e = 0; e < kRows / 16; ++e) {
      const int row = (threadIdx.x >> 3) + 16 * e;
      const int t = r0 + row;
      float x[8] = {};
      if (t < T) {
        const IO* src = q + b * sqb + static_cast<long long>(t) * sqt + h * sqh + col;
        if constexpr (std::is_same_v<IO, float>) {
          const float4 a = *reinterpret_cast<const float4*>(src);
          const float4 c = *reinterpret_cast<const float4*>(src + 4);
          x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
          x[4] = c.x, x[5] = c.y, x[6] = c.z, x[7] = c.w;
        } else {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(pairs[i]);
            x[2 * i] = f.x, x[2 * i + 1] = f.y;
          }
        }
      }
      *reinterpret_cast<uint4*>(&sm.q[sw128(row, col)]) =
          make_uint4(pack_bf16(x[0] * scale, x[1] * scale), pack_bf16(x[2] * scale, x[3] * scale),
                     pack_bf16(x[4] * scale, x[5] * scale), pack_bf16(x[6] * scale, x[7] * scale));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // read next by wgmma
    consumers_sync();  // every warp's rows in place
  }

  float acc[32];  // O: acc[4j + 2i + e] row 16 warp + lane / 4 + 8i, d 8j + 2 (lane % 4) + e
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {kAttnNegInf, kAttnNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  attend_tiles(
      acc, m, l, sw128_desc(smem_u32(sm.q)), tiles, len,
      [&](int t) -> const KeyTile& { return sm.ring[t % kStages]; },
      [&](int t) { mbar_wait(&sm.full[t % kStages], (t / kStages) & 1); }, [](int) {},
      [&](int t) {  // a stage the producer refills: one arrival a warp
        if (t + kStages < tiles && lane == 0) mbar_arrive(&sm.empty[t % kStages]);
      });

  const int g = lane >> 2;
  const int c = lane & 3;
  const float totals[2] = {quad_sum(l[0]), quad_sum(l[1])};  // every lane, before the branch
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + 16 * warp + g + 8 * i;
    const float total = totals[i];
    if (t >= T) continue;
    const float inv = total > 0.f ? 1.f / total : 0.f;
    IO* orow = o + b * sob + static_cast<long long>(t) * sot + h * soh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = acc[4 * j + 2 * i] * inv, bb = acc[4 * j + 2 * i + 1] * inv;
      if constexpr (std::is_same_v<IO, float>) {
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * c) = make_float2(a, bb);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c) = __floats2bfloat162_rn(a, bb);
      }
    }
    if (c == 0) {
      lse[(static_cast<long long>(b) * H + h) * T + t] =
          total > 0.f ? m[i] + logf(total) : kAttnNegInf;
    }
  }
}

// ---- host side ----

int padded(int T) { return (T + kRows - 1) / kRows * kRows; }

cudaError_t check_args(int B, int T, int H, int D) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  // TMA's row coordinates and the kernel's row indices are 32-bit: the two
  // folded tensors' rows
  if (2ll * B * H * padded(T) > INT_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// the kernel's launch plan, checked against the caller's
cudaError_t check_plan(int rows_per_block, int threads, int smem_bytes, int stages) {
  return rows_per_block == kRows && threads == kThreads && smem_bytes == kSmemBytes &&
                 stages == kStages
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

cudaError_t configure() {
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<float>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<__nv_bfloat16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    }
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

// the kernel's shared memory set, then the fold ([2 B H T64, 64] bf16) as
// one tensor map, 64-row boxes in the 128-byte swizzle
cudaError_t prepare(CUtensorMap* tm, const void* fold, int B, int T, int H) {
  const cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD),
                              2ull * B * H * static_cast<cuuint64_t>(padded(T))};
  const cuuint64_t strides[1] = {2ull * kD};
  return make_map(tm, fold, 2, dims, strides, kRows);
}

template <typename IO>
void launch_fold(const void* k, const void* v, const void* lengths, void* fold, int B, int T,
                 int H, const long long (&st)[6], cudaStream_t stream) {
  flash_fwd_fold_bf16_kernel<IO><<<2 * B * H, kFoldThreads, 0, stream>>>(
      static_cast<const IO*>(k), static_cast<const IO*>(v), st[0], st[1], st[2], st[3], st[4],
      st[5], static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(fold), T, H,
      padded(T));
}

template <typename IO>
void launch_kernel(const CUtensorMap& tm, const void* q, const void* lengths, void* o, void* lse,
                   int B, int T, int H, const long long (&st)[6], float scale,
                   cudaStream_t stream) {
  const dim3 grid(padded(T) / kRows, H, B);
  flash_fwd_bf16_kernel<IO><<<grid, kThreads, kSmemBytes, stream>>>(
      tm, static_cast<const IO*>(q), static_cast<const int*>(lengths), static_cast<IO*>(o),
      static_cast<float*>(lse), T, padded(T), st[0], st[1], st[2], st[3], st[4], st[5], scale);
}

// what the kernel's entries check: the arguments and the caller's plan
cudaError_t check_call(int B, int T, int H, int D, int rows_per_block, int threads,
                       int smem_bytes, int stages) {
  const cudaError_t err = check_args(B, T, H, D);
  return err == cudaSuccess ? check_plan(rows_per_block, threads, smem_bytes, stages) : err;
}

}  // namespace

// The prologue: k, v [B, T, H, 64] with unit stride on the last axis, f32
// (bf16_io = 0; the other strides, in elements, multiples of 4) or bf16
// (bf16_io = 1; multiples of 8), 16-byte aligned; lengths: int32 [B].
// Writes fold: bf16 [2, B * H, T64, 64] (k, v folded head-major, T64 = T
// rounded up to 64; zeros at t >= lengths[b]), 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int nomad_flash_attention_bf16_fwd_fold(const void* k, const void* v,
                                                   const void* lengths, void* fold, int B, int T,
                                                   int H, int D, long long skb, long long skt,
                                                   long long skh, long long svb, long long svt,
                                                   long long svh, int bf16_io, void* stream) {
  const cudaError_t err = check_args(B, T, H, D);
  if (err != cudaSuccess || B == 0 || T == 0 || H == 0) return err;
  const long long st[6] = {skb, skt, skh, svb, svt, svh};
  auto run = bf16_io ? launch_fold<__nv_bfloat16> : launch_fold<float>;
  run(k, v, lengths, fold, B, T, H, st, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The kernel on the prologue's fold: q [B, T, H, 64] as k and v; lengths:
// int32 [B]; o: [B, T, H, 64] in q's type (unit stride on the last axis,
// the other strides even, 8-byte aligned); lse: f32 [B, H, T] contiguous.
// The launch plan (ops/flash_attention.py::flash_bf16_launch_plan): rows
// per block, threads, dynamic shared memory and the ring's stages,
// checked against the kernel's own. Returns cudaGetLastError().
extern "C" int nomad_flash_attention_bf16_fwd_kernel(
    const void* q, const void* fold, const void* lengths, void* o, void* lse, int B, int T, int H,
    int D, long long sqb, long long sqt, long long sqh, long long sob, long long sot,
    long long soh, int rows_per_block, int threads, int smem_bytes, int stages, float scale,
    int bf16_io, void* stream) {
  cudaError_t err = check_call(B, T, H, D, rows_per_block, threads, smem_bytes, stages);
  if (err != cudaSuccess || B == 0 || T == 0 || H == 0) return err;
  CUtensorMap tm;
  err = prepare(&tm, fold, B, T, H);
  if (err != cudaSuccess) return err;
  const long long st[6] = {sqb, sqt, sqh, sob, sot, soh};
  auto run = bf16_io ? launch_kernel<__nv_bfloat16> : launch_kernel<float>;
  run(tm, q, lengths, o, lse, B, T, H, st, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The whole forward in one call, as the port's wrapper runs it: the
// prologue, then the kernel, on one stream (the arguments of the two
// entries above). Returns the first error.
extern "C" int nomad_flash_attention_bf16_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* fold, void* o,
    void* lse, int B, int T, int H, int D, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh, int rows_per_block, int threads, int smem_bytes,
    int stages, float scale, int bf16_io, void* stream) {
  cudaError_t err = check_call(B, T, H, D, rows_per_block, threads, smem_bytes, stages);
  if (err != cudaSuccess || B == 0 || T == 0 || H == 0) return err;
  CUtensorMap tm;
  err = prepare(&tm, fold, B, T, H);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long kv[6] = {skb, skt, skh, svb, svt, svh};
  const long long qo[6] = {sqb, sqt, sqh, sob, sot, soh};
  auto fold_run = bf16_io ? launch_fold<__nv_bfloat16> : launch_fold<float>;
  fold_run(k, v, lengths, fold, B, T, H, kv, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto run = bf16_io ? launch_kernel<__nv_bfloat16> : launch_kernel<float>;
  run(tm, q, lengths, o, lse, B, T, H, qo, scale, s);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of K1b per SM (0 if it cannot run), of its f32 (bf16_io =
// 0) or bf16 (1) I/O flavour, at its dynamic shared memory.
extern "C" int nomad_flash_attention_bf16_fwd_occupancy(int bf16_io, int* blocks_per_sm) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16_io) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_fwd_bf16_kernel<__nv_bfloat16>, kThreads, kSmemBytes));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_bf16_kernel<float>, kThreads, kSmemBytes));
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
