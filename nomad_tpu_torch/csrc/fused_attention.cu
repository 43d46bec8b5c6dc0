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
// time. So the projection GEMM and the key loop must keep the FMA pipes
// busy, nothing may round-trip through device memory, and the grid must
// fill the card at the loss shape (B = 32, T = 50) too.
//
// Design, for the card rather than the TPU:
//   * The TPU kernel ran its q-block grid axis in order and built K_h and
//     V_h into VMEM scratch at q-block 0 for the later q-blocks to reuse.
//     Blocks on the card run in no order, and K_h alone is 256 KB at
//     T = 1024, more than a block's 227 KB of shared memory. So each
//     (batch, head) is a thread-block cluster: its blocks project 64-row
//     chunks of Q, K and V into their own shared memory, meet at a cluster
//     barrier, and read each other's K and V tiles through distributed
//     shared memory. No workspace, no device-memory round trip.
//   * The launch plan (ops/fused_attention.py::fused_launch_plan) picks
//     the split. T > 64: a cluster of ceil(T / 64) blocks (2 .. 16), block
//     r projects Q, K and V of rows 64r .. 64r + 63 (Q only where no key is
//     valid) and attends those query rows. T <= 64: a cluster of 3, block
//     g projects tensor g (Q, K or V) of all rows, and the three share the
//     query rows by 16-row warp tiles; the loss shape then runs 1,152
//     blocks (4.4 waves at 2 blocks per SM), not 384.
//   * Phase 1 is a shared-memory-tiled f32 GEMM: slices of the model axis
//     of x (64 rows) and of the head's weight rows (64 per tensor), 16 wide
//     for three tensors and 32 for one, double-buffered with cp.async
//     (slice s + 1 loads while s computes), row-major with a
//     padded stride so the float4 reads along the model axis meet no bank
//     conflict; each thread keeps 8 rows x 4 columns per tensor in
//     registers. In nn.Linear's [out, in] layout the
//     head's weights are rows h*64 .. h*64+63, contiguous: no transpose.
//     Each output sums its 768 products by FMA in model-axis order and adds
//     the bias after.
//   * Phase 2 is K1's key loop (attention_tile.cuh): each 32-key tile is
//     copied from the shared memory of the block that projected it into a
//     local double buffer (zeros past the bound), then a register-tiled
//     online softmax. A last cluster barrier keeps every block's shared
//     memory alive until its peers have read it.
//   * Every query row t < T is written, finite, padded rows included; a
//     row with no valid key gets O = 0. Keys past the bound never enter the
//     softmax, so garbage in padded rows of x changes no valid row. No
//     atomics: the results are deterministic.
//
// An f32 x only: a bf16 x at "highest" runs K4-bf16
// (fused_attention_bf16.cu, the same products on the tensor cores).
// Launches on the caller's stream and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using nomad::kBK;
using nomad::kBQ;
using nomad::kD;
using nomad::kLd;
using nomad::kThreads;
constexpr int kRows = 64;             // rows of a chunk (= kBQ)
// model-axis floats per phase-1 step: 16 for Q, K and V (192 weight rows),
// 32 for one tensor; rows padded by 4 floats
template <int NT>
constexpr int kSlice = NT == 3 ? 16 : 32;
template <int NT>
constexpr int kStageFloats = (kRows + NT * kD) * (kSlice<NT> + 4);
constexpr int kMaxT = 1024;
constexpr int kMaxCluster = kMaxT / kRows;  // 16: past the portable 8
constexpr int kMinBlocks = 2;         // per SM

struct ProjSmem {  // two slices, each x ([kRows][ld]) then w ([NT * kD][ld])
  float f[2 * (kStageFloats<3> > kStageFloats<1> ? kStageFloats<3> : kStageFloats<1>)];
};
struct Smem {
  // this block's projected rows: Q, K, V of its chunk (a cluster along T),
  // or its one tensor in slot 0 and a copy of Q in slot 1 (T <= 64)
  float slot[3][kRows][kLd];
  union {
    ProjSmem proj;
    nomad::KeyTiles kt;
  } u;
};
constexpr int kSmemBytes = sizeof(Smem);
static_assert(kRows == kBQ, "a chunk is one query tile");

// Rows r0 .. r0+63 of xb ([T, DM], row-major) times the 64 head rows of
// each of the NT weights w[n] ([DM_out, DM]), plus bias[n], times sc[n],
// into slot[n]. Rows past T read as 0. Every thread calls it alike.
template <int NT>
__device__ __forceinline__ void project(const float* __restrict__ xb,
                                        const float* const (&w)[NT],
                                        const float* const (&bias)[NT], const float (&sc)[NT],
                                        int r0, int T, int DM, int h, ProjSmem& ps,
                                        float (*slot)[kRows][kLd]) {
  constexpr int kS = kSlice<NT>;
  constexpr int kLdX = kS + 4;
  using Rows = float[kLdX];
  const auto xs_at = [&](int buf) { return reinterpret_cast<Rows*>(ps.f + buf * kStageFloats<NT>); };
  const auto ws_at = [&](int buf) { return xs_at(buf) + kRows; };
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16 j of each tensor
  const int ty = tid / 16;  // rows ty + 8 i
  float acc[8][NT * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int n = 0; n < NT * 4; ++n) acc[i][n] = 0.f;
  }
  auto issue = [&](int k0, int buf) {
#pragma unroll
    for (int e = 0; e < kRows * (kS / 4) / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int row = idx / (kS / 4);
      const int c = idx % (kS / 4);
      const bool ok = r0 + row < T;
      nomad::cp_async16(&xs_at(buf)[row][4 * c],
                        ok ? xb + static_cast<long long>(r0 + row) * DM + k0 + 4 * c : xb,
                        ok ? 16 : 0);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < kD * (kS / 4) / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int row = idx / (kS / 4);
        const int c = idx % (kS / 4);
        nomad::cp_async16(&ws_at(buf)[n * kD + row][4 * c],
                          w[n] + static_cast<long long>(h * kD + row) * DM + k0 + 4 * c, 16);
      }
    }
  };

  const int steps = DM / kS;
  issue(0, 0);
  nomad::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    nomad::cp_async_wait<0>();
    __syncthreads();  // slice s has landed everywhere, and slice s - 1 is no longer read
    if (s + 1 < steps) {
      issue((s + 1) * kS, (s + 1) & 1);
      nomad::cp_async_commit();
    }
    const Rows* xs = xs_at(s & 1);
    const Rows* ws = ws_at(s & 1);
#pragma unroll
    for (int kk = 0; kk < kS; kk += 4) {
      float4 a[8];
      float4 bw[NT * 4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(&xs[ty + 8 * i][kk]);
#pragma unroll
      for (int n = 0; n < NT * 4; ++n) {
        bw[n] = *reinterpret_cast<const float4*>(&ws[(n / 4) * kD + tx + 16 * (n % 4)][kk]);
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
#pragma unroll
    for (int i = 0; i < 8; ++i) slot[g][ty + 8 * i][col] = (acc[i][n] + bb) * sc[g];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_qkv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                     const float* __restrict__ bq, const float* __restrict__ wk,
                     const float* __restrict__ bk, const float* __restrict__ wv,
                     const float* __restrict__ bv, const int* __restrict__ lengths,
                     float* __restrict__ o, int T, int DM, int tensors,
                     long long sob, long long sot, long long soh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 0), T);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const float* xb = x + static_cast<long long>(b) * T * DM;
  const bool split_rows = tensors == 3;

  // phase 1: this block's projections into its own shared memory
  if (split_rows) {
    const int r0 = rank * kRows;
    if (r0 < len) {
      project<3>(xb, {wq, wk, wv}, {bq, bk, bv}, {scale, 1.f, 1.f}, r0, T, DM, h, sm.u.proj,
                 sm.slot);
    } else {
      project<1>(xb, {wq}, {bq}, {scale}, r0, T, DM, h, sm.u.proj, sm.slot);
    }
  } else if (rank == 0 || len > 0) {
    const float* wg = rank == 0 ? wq : rank == 1 ? wk : wv;
    const float* bg = rank == 0 ? bq : rank == 1 ? bk : bv;
    project<1>(xb, {wg}, {bg}, {rank == 0 ? scale : 1.f}, 0, T, DM, h, sm.u.proj, sm.slot);
  }
  cluster.sync();  // every block's slots are written and visible to the cluster

  const float* qs = &sm.slot[0][0][0];
  if (!split_rows && rank != 0) {  // Q lives in block 0: copy it into slot 1
    const float* q_peer = cluster.map_shared_rank(&sm.slot[0][0][0], 0);
    for (int idx = tid; idx < kRows * (kD / 4); idx += kThreads) {
      const int r = idx / (kD / 4);
      const int c = idx % (kD / 4);
      *reinterpret_cast<float4*>(&sm.slot[1][r][4 * c]) =
          *reinterpret_cast<const float4*>(q_peer + r * kLd + 4 * c);
    }
    qs = &sm.slot[1][0][0];
  }

  // phase 2: the key loop over the cluster's K and V
  const int q0 = split_rows ? rank * kRows : 0;
  const bool active = split_rows ? q0 + warp * 16 < T : warp % 3 == rank && warp * 16 < T;
  auto stage = [&](int j, float (*ks)[kLd], float (*vs)[kLd]) {
    // tile j's K and V rows from the block that projected them, zeros past
    // the bound; every load in flight before the first store
    const int key0 = j * kBK;
    const int owner = split_rows ? key0 / kRows : 1;
    const float* kp = cluster.map_shared_rank(&sm.slot[split_rows ? 1 : 0][key0 % kRows][0], owner);
    const float* vp = split_rows
        ? cluster.map_shared_rank(&sm.slot[2][key0 % kRows][0], owner)
        : cluster.map_shared_rank(&sm.slot[0][key0 % kRows][0], 2);
    constexpr int kPer = kBK * (kD / 4) / kThreads;
    float4 kv[kPer], vv[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / (kD / 4);
      const int c = idx % (kD / 4);
      kv[e] = vv[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key0 + r < len) {
        kv[e] = *reinterpret_cast<const float4*>(kp + r * kLd + 4 * c);
        vv[e] = *reinterpret_cast<const float4*>(vp + r * kLd + 4 * c);
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / (kD / 4);
      const int c = idx % (kD / 4);
      *reinterpret_cast<float4*>(&ks[r][4 * c]) = kv[e];
      *reinterpret_cast<float4*>(&vs[r][4 * c]) = vv[e];
    }
  };
  nomad::RowState st;
  nomad::attend_keys(qs, len, active, stage, sm.u.kt, st);
  if (active) {
    nomad::write_rows(st, T - q0,
                      [&](int r) { return o + b * sob + (q0 + r) * sot + h * soh; });
  }
  cluster.sync();  // peers have finished reading this block's slots
}

cudaError_t configure(int cluster) {
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(fused_qkv_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(fused_qkv_fwd_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cluster >= 1 && cluster <= kMaxCluster ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t launch_config(int cluster, int H, int B, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `cluster` blocks that fit on the card at once (cached; 0
// means the launch cannot run).
int max_active_clusters(int cluster) {
  static int cache[kMaxCluster + 1] = {};
  if (cache[cluster] == 0) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(cluster, 1, 1, nullptr, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fused_qkv_fwd_kernel, &cfg) != cudaSuccess) n = 0;
    cache[cluster] = n > 0 ? n : -1;
  }
  return cache[cluster] > 0 ? cache[cluster] : 0;
}

cudaError_t launch(const void* x, const void* wq, const void* bq, const void* wk, const void* bk,
                   const void* wv, const void* bv, const void* lengths, void* o, int B, int T,
                   int H, int DM, long long sob, long long sot, long long soh, float scale,
                   int cluster, int tensors, cudaStream_t stream) {
  if (max_active_clusters(cluster) == 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, H, B, stream, &attr);
  return cudaLaunchKernelEx(&cfg, fused_qkv_fwd_kernel, static_cast<const float*>(x),
                            static_cast<const float*>(wq), static_cast<const float*>(bq),
                            static_cast<const float*>(wk), static_cast<const float*>(bk),
                            static_cast<const float*>(wv), static_cast<const float*>(bv),
                            static_cast<const int*>(lengths), static_cast<float*>(o), T, DM,
                            tensors, sob, sot, soh, scale);
}

}  // namespace

// x: f32 [B, T, DM] contiguous, DM = H * 64; wq, wk, wv: [DM, DM] f32
// contiguous (nn.Linear's [out, in]); bq, bk, bv: [DM] f32; lengths: int32
// [B]; o: f32 [B, T, H, 64], addressed through its strides (in elements; unit stride on the
// last axis, the others whole 16-byte words, 16-byte aligned). T <= 1024.
// The launch plan (ops/fused_attention.py::fused_launch_plan): cluster
// blocks per (batch, head) along grid x, rows per block, tensors per block
// (3: a cluster along T; 1: one tensor per block, T <= 64) and the dynamic
// shared memory, each checked against the kernel's own rule. A cluster
// size the card cannot hold returns cudaErrorInvalidConfiguration.
// Returns cudaGetLastError() after the launch.
extern "C" int nomad_fused_qkv_attention_fwd(
    const void* x, const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* lengths, void* o, int B, int T, int H, int DM,
    long long sob, long long sot, long long soh, float scale, int cluster, int rows,
    int tensors, int smem_bytes, void* stream) {
  if (B < 0 || T < 0 || H < 0 || DM != H * kD || T > kMaxT || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const int want_cluster = T <= kRows ? 3 : (T + kRows - 1) / kRows;
  const int want_tensors = T <= kRows ? 1 : 3;
  if (cluster != want_cluster || rows != kRows || tensors != want_tensors ||
      smem_bytes != kSmemBytes) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = configure(cluster);
  if (err != cudaSuccess) return err;
  err = launch(x, wq, bq, wk, bk, wv, bv, lengths, o, B, T, H, DM, sob, sot, soh, scale, cluster,
            tensors, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// Occupancy of K4 at a cluster size: resident blocks per SM and clusters
// on the card at once.
extern "C" int nomad_fused_qkv_attention_fwd_occupancy(int cluster, int* blocks_per_sm,
                                                       int* clusters) {
  cudaError_t err = configure(cluster);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fused_qkv_fwd_kernel,
                                                      kThreads, kSmemBytes);
  *clusters = max_active_clusters(cluster);
  return static_cast<int>(err);
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
