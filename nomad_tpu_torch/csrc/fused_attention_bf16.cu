// Projection-fused masked multi-head attention in one bf16 pass per
// product, f32 accumulation and softmax, head width 64 (kernel K4b).
//
// Replaces nomad_tpu/ops/fused_attention.py::_fused_kernel in
// mode="default" (_dot, :65-87; launched by _fused_call at :148), the
// flavour that fused_qkv runs at a "default" encoder island (the "fast"
// recipe): for each (batch b, head h), K_h = bf16(x) . bf16(Wk_h) + bk and
// V_h likewise, q = (bf16(x) . bf16(Wq_h) + bq) / 8, s = bf16(q) .
// bf16(K_h) over the keys t < lengths[b], p = exp(s - m) in f32, l the sum
// of the unrounded p, O = bf16(p) . bf16(V_h) / l. Every product takes
// operands rounded to nearest-even bf16, multiplies exactly and sums in
// f32; each bias is added in f32 after its product. K4
// (fused_attention.cu) is the f32 flavour ("highest" and "high3").
//
// What bounds it on an H100: operations, as the bound counts them. At the
// scoring shape (B = 96, T = 511, 499 keys valid, H = 12, model width 768)
// it does 246 GFLOP against 308 MB of f32 x, weights and O: 0.25 ms on
// the bf16 tensor cores at 989 TFLOP/s against 0.09 ms of memory time. So
// every product runs on the tensor cores (wgmma), and Q, K and V never
// reach device memory. Inside the kernel what sets the pace is what each
// SM must take into shared memory: a block of 64 rows needs the head's
// whole 192 x 768 weight slab (288 KB in bf16) for 19 MFLOP of
// projections, and every key tile of its cluster for the attention, about
// 4.7 GB into the SMs at the scoring shape.
//
// Design:
//   * A prologue kernel (pack_kernel) rounds the weights to bf16 once per
//     call and packs them head-major, [H, 3 * 64, DM]: rows 0-63 of head h
//     are Wq's rows 64h .. 64h + 63, then Wk's, then Wv's (nn.Linear's
//     [out, in] layout, so a row is one output feature along the model
//     axis), as the JAX package builds per_head_w outside its kernel. For
//     f32 x it rounds x to a bf16 copy in the same launch; both flavours
//     then run the one projection kernel on bf16 x, so the f32 flavour's O
//     is the bf16 flavour's before its one rounding, bit for bit. bf16(w)
//     and bf16(x) are the values the products used before, wherever they
//     are rounded.
//   * K4's thread-block cluster per (batch, head), with its two split
//     rules (ops/fused_attention.py::fused_launch_plan). T > 64: a cluster
//     of ceil(T / 64) blocks, block r projects Q, K and V of rows
//     64r .. 64r + 63 (Q only where no key of the chunk is valid) and
//     attends those query rows. T <= 64: a cluster of 3, block g projects
//     tensor g (Q, K, V) of all rows, and the three share the query rows by
//     16-row warp tiles, warp tile w going to block w % 3. Peers' K and V
//     are read through distributed shared memory: no device workspace
//     beyond the packed weights. A block is a consumer warpgroup (4 warps)
//     and a producer warp; 2 blocks an SM.
//   * Phase 1, the projections: a ring of 3 stages, each a 64-wide slice of
//     the model axis of the chunk's 64 rows of x and of the weight rows it
//     needs (all 192 of the head, or the 64 of one tensor), in TMA's
//     128-byte swizzle, one mbarrier "full" and one "empty" per stage. One
//     thread of the producer warp issues the copies. Tiles that every
//     block of the cluster needs go out once with .multicast::cluster, each
//     block issuing its share: the head's weights (T > 64; one box of
//     192 / n rows a block where the cluster size n divides the head's 24
//     swizzle atoms of 8 rows, else 8-row boxes) or x (T <= 64, the three
//     tensors of one x; 8-row boxes), so each weight byte leaves L2 once
//     per cluster. A block's own tile is one box (its 64 x rows, or its
//     tensor's 64 weight rows). x's 3-D tensor map reads rows past T as 0. A stage is refilled once every block of the cluster has released
//     it (each consumer warp arrives on every block's "empty" barrier).
//     The consumer warpgroup multiplies with wgmma m64n192k16 (Q, K and V
//     of the chunk: 96 f32 accumulators a thread) or m64n64k16 (one
//     tensor), both operands K-major from shared memory, keeping one
//     stage's products in flight while it releases the stage before. The
//     epilogue adds the bias in f32, Q's scale 1/8 (exact), and stores
//     bf16 rows of 128 bytes in the same swizzle (wgmma's operands in
//     phase 2) into shared memory that the ring used. The TPU kept K_h and
//     V_h in f32 scratch; the next DEFAULT product rounds them to bf16
//     anyway, so the values are the same.
//   * Rows of K and V at t >= lengths[b] are stored as 0: inside the
//     tensor core 0 * NaN is NaN, so garbage in padded rows of x must
//     never reach a product of a valid row (wgmma's row i of the output
//     reads row i of x alone). Q of every row t < T is projected from x as
//     the TPU kernel does (a padded query row sees the valid keys; its
//     output is written, and it is finite whenever x is).
//   * Phase 2, the key loop that K1b runs too (attention_wgmma.cuh::
//     attend_tiles): each 64-key tile of K and V is read
//     from the block that projected it through distributed shared memory
//     into registers two tiles ahead and stored into one of three local
//     tiles (16 KB a tile, copied as it lies: the swizzle is the same in
//     every block; T <= 64 also copies Q from block 0). S = Q . K^T by
//     m64n64k16 from shared memory; an online f32 softmax on the
//     accumulator fragments (unmasked where the whole tile is valid), p
//     rounded to bf16 into A fragments in registers; O += P . V by
//     m64n64k16 with A from registers and V MN-major. The scores of the
//     next tile and their softmax run while P . V of this one is in
//     flight. The online softmax rounds p against the running maximum,
//     where the TPU kernel's single pass rounds it against the final one:
//     the same bf16 error class, not the same bits (they are K1b's, the
//     same sums in the same order). A last cluster barrier keeps every
//     block's shared memory alive until its peers have read it.
//   * Every query row t < T is written; a row with no valid key gets
//     O = 0. No atomics: a rerun gives the same bits. A wait on an
//     mbarrier that outlasts ~2 s traps, so that a lost copy fails the
//     launch instead of holding the card.
//
// Two I/O flavours from one template on O's type: x and O in f32 (x
// rounded by the prologue), or in bf16 (bf16 activations with fused_qkv
// at a "default" island, where the TPU kernel reads the bf16 x block
// through astype(float32), :111, :118, and stores O in x's dtype, :131).
// The weights and biases are f32 in both; O is rounded once from acc / l.
// Launches on the caller's stream and allocates nothing: the caller hands
// in the packed weights' and the rounded x's buffers.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nomad::sm90;

constexpr int kD = 64;                  // head width
constexpr int kConsumers = 4;           // warps of the consumer warpgroup
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kRows = 64;               // rows of a chunk = query rows of a block = keys of a tile
constexpr int kK = 64;                  // model-axis values per stage: one 128-byte swizzle row
constexpr int kStages = 3;              // the ring
constexpr int kBox = 8;                 // rows of a swizzle atom (1,024 bytes): the least TMA box
constexpr int kHeadRows = 3 * kD;       // packed weight rows per head
constexpr int kMaxT = 1024;
constexpr int kMaxCluster = kMaxT / kRows;  // 16: past the portable 8
constexpr int kMinBlocks = 2;           // per SM (__launch_bounds__)

struct Stage {
  __nv_bfloat16 x[kRows * kK];       // 8 KB: the chunk's x rows
  __nv_bfloat16 w[kHeadRows * kK];   // 24 KB: the head's weight rows (or one tensor's 64)
};
struct Phase2 {
  // this block's projected rows as bf16, 64 rows of 128 bytes in the
  // swizzle: Q / 8, K and V of its chunk (a cluster along T), or its one
  // tensor in slot g (T <= 64, where blocks 1 and 2 receive Q in slot 0)
  __nv_bfloat16 slot[3][kRows * kD];
  KeyTile kv[3];  // the key tiles in flight
};
struct Smem {
  union {
    Stage ring[kStages];  // phase 1
    Phase2 p2;            // from phase 1's epilogue on
  } u;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
// the ring's tiles start on 1,024-byte boundaries (the swizzle atom); the
// dynamic shared memory is aligned by hand, hence the extra 1,024 bytes
constexpr int kSmemBytes = sizeof(Smem) + 1024;
static_assert(sizeof(Stage) % 1024 == 0, "swizzle atoms");
static_assert(sizeof(Phase2) <= sizeof(Stage) * kStages, "phase 2 fits in the ring");
static_assert(kSmemBytes == 99376, "ops/fused_attention.py::FUSED_BF16_SMEM_BYTES");

// ---- wgmma (the helpers in hopper.cuh) ----

// D[64 x 192] += A . B^T, as wgmma_m64n64
__device__ __forceinline__ void wgmma_m64n192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <int NT>
__device__ __forceinline__ void wgmma_tile(float (&d)[NT * kD / 2], uint64_t a, uint64_t b) {
  if constexpr (NT == 3) {
    wgmma_m64n192(d, a, b);
  } else {
    wgmma_m64n64(d, a, b);
  }
}

// ---- the prologue: weights packed once, f32 x rounded ----

// Row 192 h + 64 n + r of wp is row 64 h + r of tensor n (wq, wk, wv),
// rounded to bf16; then xr = bf16(x) when x is given. 8 values a thread
// and step.
__global__ void pack_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
                            const float* __restrict__ wv, __nv_bfloat16* __restrict__ wp, int DM,
                            const float* __restrict__ x, __nv_bfloat16* __restrict__ xr,
                            long long x_units) {
  const long long per_w = static_cast<long long>(DM) * DM;
  const long long w_units = 3 * per_w / 8;
  const long long total = w_units + (x ? x_units : 0);
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; u < total;
       u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float* src;
    __nv_bfloat16* dst;
    if (u < w_units) {
      const long long e = 8 * u;
      const int n = static_cast<int>(e / per_w);
      const long long rem = e - n * per_w;
      const int row = static_cast<int>(rem / DM);
      const int col = static_cast<int>(rem - static_cast<long long>(row) * DM);
      src = (n == 0 ? wq : n == 1 ? wk : wv) + rem;
      dst = wp + static_cast<long long>((row / kD) * kHeadRows + n * kD + row % kD) * DM + col;
    } else {
      const long long e = 8 * (u - w_units);
      src = x + e;
      dst = xr + e;
    }
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                                                pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
}

// ---- phase 1 ----

// The producer's loop (one thread): stage s's copies into ring slot
// s % kStages once every block in the ring has released the slot's last
// stage. T > 64 (`along_t`): this block's 64 x rows (one box) and its
// share of the head's 192 weight rows in boxes of w_box rows, multicast;
// T <= 64: its tensor's 64 weight rows (one box) and its share of x in
// 8-row boxes, multicast.
__device__ __forceinline__ void produce_ring(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                             Smem& sm, bool along_t, int rank, int parts, int b,
                                             int h, int r0, int steps, int w_box) {
  const uint16_t mask = parts > 1 ? static_cast<uint16_t>((1u << parts) - 1) : 0;
  const uint32_t stage_bytes = along_t ? sizeof(Stage) : 2 * kRows * kK * 2;
  for (int s = 0; s < steps; ++s) {
    const int j = s % kStages;
    // the slot's last stage released by every block in the ring
    if (s >= kStages) mbar_wait(&sm.empty[j], (s / kStages - 1) & 1);
    Stage& st = sm.u.ring[j];
    uint64_t* bar = &sm.full[j];
    const int k0 = s * kK;
    mbar_expect_tx(bar, stage_bytes);
    if (along_t) {
      tma_3d(st.x, tm_x, k0, r0, b, bar, 0);  // this block's 64 x rows: one box
      for (int a = rank; a < kHeadRows / w_box; a += parts) {  // its share of the weights
        tma_2d(st.w + a * w_box * kK, tm_w, k0, h * kHeadRows + a * w_box, bar, mask);
      }
    } else {
      tma_2d(st.w, tm_w, k0, h * kHeadRows + rank * kD, bar, 0);  // its tensor's 64 rows
      for (int a = rank; a < kRows / kBox; a += parts) {  // its share of x, in 8-row boxes
        tma_3d(st.x + a * kBox * kK, tm_x, k0, a * kBox, b, bar, mask);
      }
    }
  }
}

// The projections of one block: NT = 3, Q, K and V of rows r0 .. r0 + 63
// (a cluster along T, `along_t`), or NT = 1, tensor kinds[0] of them (Q of
// a chunk with no valid key, or tensor `rank` of rows 0 .. 63 for T <= 64),
// plus the bias in f32, times `scale` for Q, stored as bf16 into the slot
// of its kind; rows of K and V at t >= len are stored as 0. `parts` blocks
// of the cluster (ranks 0 .. parts - 1) take part in the ring: each issues
// its share of the shared tiles to all of them. The producer warp issues
// the copies; the consumer warpgroup multiplies and writes the slots.
template <int NT>
__device__ __forceinline__ void project(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                        Smem& sm, const float* const (&bias)[3],
                                        const int (&kinds)[NT], float scale, bool along_t,
                                        int rank, int parts, int b, int h, int r0, int len,
                                        int DM, int w_box) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int steps = DM / kK;

  if (warp == kConsumers) {  // the producer warp: lane 0 keeps the ring full
    if (lane == 0) produce_ring(tm_x, tm_w, sm, along_t, rank, parts, b, h, r0, steps, w_box);
    __syncwarp();
    return;
  }

  float acc[NT * kD / 2];
#pragma unroll
  for (int i = 0; i < NT * kD / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int j = s % kStages;
    mbar_wait(&sm.full[j], (s / kStages) & 1);
    const uint64_t da = sw128_desc(smem_u32(sm.u.ring[j].x));
    const uint64_t db = sw128_desc(smem_u32(sm.u.ring[j].w));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {  // 16 values = 32 bytes along the swizzled row
      wgmma_tile<NT>(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage s - 1 has been read: release its slot in every block
    if (s >= 1 && s - 1 + kStages < steps && lane < parts) {
      mbar_arrive_cluster(&sm.empty[(s - 1) % kStages], lane);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int jt = 0; jt < NT * 8; ++jt) {
    const int kind = kinds[jt / 8];
    const int col = 8 * (jt % 8) + 2 * c;
    const float b0 = bias[kind][h * kD + col];
    const float b1 = bias[kind][h * kD + col + 1];
    const float sc = kind == 0 ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * warp + g + 8 * i;
      const bool zero = kind != 0 && r0 + row >= len;
      *reinterpret_cast<uint32_t*>(&sm.u.p2.slot[kind][sw128(row, col)]) =
          zero ? 0u
               : pack_bf16((acc[4 * jt + 2 * i] + b0) * sc, (acc[4 * jt + 2 * i + 1] + b1) * sc);
    }
  }
  // the slots are read next by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_qkv_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bq,
                          const float* __restrict__ bk, const float* __restrict__ bv,
                          const int* __restrict__ lengths, IO* __restrict__ o, int T, int DM,
                          int tensors, int w_box, long long sob, long long sot, long long soh,
                          float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (((base + 1023) & ~1023u) - base));
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 0), T);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const bool split_rows = tensors == 3;
  const float* const bias[3] = {bq, bk, bv};
  // blocks in the ring: every block of a cluster along T; for T <= 64 the
  // three, or block 0 alone when no key is valid (K and V are all 0)
  const int parts = split_rows || len > 0 ? blocks : 1;

  if (tid == 0) {
    for (int j = 0; j < kStages; ++j) {
      mbar_init(&sm.full[j], 1);
      mbar_init(&sm.empty[j], kConsumers * parts);  // each consumer warp of each block in the ring
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block's barriers are set before a copy lands in it

  // phase 1: this block's projections into its own shared memory
  if (split_rows) {
    const int r0 = rank * kRows;
    if (r0 < len) {
      project<3>(&tm_x, &tm_w, sm, bias, {0, 1, 2}, scale, true, rank, parts, b, h, r0, len, DM,
                 w_box);
    } else {
      project<1>(&tm_x, &tm_w, sm, bias, {0}, scale, true, rank, parts, b, h, r0, len, DM,
                 w_box);
    }
  } else if (rank == 0 || len > 0) {
    project<1>(&tm_x, &tm_w, sm, bias, {rank}, scale, false, rank, parts, b, h, 0, len, DM,
               w_box);
  }
  cluster.sync();  // every block's slots are written and visible to the cluster

  // phase 2, the consumer warpgroup: the key loop over the cluster's K and
  // V. Tile k (keys 64k .. 64k + 63) is read from the block that projected
  // it through distributed shared memory into registers two tiles ahead,
  // then stored into slot k % 3 of the block's own tiles; the scores of
  // tile k + 1 and their softmax run while P . V of tile k is in flight
  const int tiles = (len + kRows - 1) / kRows;
  if (warp < kConsumers) {
    constexpr int kPer = sizeof(KeyTile) / 16 / (32 * kConsumers);  // 16-byte pieces a thread
    const int ct = tid;  // consumer thread 0 .. 127
    uint4 held[kPer];
    // tile `tile`'s K and V, 16 KB as they lie (the swizzle is the same in
    // every block), or for T <= 64 K from block 1 and V from block 2
    auto fetch = [&](int tile) {
      const uint4* kp = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(sm.u.p2.slot[1], split_rows ? tile : 1));
      const uint4* vp = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(sm.u.p2.slot[2], split_rows ? tile : 2));
#pragma unroll
      for (int e = 0; e < kPer / 2; ++e) {
        held[e] = kp[ct + e * 32 * kConsumers];
        held[kPer / 2 + e] = vp[ct + e * 32 * kConsumers];
      }
    };
    auto stash = [&](KeyTile& kt) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) reinterpret_cast<uint4*>(&kt)[ct + e * 32 * kConsumers] = held[e];
      // read next by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    const bool active = split_rows ? rank * kRows + 16 * warp < T
                                   : warp % 3 == rank && 16 * warp < T;
    float acc[32];  // O: acc[4j + 2i + e] row 16 warp + g + 8i, d 8j + 2c + e
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m[2] = {kAttnNegInf, kAttnNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
    const uint64_t dq = sw128_desc(smem_u32(sm.u.p2.slot[0]));

    if (tiles > 0) {
      if (!split_rows && rank != 0) {  // T <= 64: Q from block 0
        const uint4* qp = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(sm.u.p2.slot[0], 0));
#pragma unroll
        for (int e = 0; e < kPer / 2; ++e) {
          reinterpret_cast<uint4*>(sm.u.p2.slot[0])[ct + e * 32 * kConsumers] =
              qp[ct + e * 32 * kConsumers];
        }
      }
      fetch(0);
      stash(sm.u.p2.kv[0]);
      if (tiles > 1) {
        fetch(1);
        stash(sm.u.p2.kv[1]);
      }
      consumers_sync();
    }
    // the shared key loop (attention_wgmma.cuh): tiles `tile` and `tile + 1`
    // are in place when iteration `tile` starts; tile + 2 is fetched during
    // it and stored once tile's P . V has completed
    attend_tiles(
        acc, m, l, dq, tiles, len, [&](int t) -> const KeyTile& { return sm.u.p2.kv[t % 3]; },
        [](int) {}, [&](int t) { if (t + 2 < tiles) fetch(t + 2); },
        [&](int t) {
          if (t + 2 < tiles) stash(sm.u.p2.kv[(t + 2) % 3]);  // t - 1's slot, read by all
          consumers_sync();  // t + 2 is in place; t is no longer read
        });

    if (active) {
      const float totals[2] = {quad_sum(l[0]), quad_sum(l[1])};
      const int q0 = split_rows ? rank * kRows : 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = q0 + 16 * warp + g + 8 * i;
        if (t >= T) continue;
        const float inv = totals[i] > 0.f ? 1.f / totals[i] : 0.f;
        IO* orow = o + b * sob + static_cast<long long>(t) * sot + h * soh;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float o0 = acc[4 * jj + 2 * i] * inv, o1 = acc[4 * jj + 2 * i + 1] * inv;
          if constexpr (std::is_same_v<IO, float>) {
            *reinterpret_cast<float2*>(orow + 8 * jj + 2 * c) = make_float2(o0, o1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * c) =
                __floats2bfloat162_rn(o0, o1);
          }
        }
      }
    }
  }
  cluster.sync();  // peers have finished reading this block's slots
}

// ---- host side ----

template <typename IO>
cudaError_t configure_kernel() {
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_fwd_bf16_kernel<IO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_qkv_fwd_bf16_kernel<IO>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

cudaError_t configure(int cluster) {
  static bool done = false;
  if (!done) {
    cudaError_t err = configure_kernel<float>();
    if (err == cudaSuccess) err = configure_kernel<__nv_bfloat16>();
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

// Clusters of `cluster` blocks of one flavour that fit on the card at once
// (cached; 0 means the launch cannot run).
template <typename IO>
int max_active_clusters(int cluster) {
  static int cache[kMaxCluster + 1] = {};
  if (cache[cluster] == 0) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(cluster, 1, 1, nullptr, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fused_qkv_fwd_bf16_kernel<IO>, &cfg) != cudaSuccess) {
      n = 0;
    }
    cache[cluster] = n > 0 ? n : -1;
  }
  return cache[cluster] > 0 ? cache[cluster] : 0;
}

template <typename IO>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const void* bq,
                   const void* bk, const void* bv, const void* lengths, void* o, int B, int T,
                   int H, int DM, long long sob, long long sot, long long soh, float scale,
                   int cluster, int tensors, int w_box, cudaStream_t stream) {
  if (max_active_clusters<IO>(cluster) == 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, H, B, stream, &attr);
  return cudaLaunchKernelEx(&cfg, fused_qkv_fwd_bf16_kernel<IO>, tm_x, tm_w,
                            static_cast<const float*>(bq), static_cast<const float*>(bk),
                            static_cast<const float*>(bv), static_cast<const int*>(lengths),
                            static_cast<IO*>(o), T, DM, tensors, w_box, sob, sot, soh, scale);
}

}  // namespace

// x: [B, T, DM] contiguous, DM = H * 64, f32 (bf16_io = 0) or bf16
// (bf16_io = 1); wq, wk, wv: [DM, DM] f32 contiguous (nn.Linear's [out,
// in]); bq, bk, bv: [DM] f32; lengths: int32 [B]; o: [B, T, H, 64] in x's
// type, addressed through its strides (in elements; unit stride on the
// last axis, the others even, 8-byte aligned). wp: a bf16 [H * 192, DM]
// buffer for the packed weights; xr: a bf16 [B, T, DM] buffer for the
// rounded x when bf16_io = 0 (ignored when 1); both 16-byte aligned and
// written by this call. T <= 1024. The launch plan
// (ops/fused_attention.py::fused_launch_plan at precision "default"):
// cluster blocks per (batch, head) along grid x, rows per block, tensors
// per block (3: a cluster along T; 1: one tensor per block, T <= 64) and
// the dynamic shared memory, each checked against the kernel's own rule. A
// cluster size the card cannot hold returns cudaErrorInvalidConfiguration.
// Launches the prologue, then the kernel; returns cudaGetLastError() after
// them.
extern "C" int nomad_fused_qkv_attention_bf16_fwd(
    const void* x, const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* lengths, void* o, void* wp, void* xr, int B,
    int T, int H, int DM, long long sob, long long sot, long long soh, float scale, int cluster,
    int rows, int tensors, int threads, int smem_bytes, int bf16_io, void* stream) {
  if (B < 0 || T < 0 || H < 0 || DM != H * kD || T > kMaxT || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const int want_cluster = T <= kRows ? 3 : (T + kRows - 1) / kRows;
  const int want_tensors = T <= kRows ? 1 : 3;
  if (cluster != want_cluster || rows != kRows || tensors != want_tensors ||
      threads != kThreads || smem_bytes != kSmemBytes) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = configure(cluster);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* xb = bf16_io ? x : xr;
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(DM), static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[2] = {2ull * DM, 2ull * DM * T};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(DM),
                                static_cast<cuuint64_t>(H) * kHeadRows};
  const cuuint64_t w_strides[1] = {2ull * DM};
  // boxes: for a cluster along T, x's 64 rows of a block and the head's
  // weights in one box a block where the cluster divides its 24 atoms
  // (else 8-row boxes); for T <= 64, x in 8-row shares, a tensor's 64
  // weight rows
  const bool along_t = tensors == 3;
  const int w_box = !along_t ? kD : (kHeadRows / kBox) % cluster == 0 ? kHeadRows / cluster : kBox;
  err = make_map(&tm_x, xb, 3, x_dims, x_strides, along_t ? kRows : kBox);
  if (err == cudaSuccess) err = make_map(&tm_w, wp, 2, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return err;
  const long long x_units = bf16_io ? 0 : static_cast<long long>(B) * T * DM / 8;
  const long long units = 3ll * DM * DM / 8 + x_units;
  const int grid = static_cast<int>(std::min<long long>((units + 255) / 256, 4096));
  pack_kernel<<<grid, 256, 0, s>>>(
      static_cast<const float*>(wq), static_cast<const float*>(wk),
      static_cast<const float*>(wv), static_cast<__nv_bfloat16*>(wp), DM,
      bf16_io ? nullptr : static_cast<const float*>(x), static_cast<__nv_bfloat16*>(xr), x_units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto run = bf16_io ? launch<__nv_bfloat16> : launch<float>;
  err = run(tm_x, tm_w, bq, bk, bv, lengths, o, B, T, H, DM, sob, sot, soh, scale, cluster,
            tensors, w_box, s);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// Occupancy of K4b (its f32, bf16_io = 0, or bf16 I/O flavour) at a
// cluster size: resident blocks per SM and clusters on the card at once.
extern "C" int nomad_fused_qkv_attention_bf16_fwd_occupancy(int cluster, int bf16_io,
                                                            int* blocks_per_sm, int* clusters) {
  cudaError_t err = configure(cluster);
  if (err != cudaSuccess) return err;
  if (bf16_io) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_qkv_fwd_bf16_kernel<__nv_bfloat16>, kThreads, kSmemBytes);
    *clusters = max_active_clusters<__nv_bfloat16>(cluster);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_qkv_fwd_bf16_kernel<float>, kThreads, kSmemBytes);
    *clusters = max_active_clusters<float>(cluster);
  }
  return static_cast<int>(err);
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
