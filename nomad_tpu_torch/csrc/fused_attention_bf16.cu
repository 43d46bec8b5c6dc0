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
// What bounds it on an H100: operations. At the scoring shape (B = 96,
// T = 511, 499 keys valid, H = 12, model width 768) it does 246 GFLOP
// against 308 MB of f32 x, weights and O: 0.25 ms on the bf16 tensor
// cores at 989 TFLOP/s against 0.09 ms of memory time. So every product
// runs on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulators), x
// and the weights are read in f32 once per block and rounded on the way
// into shared memory, and Q, K and V never reach device memory.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//   * K4's thread-block cluster per (batch, head), with its two split
//     rules (ops/fused_attention.py::fused_launch_plan). T > 64: a cluster
//     of ceil(T / 64) blocks, block r projects Q, K and V of rows
//     64r .. 64r + 63 (Q only where no key of the chunk is valid) and
//     attends those query rows. T <= 64: a cluster of 3, block g projects
//     tensor g (Q, K, V) of all rows, and the three share the query rows by
//     16-row warp tiles, warp tile w going to block w % 3. Peers' K and V
//     are read through distributed shared memory: no device workspace.
//   * Phase 1, the projections: 16-wide slices of the model axis of x (64
//     rows) and of the head's weight rows (64 per tensor; nn.Linear's
//     [out, in] layout is already mma's "col" operand, so no transpose)
//     are copied in f32 by cp.async into a double buffer, rounded with
//     __float2bfloat16_rn into one bf16 slice (the staging step), and fed
//     to mma by ldmatrix. Warp w owns rows 16w .. 16w + 15 of every
//     tensor; its f32 accumulators take the bias, Q the scale 1/8 (exact),
//     and the result is stored once as bf16 in the block's own shared
//     memory, rows padded to 72 bf16 so that ldmatrix meets no bank
//     conflict. The TPU kept K_h and V_h in f32 scratch; the next DEFAULT
//     product rounds them to bf16 anyway, so the values are the same.
//   * Rows of K and V at t >= lengths[b] are stored as 0: inside the
//     tensor core 0 * NaN is NaN, so garbage in padded rows of x must
//     never reach a product of a valid row. Q of every row t < T is
//     projected from x as the TPU kernel does (a padded query row sees
//     the valid keys; its output is written, and it is finite whenever x
//     is).
//   * Phase 2 is K1b's key loop (flash_attention_bf16.cu): each warp's Q
//     rows as A fragments in registers (read from the block's own slot, or
//     block 0's for T <= 64), each 64-key tile of K and V copied from the
//     block that projected it into a local tile, S = Q . K^T through
//     ldmatrix, an online f32 softmax on the accumulator fragments, p
//     rounded to bf16 straight from them into A fragments, V through
//     ldmatrix.trans. The online softmax rounds p against the running
//     maximum, where the TPU kernel's single pass rounds it against the
//     final one: the same bf16 error class, not the same bits. A last
//     cluster barrier keeps every block's shared memory alive until its
//     peers have read it.
//   * Every query row t < T is written; a row with no valid key gets
//     O = 0. No atomics: a rerun gives the same bits.
//
// Two I/O flavours from one template: x and O in f32, or in bf16 (bf16
// activations with fused_qkv at a "default" island, where the TPU kernel
// reads the bf16 x block through astype(float32), :111, :118, and stores O
// in x's dtype, :131). The weights and biases stay f32 in both and are
// rounded into the slice as before. The bf16 flavour copies x's slices as
// bf16 by cp.async (32 bytes a row, not 64) and takes them into the
// rounded slice as they are: a bf16 value rounds to itself, so the
// staging step's rounding exists for f32 x alone. O is rounded once from
// acc / l. The products see the same operands, so its O is the f32
// flavour's on the upcast x, rounded once, bit for bit.
// Launches on the caller's stream and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;                  // head width
constexpr int kThreads = 128;           // 4 warps
constexpr int kRows = 64;               // rows of a chunk = query rows of a block = keys of a tile
constexpr int kLd = kD + 8;             // bf16 row stride of Q, K and V (144 bytes)
constexpr int kSlice = 16;              // model-axis values per phase-1 step: one mma k-step
constexpr int kLdB = kSlice + 8;        // bf16 row stride of the rounded slice (48 bytes)
constexpr int kStageRows = kRows + 3 * kD;  // x rows, then the weight rows of up to 3 tensors
constexpr int kMaxT = 1024;
constexpr int kMaxCluster = kMaxT / kRows;  // 16: past the portable 8
constexpr int kMinBlocks = 2;           // per SM (__launch_bounds__)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct ProjSmem {
  // f32 slices as cp.async lands them (rows of 16 floats read and written
  // in 16-byte pieces in thread order: no padding needed; a bf16 x row
  // fills the first 32 bytes of its row), and the slice in flight rounded
  // to bf16
  float stage[2][kStageRows][kSlice];
  __nv_bfloat16 ops[kStageRows][kLdB];
};
struct KeyTile {
  __nv_bfloat16 k[kRows][kLd];
  __nv_bfloat16 v[kRows][kLd];
};
struct Smem {
  // this block's projected rows as bf16: Q / 8, K and V of its chunk (a
  // cluster along T), or its one tensor in slot 0 (T <= 64)
  __nv_bfloat16 slot[3][kRows][kLd];
  union {
    ProjSmem proj;
    KeyTile kv;
  } u;
};
constexpr int kSmemBytes = sizeof(Smem);
static_assert(kSmemBytes == 72704, "ops/fused_attention.py::FUSED_BF16_SMEM_BYTES");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 .. r0 + 63 of xb ([T, DM], row-major, f32 or bf16; rows past T
// read as 0) times the 64 head rows of tensor kinds[n] (0: Q, 1: K, 2: V)
// of w ([DM, DM] each), in one bf16 pass with f32 sums, plus the bias in
// f32, times `scale` for Q, stored as bf16 into slot[n]; rows of K and V
// at t >= len are stored as 0. Every thread calls it alike.
template <int NT, typename XT>
__device__ __forceinline__ void project(const XT* __restrict__ xb,
                                        const float* const (&w)[3],
                                        const float* const (&bias)[3], const int (&kinds)[NT],
                                        float scale, int r0, int T, int len, int DM, int h,
                                        ProjSmem& ps, __nv_bfloat16 (*slot)[kRows][kLd]) {
  constexpr int kR = kRows + NT * kD;              // staged rows
  constexpr int kPer = kR * (kSlice / 4) / kThreads;  // 16-byte pieces per thread
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto fetch = [&](int k0, int buf) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      const int row = idx / (kSlice / 4);
      const int c = idx % (kSlice / 4);
      if (row < kRows) {
        // a bf16 row is two 16-byte pieces: pieces 2 and 3 copy nothing
        constexpr int kXVec = 16 / sizeof(XT);
        const bool ok = r0 + row < T;
        if (kXVec * c < kSlice) {
          cp_async16(reinterpret_cast<XT*>(ps.stage[buf][row]) + kXVec * c,
                     ok ? xb + static_cast<long long>(r0 + row) * DM + k0 + kXVec * c : xb,
                     ok ? 16 : 0);
        }
      } else {
        const int n = (row - kRows) / kD;
        const int r = (row - kRows) % kD;
        cp_async16(&ps.stage[buf][row][4 * c],
                   w[kinds[n]] + static_cast<long long>(h * kD + r) * DM + k0 + 4 * c, 16);
      }
    }
  };

  float acc[NT * 8][4];  // n-tile j: tensor j / 8, columns 8 (j % 8) + 2c, +1; rows g, g + 8
#pragma unroll
  for (int j = 0; j < NT * 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  const int steps = DM / kSlice;
  fetch(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slice s has landed everywhere; slice s - 1 is no longer read
    if (s + 1 < steps) {
      fetch((s + 1) * kSlice, (s + 1) & 1);
      cp_async_commit();
    }
    // the staging step: round slice s to bf16 (a bf16 x row as it is)
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      const int row = idx / (kSlice / 4);
      const int c = idx % (kSlice / 4);
      uint2 u;
      if (std::is_same_v<XT, __nv_bfloat16> && row < kRows) {
        u = reinterpret_cast<const uint2*>(ps.stage[s & 1][row])[c];
      } else {
        const float4 f = *reinterpret_cast<const float4*>(&ps.stage[s & 1][row][4 * c]);
        u = make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
      }
      *reinterpret_cast<uint2*>(&ps.ops[row][4 * c]) = u;
    }
    __syncthreads();
    // A: the warp's 16 x rows (matrices: rows 0-7 / 8-15 at k 0-7, then
    // at k 8-15); B: two n-tiles of weight rows per ldmatrix (rows 0-7 at
    // k 0-7 and k 8-15, then rows 8-15)
    uint32_t a[4];
    ldmatrix_x4(a, &ps.ops[16 * warp + (lane & 15)][8 * (lane >> 4)]);
    const int m = lane >> 3;
#pragma unroll
    for (int jp = 0; jp < NT * 4; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, &ps.ops[kRows + 16 * jp + (lane & 7) + 8 * (m >> 1)][8 * (m & 1)]);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }

  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int j = 0; j < NT * 8; ++j) {
    const int n = j / 8;
    const int kind = kinds[n];
    const int col = 8 * (j % 8) + 2 * c;
    const float b0 = bias[kind][h * kD + col];
    const float b1 = bias[kind][h * kD + col + 1];
    const float sc = kind == 0 ? scale : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * warp + g + 8 * i;
      const bool zero = kind != 0 && r0 + row >= len;
      *reinterpret_cast<uint32_t*>(&slot[n][row][col]) =
          zero ? 0u : pack_bf16((acc[j][2 * i] + b0) * sc, (acc[j][2 * i + 1] + b1) * sc);
    }
  }
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_qkv_fwd_bf16_kernel(const IO* __restrict__ x, const float* __restrict__ wq,
                          const float* __restrict__ bq, const float* __restrict__ wk,
                          const float* __restrict__ bk, const float* __restrict__ wv,
                          const float* __restrict__ bv, const int* __restrict__ lengths,
                          IO* __restrict__ o, int T, int DM, int tensors,
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
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const IO* xb = x + static_cast<long long>(b) * T * DM;
  const bool split_rows = tensors == 3;
  const float* const w[3] = {wq, wk, wv};
  const float* const bias[3] = {bq, bk, bv};

  // phase 1: this block's projections into its own shared memory
  if (split_rows) {
    const int r0 = rank * kRows;
    if (r0 < len) {
      project<3>(xb, w, bias, {0, 1, 2}, scale, r0, T, len, DM, h, sm.u.proj, sm.slot);
    } else {
      project<1>(xb, w, bias, {0}, scale, r0, T, len, DM, h, sm.u.proj, sm.slot);
    }
  } else if (rank == 0 || len > 0) {
    project<1>(xb, w, bias, {rank}, scale, 0, T, len, DM, h, sm.u.proj, sm.slot);
  }
  cluster.sync();  // every block's slots are written and visible to the cluster

  // phase 2: the key loop over the cluster's K and V
  const int q0 = split_rows ? rank * kRows : 0;
  const bool active = split_rows ? q0 + 16 * warp < T : warp % 3 == rank && 16 * warp < T;
  // the warp's Q rows as A fragments for the 4 k-steps of 16 (Q lives in
  // block 0 for T <= 64): a0 row g, d 2c..2c+1; a1 row g+8; a2, a3 at d+8
  uint32_t qa[4][4];
  if (active) {
    const __nv_bfloat16* qs =
        split_rows ? &sm.slot[0][0][0] : cluster.map_shared_rank(&sm.slot[0][0][0], 0);
    const __nv_bfloat16* qr0 = qs + (16 * warp + g) * kLd;
    const __nv_bfloat16* qr1 = qr0 + 8 * kLd;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * kk + 8 * half + 2 * c;
        qa[kk][2 * half] = *reinterpret_cast<const uint32_t*>(qr0 + col);
        qa[kk][2 * half + 1] = *reinterpret_cast<const uint32_t*>(qr1 + col);
      }
    }
  }

  float acc[8][4];  // O: d-tile j, (row g: d 8j+2c, +1; row g+8: the same)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  const int tiles = (len + kRows - 1) / kRows;
  for (int tile = 0; tile < tiles; ++tile) {
    const int key0 = tile * kRows;
    // tile `tile`'s K and V from the block that projected them (rows past
    // the bound are 0 there); every load in flight before the first store
    const __nv_bfloat16* kp = split_rows ? cluster.map_shared_rank(&sm.slot[1][0][0], tile)
                                         : cluster.map_shared_rank(&sm.slot[0][0][0], 1);
    const __nv_bfloat16* vp = split_rows ? cluster.map_shared_rank(&sm.slot[2][0][0], tile)
                                         : cluster.map_shared_rank(&sm.slot[0][0][0], 2);
    constexpr int kPer = kRows * (kD / 8) / kThreads;
    uint4 kx[kPer], vx[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / (kD / 8);
      const int ch = idx % (kD / 8);
      kx[e] = *reinterpret_cast<const uint4*>(kp + r * kLd + 8 * ch);
      vx[e] = *reinterpret_cast<const uint4*>(vp + r * kLd + 8 * ch);
    }
    __syncthreads();  // the previous tile (phase 1's buffers, first) is no longer read
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / (kD / 8);
      const int ch = idx % (kD / 8);
      *reinterpret_cast<uint4*>(&sm.u.kv.k[r][8 * ch]) = kx[e];
      *reinterpret_cast<uint4*>(&sm.u.kv.v[r][8 * ch]) = vx[e];
    }
    __syncthreads();
    if (!active) continue;

    // S = Q . K^T for the tile's 8 key tiles of 8 (C fragments: row g keys
    // 8j+2c, +1; row g+8 the same)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kp2 = 0; kp2 < 2; ++kp2) {
        // matrices: keys 8j..8j+7 at d 32kp2 + {0, 8, 16, 24}: the B
        // fragments of k-steps 2kp2 and 2kp2 + 1
        uint32_t bk4[4];
        ldmatrix_x4(bk4, &sm.u.kv.k[8 * j + (lane & 7)][32 * kp2 + 8 * (lane >> 3)]);
        mma_bf16(s[j], qa[2 * kp2], bk4[0], bk4[1]);
        mma_bf16(s[j], qa[2 * kp2 + 1], bk4[2], bk4[3]);
      }
    }

    // online softmax on the fragments; rows g (i = 0) and g + 8 (i = 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key0 + 8 * j + 2 * c + e < len;
          s[j][2 * i + e] = ok ? s[j][2 * i + e] : kNegInf;
          mx = fmaxf(mx, s[j][2 * i + e]);
        }
      }
      mx = quad_max(mx);
      const float alpha = exp2f((m[i] - mx) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key0 + 8 * j + 2 * c + e < len;
          const float p = ok ? exp2f((s[j][2 * i + e] - mx) * kLog2e) : 0.f;
          s[j][2 * i + e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }

    // O += bf16(P) . bf16(V): k-step kk covers keys 16kk..16kk+15, whose A
    // fragment is the C fragments of key tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        // matrices: keys 16kk + {0, 8} at d 16dp and 16dp + 8, transposed:
        // the B fragments of d tiles 2dp and 2dp + 1
        uint32_t bv4[4];
        ldmatrix_x4_trans(
            bv4, &sm.u.kv.v[16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)][16 * dp + 8 * (lane >> 4)]);
        mma_bf16(acc[2 * dp], pa, bv4[0], bv4[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv4[2], bv4[3]);
      }
    }
  }

  if (active) {
    const float totals[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = q0 + 16 * warp + g + 8 * i;
      if (t >= T) continue;
      const float inv = totals[i] > 0.f ? 1.f / totals[i] : 0.f;
      IO* orow = o + b * sob + static_cast<long long>(t) * sot + h * soh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float o0 = acc[j][2 * i] * inv, o1 = acc[j][2 * i + 1] * inv;
        if constexpr (std::is_same_v<IO, float>) {
          *reinterpret_cast<float2*>(orow + 8 * j + 2 * c) = make_float2(o0, o1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c) = __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
  cluster.sync();  // peers have finished reading this block's slots
}

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
cudaError_t launch(const void* x, const void* wq, const void* bq, const void* wk, const void* bk,
                   const void* wv, const void* bv, const void* lengths, void* o, int B, int T,
                   int H, int DM, long long sob, long long sot, long long soh, float scale,
                   int cluster, int tensors, cudaStream_t stream) {
  if (max_active_clusters<IO>(cluster) == 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, H, B, stream, &attr);
  return cudaLaunchKernelEx(&cfg, fused_qkv_fwd_bf16_kernel<IO>, static_cast<const IO*>(x),
                            static_cast<const float*>(wq), static_cast<const float*>(bq),
                            static_cast<const float*>(wk), static_cast<const float*>(bk),
                            static_cast<const float*>(wv), static_cast<const float*>(bv),
                            static_cast<const int*>(lengths), static_cast<IO*>(o), T, DM,
                            tensors, sob, sot, soh, scale);
}

}  // namespace

// x: [B, T, DM] contiguous, DM = H * 64, f32 (bf16_io = 0) or bf16
// (bf16_io = 1); wq, wk, wv: [DM, DM] f32 contiguous (nn.Linear's [out,
// in]); bq, bk, bv: [DM] f32; lengths: int32 [B]; o: [B, T, H, 64] in x's
// type, addressed through its strides (in elements; unit stride on the
// last axis, the others even, 8-byte aligned). T <= 1024. The launch plan
// (ops/fused_attention.py::fused_launch_plan at precision "default"):
// cluster blocks per (batch, head) along grid x, rows per block, tensors
// per block (3: a cluster along T; 1: one tensor per block, T <= 64) and
// the dynamic shared memory, each checked against the kernel's own rule. A
// cluster size the card cannot hold returns cudaErrorInvalidConfiguration.
// Returns cudaGetLastError() after the launch.
extern "C" int nomad_fused_qkv_attention_bf16_fwd(
    const void* x, const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* lengths, void* o, int B, int T, int H, int DM,
    long long sob, long long sot, long long soh, float scale, int cluster, int rows,
    int tensors, int smem_bytes, int bf16_io, void* stream) {
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
  auto run = bf16_io ? launch<__nv_bfloat16> : launch<float>;
  err = run(x, wq, bq, wk, bk, wv, bv, lengths, o, B, T, H, DM, sob, sot, soh, scale, cluster,
            tensors, static_cast<cudaStream_t>(stream));
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
