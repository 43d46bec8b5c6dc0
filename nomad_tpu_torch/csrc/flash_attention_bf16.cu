// Masked multi-head attention forward, single-pass bf16 products with f32
// accumulation and an f32 softmax, head width 64 (kernel K1b).
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
// astype(float32), :50, :67-68, and stores O in q's dtype, :76, :101). The
// bf16 flavour loads q, k and v as bf16 with no rounding step (a bf16 value
// rounds to itself, and q / 8 is exact) and rounds O once from acc / l;
// LSE stays f32. The key loop is the same code, so its O is the f32
// flavour's on the upcast inputs, rounded once, bit for bit.
//
// What bounds it on an H100: bytes. At the main-path shape (B=96, T=511,
// H=12, D=64) it reads ~0.45 GB of f32 q/k/v and writes 0.15 GB of O and
// LSE (0.18 ms at 3.35 TB/s), against 77 GFLOP that the bf16 tensor cores
// do in 0.08 ms at 989 TFLOP/s. So it reads q, k and v once from device
// memory in f32 (no bf16 copy of them in device memory), converts in
// registers, and keeps the products on the tensor cores. The bf16-I/O
// flavour moves half those bytes (0.09 ms), and the operations bound it.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//   * One block of 4 warps per (64-query tile, head, batch); each warp owns
//     16 query rows. Its Q rows, scaled by 1/sqrt(D) (exact: 1/8) and
//     rounded with __float2bfloat16_rn, stay in registers as the A
//     fragments of mma.sync.m16n8k16 for the whole key loop.
//   * 64-key K and V tiles are read through their [B, T, H, D] strides
//     (f32 rounded to bf16, or bf16 as it is, 16 bytes a load) and stored
//     in shared memory (rows padded to 72 bf16: ldmatrix's 8 row addresses
//     fall in distinct banks). Keys past
//     lengths[b] are stored as 0, so a NaN there never reaches a product
//     (0 * NaN would be NaN inside the tensor core).
//   * S = Q . K^T by mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//     K's B fragments by ldmatrix; the online softmax runs on the f32
//     accumulator fragments (row max and sum over the 4 lanes of a row by
//     xor shuffles); masked keys get p = 0 by select.
//   * P is rounded to bf16 straight from the accumulator fragments into A
//     fragments (the m16n8 C layout of two key tiles is the m16n8k16 A
//     layout); V's B fragments by ldmatrix.trans; O accumulates in f32.
//   * The online softmax rounds p against the running maximum, where the TPU
//     kernel's single pass rounds it against the final one: the same bf16
//     error class, not the same bits.
//   * Every query row t < T is written, finite, padded rows included. A row
//     with no valid key (lengths[b] == 0) gets O = 0 and LSE = -1e30.
// Launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kD = 64;         // head width
constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // query rows per block, 16 per warp
constexpr int kBK = 64;        // keys per tile
constexpr int kLd = kD + 8;    // shared row stride in bf16 (144 bytes)
constexpr int kMinBlocks = 3;  // per SM (__launch_bounds__): at most 170 registers
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Elements col and col + 1 of a row, as floats.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
}

// (a, b) into elements col and col + 1 of a row (rounded to nearest-even
// bf16 in the bf16 flavour).
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

// The 64-key tile from key0 of k and v (row strides skt, svt) into the
// shared tiles ks and vs as bf16, keys at or past len as 0: f32 rows
// rounded 4 elements a load, bf16 rows as they are, 8 elements (16 bytes)
// a load; a K and a V word in each step.
template <typename T>
__device__ __forceinline__ void stage_kv(__nv_bfloat16 (*ks)[kLd], __nv_bfloat16 (*vs)[kLd],
                                         const T* kb, long long skt, const T* vb, long long svt,
                                         int key0, int len) {
  constexpr int kVec = std::is_same_v<T, float> ? 4 : 8;
#pragma unroll
  for (int e = 0; e < kBK * (kD / kVec) / kThreads; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / (kD / kVec);
    const int col = kVec * (idx % (kD / kVec));
    if constexpr (std::is_same_v<T, float>) {
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key0 + r < len) {
        kx = *reinterpret_cast<const float4*>(kb + (key0 + r) * skt + col);
        vx = *reinterpret_cast<const float4*>(vb + (key0 + r) * svt + col);
      }
      *reinterpret_cast<uint2*>(&ks[r][col]) = make_uint2(pack_bf16(kx.x, kx.y), pack_bf16(kx.z, kx.w));
      *reinterpret_cast<uint2*>(&vs[r][col]) = make_uint2(pack_bf16(vx.x, vx.y), pack_bf16(vx.z, vx.w));
    } else {
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key0 + r < len) {
        kx = *reinterpret_cast<const uint4*>(kb + (key0 + r) * skt + col);
        vx = *reinterpret_cast<const uint4*>(vb + (key0 + r) * svt + col);
      }
      *reinterpret_cast<uint4*>(&ks[r][col]) = kx;
      *reinterpret_cast<uint4*>(&vs[r][col]) = vx;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_bf16_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                      const IO* __restrict__ v, const int* __restrict__ lengths,
                      IO* __restrict__ o, float* __restrict__ lse, int T, int H,
                      long long sqb, long long sqt, long long sqh,
                      long long skb, long long skt, long long skh,
                      long long svb, long long svt, long long svh,
                      long long sob, long long sot, long long soh, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK][kLd];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row of the fragment (and row + 8)
  const int c = lane & 3;   // column pair of the fragment
  const int row0 = blockIdx.x * kBQ + (tid >> 5) * 16 + g;  // rows row0 and row0 + 8
  const int len = min(max(lengths[b], 0), T);

  // Q's A fragments for the 4 k-steps of 16: a0 (row g, cols 2c..2c+1),
  // a1 (row g+8), a2 (row g, cols 8+2c..), a3 (row g+8, cols 8+2c..);
  // rows past T are 0 and never written
  uint32_t qa[4][4];
  {
    const IO* qr0 = q + b * sqb + static_cast<long long>(row0) * sqt + h * sqh;
    const IO* qr1 = qr0 + 8 * sqt;
    const bool ok0 = row0 < T, ok1 = row0 + 8 < T;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * kk + 8 * half + 2 * c;
        const float2 x0 = ok0 ? load2(qr0 + col) : make_float2(0.f, 0.f);
        const float2 x1 = ok1 ? load2(qr1 + col) : make_float2(0.f, 0.f);
        qa[kk][2 * half] = pack_bf16(x0.x * scale, x0.y * scale);
        qa[kk][2 * half + 1] = pack_bf16(x1.x * scale, x1.y * scale);
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

  const IO* kb = k + b * skb + h * skh;
  const IO* vb = v + b * svb + h * svh;
  const int tiles = (len + kBK - 1) / kBK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int key0 = tile * kBK;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage_kv(ks, vs, kb, skt, vb, svt, key0, len);
    __syncthreads();

    // S = Q . K^T for the tile's 8 key tiles of 8 (C fragments: row g keys
    // 8j+2c, +1; row g+8 the same)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        // matrices: keys 8j..8j+7 at d 32kp + {0, 8, 16, 24}: the B fragments
        // of k-steps 2kp and 2kp + 1
        uint32_t bk[4];
        ldmatrix_x4(bk, &ks[8 * j + (lane & 7)][32 * kp + 8 * (lane >> 3)]);
        mma_bf16(s[j], qa[2 * kp], bk[0], bk[1]);
        mma_bf16(s[j], qa[2 * kp + 1], bk[2], bk[3]);
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
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &vs[16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)][16 * dp + 8 * (lane >> 4)]);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  const float totals[2] = {quad_sum(l[0]), quad_sum(l[1])};  // every lane, before the branch
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    const float total = totals[i];
    if (t >= T) continue;
    const float inv = total > 0.f ? 1.f / total : 0.f;
    IO* orow = o + b * sob + static_cast<long long>(t) * sot + h * soh;
#pragma unroll
    for (int j = 0; j < 8; ++j) store2(orow + 8 * j + 2 * c, acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    if (c == 0) {
      lse[(static_cast<long long>(b) * H + h) * T + t] = total > 0.f ? m[i] + logf(total) : kNegInf;
    }
  }
}

template <typename IO>
void launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
            void* lse, int B, int T, int H,
            long long sqb, long long sqt, long long sqh,
            long long skb, long long skt, long long skh,
            long long svb, long long svt, long long svh,
            long long sob, long long sot, long long soh, float scale, cudaStream_t stream) {
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_bf16_kernel<IO><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(q), static_cast<const IO*>(k), static_cast<const IO*>(v),
      static_cast<const int*>(lengths), static_cast<IO*>(o), static_cast<float*>(lse), T, H,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale);
}

}  // namespace

// q, k, v, o: [B, T, H, 64] with unit stride on the last axis, f32
// (bf16_io = 0; the other strides, in elements, multiples of 4) or bf16
// (bf16_io = 1; multiples of 8), 16-byte aligned; lengths: int32 [B]; lse:
// f32 [B, H, T] contiguous. Static shared memory (18,432 bytes). Returns
// cudaGetLastError().
extern "C" int nomad_flash_attention_bf16_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* lse, int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh, float scale, int bf16_io, void* stream) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  auto run = bf16_io ? launch<__nv_bfloat16> : launch<float>;
  run(q, k, v, lengths, o, lse, B, T, H, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
      sob, sot, soh, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of K1b per SM (0 if it cannot run), of its f32 (bf16_io =
// 0) or bf16 (1) I/O flavour.
extern "C" int nomad_flash_attention_bf16_fwd_occupancy(int bf16_io, int* blocks_per_sm) {
  if (bf16_io) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_fwd_bf16_kernel<__nv_bfloat16>, kThreads, 0));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_bf16_kernel<float>, kThreads, 0));
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
