// Masked multi-head attention backward in single-pass bf16 products with
// f32 accumulation, head width 64: kernel K2b (dQ) and kernel K3b (dK, dV).
//
// Replaces nomad_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel at their own default precision
// (jax.lax.Precision.DEFAULT, :194-199, :233-238), the flavour that the
// "balanced" and "fast" configs differentiate through. Per (batch, head),
// over the keys t < lengths[b]:
//   s = (bf16(q) . bf16(k)) / sqrt(D),  p = exp(s - LSE)       (f32)
//   dp = bf16(dO) . bf16(v)^T,  ds = p o (dp - Di)               (f32)
//   K2b: dQ = Σ bf16(ds) . bf16(k) / sqrt(D)
//   K3b: dV = Σ bf16(p)^T . bf16(dO),  dK = Σ bf16(ds)^T . bf16(q) / sqrt(D)
// Every product rounds its operands to nearest-even bf16 and accumulates
// in f32; exp, the mask, Di and LSE stay f32. Di = rowsum(dO o O) is one
// plain PyTorch reduction ahead of both launches, as the JAX package
// computes it outside its kernels. K2 and K3 (flash_attention_bwd.cu) are
// the f32 flavour.
//
// Two I/O flavours from one template: q, k, v, dO and the outputs in f32,
// or in bf16 (the trainer's fast_bf16, where the TPU kernels read bf16
// blocks through astype(float32), :189-190, :230-231, and store dQ, dK and
// dV in the inputs' dtype, :219, :267-268). The bf16 flavour loads its
// operands as bf16 with no rounding step and rounds each output once; LSE
// and Di stay f32 (Di from the upcast dO and O). The loops are the same
// code, so its outputs are the f32 flavour's on the upcast inputs, rounded
// once, bit for bit.
//
// What bounds them on an H100: bytes. At the training shape [24, 499, 12,
// 64] each kernel reads ~0.2 GB of f32 q, k, v, dO (0.06 ms at 3.35 TB/s)
// against 14 * D FLOP per (query, key) pair together, 0.03 ms for both on
// the bf16 tensor cores at 989 TFLOP/s. So they read their operands once
// from device memory in f32 (no bf16 copy in device memory), convert in
// registers, and keep every product on the tensor cores. The bf16-I/O
// flavour moves half those bytes.
//
// Design (simple first, after K1b; wgmma, TMA, a copy pipeline and the
// atomic-dQ kernel are later work):
//   * One block of 4 warps per (64-row tile, head, batch), 16 rows a warp.
//     K2b's rows are queries: its Q and dO rows stay in registers as the bf16
//     A fragments of mma.sync.m16n8k16 (for S = Q K^T and dP = dO V^T), with
//     their LSE and Di. K3b's rows are keys: its K and V rows are the A
//     fragments (for S^T = K Q^T and dP^T = V dO^T).
//   * The other two operands stream in 64-row tiles, read through their
//     [B, T, H, D] strides (f32 rounded with __float2bfloat16_rn, or bf16 as
//     it is, 16 bytes a load) and stored in shared memory (rows padded to
//     72 bf16: ldmatrix's 8 row
//     addresses fall in distinct banks). K3b's tile also holds the 64 query
//     rows' LSE and Di.
//   * Past the bound: key rows at or past lengths[b] are stored as 0 in
//     shared memory (K2b) or in the fragments (K3b), because 0 * NaN is NaN
//     inside the tensor core; their p is 0 by select. K3b writes dK = dV =
//     0 for its rows past the bound. Query rows past T are 0 with p = 0. A
//     batch row with lengths[b] == 0 gets dQ = dK = dV = 0. Padded query
//     rows (lengths[b] <= t < T) attended the valid keys in the forward, so
//     their dO reaches dK and dV like any row's.
//   * P and dS are computed on the f32 accumulator fragments and rounded
//     straight into the A fragments of the next product: two m16n8 C tiles
//     are one m16n8k16 A tile. The operand that the next product reads
//     along its rows (K for dQ, dO for dV, Q for dK) comes in by
//     ldmatrix.trans from the same shared tile as the plain ldmatrix.
//   * Deterministic: no atomics; every dQ, dK and dV element is one
//     thread's sum in a fixed order, so a rerun gives the same bits.
//   * expf, not __expf, to stay within f32 rounding of the plain version.
// Launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kD = 64;         // head width
constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // resident rows per block, 16 per warp
constexpr int kTile = 64;      // streamed rows per tile
constexpr int kLd = kD + 8;    // shared row stride in bf16 (144 bytes)
constexpr int kMinBlocks = 2;  // per SM (__launch_bounds__): at most 255 registers
constexpr float kNegInf = -1e30f;

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

// The A fragments (4 k-steps of 16 over d) of rows row and row + 8 of x
// (row stride sx, in elements); rows at or past `end` are 0.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const T* x, long long sx,
                                       int row, int end) {
  const T* r0 = x + static_cast<long long>(row) * sx;
  const T* r1 = r0 + 8 * sx;
  const bool ok0 = row < end, ok1 = row + 8 < end;
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 16 * kk + 8 * half + 2 * c;
      const float2 x0 = ok0 ? load2(r0 + col) : make_float2(0.f, 0.f);
      const float2 x1 = ok1 ? load2(r1 + col) : make_float2(0.f, 0.f);
      a[kk][2 * half] = pack_bf16(x0.x, x0.y);
      a[kk][2 * half + 1] = pack_bf16(x1.x, x1.y);
    }
  }
}

// Rows r0 .. r0 + kTile - 1 of x and y (row strides sx, sy) as bf16 into
// the shared tiles xs and ys (f32 rounded 4 elements a load, bf16 as it
// is, 8 elements a load); rows at or past `end` are 0.
template <typename T>
__device__ __forceinline__ void stage(__nv_bfloat16 (*xs)[kLd], __nv_bfloat16 (*ys)[kLd],
                                      const T* x, long long sx, const T* y,
                                      long long sy, int r0, int end) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int e = 0; e < kTile * (kD / 4) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / (kD / 4);
      const int col = 4 * (idx % (kD / 4));
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (r0 + r < end) {
        a = *reinterpret_cast<const float4*>(x + (r0 + r) * sx + col);
        b = *reinterpret_cast<const float4*>(y + (r0 + r) * sy + col);
      }
      *reinterpret_cast<uint2*>(&xs[r][col]) = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
      *reinterpret_cast<uint2*>(&ys[r][col]) = make_uint2(pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kTile * (kD / 8) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / (kD / 8);
      const int col = 8 * (idx % (kD / 8));
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (r0 + r < end) {
        a = *reinterpret_cast<const uint4*>(x + (r0 + r) * sx + col);
        b = *reinterpret_cast<const uint4*>(y + (r0 + r) * sy + col);
      }
      *reinterpret_cast<uint4*>(&xs[r][col]) = a;
      *reinterpret_cast<uint4*>(&ys[r][col]) = b;
    }
  }
}

// c[j] += A . B^T over d for the 8 n-tiles of 8 rows of the shared tile
// bs (B stored [n][d]: the plain ldmatrix gives its col-major fragments).
__device__ __forceinline__ void product_nt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                           const __nv_bfloat16 (*bs)[kLd]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      // matrices: rows 8j..8j+7 at d 32kp + {0, 8, 16, 24}: the B fragments
      // of k-steps 2kp and 2kp + 1
      uint32_t b[4];
      ldmatrix_x4(b, &bs[8 * j + (lane & 7)][32 * kp + 8 * (lane >> 3)]);
      mma_bf16(c[j], a[2 * kp], b[0], b[1]);
      mma_bf16(c[j], a[2 * kp + 1], b[2], b[3]);
    }
  }
}

// acc[d-tile] += bf16(p) . B over the tile's 64 rows, p in C fragments
// (8 tiles of 8 rows), B stored [row][d] in the shared tile bs: k-step kk
// covers rows 16kk..16kk+15, whose A fragment is the C fragments of tiles
// 2kk and 2kk + 1; B's fragments by ldmatrix.trans.
__device__ __forceinline__ void product_nn(float (&acc)[8][4], const float (&p)[8][4],
                                           const __nv_bfloat16 (*bs)[kLd]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      // matrices: rows 16kk + {0, 8} at d 16dp and 16dp + 8, transposed:
      // the B fragments of d tiles 2dp and 2dp + 1
      uint32_t b[4];
      ldmatrix_x4_trans(b, &bs[16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)][16 * dp + 8 * (lane >> 4)]);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Rows row and row + 8 of the C fragments acc (times scale) into out
// (contiguous [B, T, H, 64], this (b, h)'s base), rows below `end` only;
// rounded once to nearest-even bf16 in the bf16 flavour.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, long long st, int row, int end,
                                           const float (&acc)[8][4], float scale) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row + 8 * i;
    if (t >= end) continue;
    T* orow = out + static_cast<long long>(t) * st;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = acc[j][2 * i] * scale, b = acc[j][2 * i + 1] * scale;
      if constexpr (std::is_same_v<T, float>) {
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * c) = make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c) = __floats2bfloat162_rn(a, b);
      }
    }
  }
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_bf16_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                         const IO* __restrict__ v, const IO* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         const int* __restrict__ lengths, IO* __restrict__ dq, int T, int H,
                         long long sqb, long long sqt, long long sqh,
                         long long skb, long long skt, long long skh,
                         long long svb, long long svt, long long svh,
                         long long sdb, long long sdt, long long sdh, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile][kLd];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16 + (lane >> 2);  // and row0 + 8
  const int len = min(max(lengths[b], 0), T);

  uint32_t qa[4][4], da[4][4];
  load_a(qa, q + b * sqb + h * sqh, sqt, row0, T);
  load_a(da, dout + b * sdb + h * sdh, sdt, row0, T);
  float row_lse[2], row_di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row0 + 8 * i < T;
    const long long at = (static_cast<long long>(b) * H + h) * T + row0 + 8 * i;
    row_lse[i] = ok ? lse[at] : 0.f;
    row_di[i] = ok ? di[at] : 0.f;
  }

  float acc[8][4];  // dQ: d-tile j, (row g: d 8j+2c, +1; row g+8: the same)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  const IO* kb = k + b * skb + h * skh;
  const IO* vb = v + b * svb + h * svh;
  const int tiles = (len + kTile - 1) / kTile;
  for (int tile = 0; tile < tiles; ++tile) {
    const int key0 = tile * kTile;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage(ks, vs, kb, skt, vb, svt, key0, len);
    __syncthreads();

    float ds[8][4], dp[8][4];
    product_nt(ds, qa, ks);  // the scores, unscaled
    product_nt(dp, da, vs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = key0 + 8 * j + 2 * c + (e & 1) < len;
        const float p = ok ? expf(ds[j][e] * scale - row_lse[i]) : 0.f;
        ds[j][e] = p * (dp[j][e] - row_di[i]);
      }
    }
    product_nn(acc, ds, ks);
  }
  store_rows(dq + (static_cast<long long>(b) * T * H + h) * kD, static_cast<long long>(H) * kD,
             row0, T, acc, scale);
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_bf16_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                          const IO* __restrict__ v, const IO* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          const int* __restrict__ lengths, IO* __restrict__ dk,
                          IO* __restrict__ dv, int T, int H,
                          long long sqb, long long sqt, long long sqh,
                          long long skb, long long skt, long long skh,
                          long long svb, long long svt, long long svh,
                          long long sdb, long long sdt, long long sdh, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile][kLd];
  __shared__ float tile_lse[kTile];
  __shared__ float tile_di[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16 + (lane >> 2);  // and row0 + 8
  const int len = min(max(lengths[b], 0), T);
  const long long so = static_cast<long long>(H) * kD;
  IO* dkb = dk + (static_cast<long long>(b) * T * H + h) * kD;
  IO* dvb = dv + (static_cast<long long>(b) * T * H + h) * kD;

  float gk[8][4], gv[8][4];  // dK, dV: d-tile j, rows g and g + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;
  }
  if (static_cast<int>(blockIdx.x) * kRows >= len) {  // every row past the bound
    store_rows(dkb, so, row0, T, gk, 1.f);
    store_rows(dvb, so, row0, T, gv, 1.f);
    return;
  }

  uint32_t ka[4][4], va[4][4];
  load_a(ka, k + b * skb + h * skh, skt, row0, len);
  load_a(va, v + b * svb + h * svh, svt, row0, len);
  const bool key_ok[2] = {row0 < len, row0 + 8 < len};

  const IO* qb = q + b * sqb + h * sqh;
  const IO* db = dout + b * sdb + h * sdh;
  const float* lse_b = lse + (static_cast<long long>(b) * H + h) * T;
  const float* di_b = di + (static_cast<long long>(b) * H + h) * T;
  const int tiles = (T + kTile - 1) / kTile;
  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();  // the previous tile is no longer read
    stage(qs, dos, qb, sqt, db, sdt, q0, T);
    if (threadIdx.x < kTile) {
      const int t = q0 + threadIdx.x;
      tile_lse[threadIdx.x] = t < T ? lse_b[t] : 0.f;
      tile_di[threadIdx.x] = t < T ? di_b[t] : 0.f;
    }
    __syncthreads();

    float p[8][4];  // P^T: key rows g, g + 8; query columns 8j + 2c, +1
    product_nt(p, ka, qs);  // the scores, unscaled
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1);
        const bool ok = key_ok[e >> 1] && q0 + col < T;
        p[j][e] = ok ? expf(p[j][e] * scale - tile_lse[col]) : 0.f;
      }
    }
    product_nn(gv, p, dos);  // dV += bf16(P^T) . bf16(dO)
    float dpt[8][4];
    product_nt(dpt, va, dos);  // dP^T = V . dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dpt[j][e] - tile_di[8 * j + 2 * c + (e & 1)];
    }
    product_nn(gk, p, qs);  // dK += bf16(dS^T) . bf16(Q)
  }
  // rows past the bound: their p was 0, so 0 here; written as 0 all the same
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key_ok[i]) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) gk[j][2 * i] = gk[j][2 * i + 1] = gv[j][2 * i] = gv[j][2 * i + 1] = 0.f;
  }
  store_rows(dkb, so, row0, T, gk, scale);
  store_rows(dvb, so, row0, T, gv, 1.f);
}

cudaError_t check_args(int B, int T, int H, int D) {
  if (D != kD || B < 0 || T < 0 || H < 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename IO>
void launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, const void* lengths, void* dq, int B, int T, int H,
               long long sqb, long long sqt, long long sqh,
               long long skb, long long skt, long long skh,
               long long svb, long long svt, long long svh,
               long long sdb, long long sdt, long long sdh, float scale, cudaStream_t stream) {
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  flash_bwd_dq_bf16_kernel<IO><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(q), static_cast<const IO*>(k), static_cast<const IO*>(v),
      static_cast<const IO*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<const int*>(lengths), static_cast<IO*>(dq),
      T, H, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh, scale);
}

template <typename IO>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* di, const void* lengths, void* dk, void* dv, int B, int T, int H,
                long long sqb, long long sqt, long long sqh,
                long long skb, long long skt, long long skh,
                long long svb, long long svt, long long svh,
                long long sdb, long long sdt, long long sdh, float scale, cudaStream_t stream) {
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_bf16_kernel<IO><<<grid, kThreads, 0, stream>>>(
      static_cast<const IO*>(q), static_cast<const IO*>(k), static_cast<const IO*>(v),
      static_cast<const IO*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<const int*>(lengths), static_cast<IO*>(dk),
      static_cast<IO*>(dv), T, H, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdb, sdt, sdh,
      scale);
}

template <typename IO>
int occupancy(int dkv, int* blocks_per_sm) {
  if (dkv) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_bwd_dkv_bf16_kernel<IO>, kThreads, 0));
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_bwd_dq_bf16_kernel<IO>, kThreads, 0));
}

}  // namespace

// q, k, v, dout: [B, T, H, 64] with unit stride on the last axis, f32
// (bf16_io = 0; the other strides, in elements, multiples of 4) or bf16
// (bf16_io = 1; multiples of 8), 16-byte aligned; lse, di: f32 [B, H, T]
// contiguous; lengths: int32 [B]; dq: [B, T, H, 64] contiguous, f32 or
// bf16 as the inputs. Static shared memory (18,432 bytes). Returns
// cudaGetLastError().
extern "C" int nomad_flash_attention_bwd_bf16_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* lengths, void* dq,
    int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, float scale, int bf16_io, void* stream) {
  const cudaError_t err = check_args(B, T, H, D);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  auto run = bf16_io ? launch_dq<__nv_bfloat16> : launch_dq<float>;
  run(q, k, v, dout, lse, di, lengths, dq, B, T, H, sqb, sqt, sqh, skb, skt, skh,
      svb, svt, svh, sdb, sdt, sdh, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// As above; dk, dv: [B, T, H, 64] contiguous, f32 or bf16 as the inputs.
// Static shared memory (18,944 bytes).
extern "C" int nomad_flash_attention_bwd_bf16_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* lengths, void* dk, void* dv,
    int B, int T, int H, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, float scale, int bf16_io, void* stream) {
  const cudaError_t err = check_args(B, T, H, D);
  if (err != cudaSuccess) return err;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  auto run = bf16_io ? launch_dkv<__nv_bfloat16> : launch_dkv<float>;
  run(q, k, v, dout, lse, di, lengths, dk, dv, B, T, H, sqb, sqt, sqh, skb, skt, skh,
      svb, svt, svh, sdb, sdt, sdh, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of K2b (dkv = 0) or K3b (dkv = 1), of their f32
// (bf16_io = 0) or bf16 (1) I/O flavour; 0 if it cannot run.
extern "C" int nomad_flash_attention_bwd_bf16_occupancy(int dkv, int bf16_io,
                                                        int* blocks_per_sm) {
  return bf16_io ? occupancy<__nv_bfloat16>(dkv, blocks_per_sm)
                 : occupancy<float>(dkv, blocks_per_sm);
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
