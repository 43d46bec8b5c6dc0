// LayerNorm forward over the last axis, f32 statistics, in f32 or bf16 I/O
// (kernel K5 of the port, and its bf16-I/O flavour).
//
// Replaces nomad_tpu/ops/layernorm.py::_ln_kernel (launched by _ln_rows):
// per row, f32 mean, biased variance as mean((x - mean)^2), rsqrt(var + eps),
// then scale and shift; the output in x's dtype (:57). The TPU kernel reads
// its rows through astype(float32), so under the trainer's fast_bf16
// (encoder_dtype = bf16) it takes and gives bf16 rows: the bf16-I/O flavour
// here, with f32 scale and shift and one rounding of each output.
//
// What bounds it on an H100: device memory. Each row is read once and
// written once (8 bytes per element in f32, 4 in bf16) against ~8 flops
// per element, far below the card's flops-per-byte balance; at the
// main-path shape [49056, 768] that is 301 MB, ~90 us at 3.35 TB/s, in
// f32, and half of it in bf16.
//
// Design: one warp per row, 8 rows per 256-thread block. The row stays in
// registers as float4 (D / 128 per lane), so the two statistics passes
// (mean, then the centred variance, never E[x^2] - mean^2) read no memory
// twice; neighbouring lanes load and store neighbouring words. The pass
// over the row is a warp shuffle reduction, no shared memory and no
// __syncthreads. One template serves both I/O types: a lane holds the same
// four elements in either (16-byte f32 words, 8-byte bf16 words), so the
// sums run in the same order and the bf16 flavour's output is the f32
// flavour's on the upcast row, rounded once, bit for bit. Launches on the
// caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Elements 4c .. 4c + 3 of a row, as floats.
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int c) {
  if constexpr (std::is_same_v<T, float>) {
    return reinterpret_cast<const float4*>(row)[c];
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(row)[c];
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

// o into elements 4c .. 4c + 3 of a row (rounded to nearest-even bf16 in
// the bf16 flavour).
template <typename T>
__device__ __forceinline__ void store4(T* row, int c, float4 o) {
  if constexpr (std::is_same_v<T, float>) {
    reinterpret_cast<float4*>(row)[c] = o;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
    reinterpret_cast<uint2*>(row)[c] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                  *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// VEC words of 4 elements per lane: rows of up to 128 * VEC elements.
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y,
                     int rows, int d, float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int d4 = d / 4;
  const T* xr = x + static_cast<size_t>(row) * d;
  float4 v[VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d4 ? load4(xr, c) : make_float4(0.f, 0.f, 0.f, 0.f);
    sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (lane + 32 * i < d4) {
      const float a = v[i].x - mean, bb = v[i].y - mean;
      const float c = v[i].z - mean, e = v[i].w - mean;
      sq += (a * a + bb * bb) + (c * c + e * e);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  T* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = lane + 32 * i;
    if (c < d4) {
      const float4 s = w4[c], t = b4[c];
      float4 o;
      o.x = (v[i].x - mean) * rstd * s.x + t.x;
      o.y = (v[i].y - mean) * rstd * s.y + t.y;
      o.z = (v[i].z - mean) * rstd * s.z + t.z;
      o.w = (v[i].w - mean) * rstd * s.w + t.w;
      store4(yr, c, o);
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, const float* w, const float* b, void* y, int rows, int d,
            float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_fwd_kernel<T, VEC><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), rows, d, eps);
}

template <typename T>
void launch_width(const void* x, const float* w, const float* b, void* y, int rows, int d,
                  float eps, cudaStream_t s) {
  switch ((d + 127) / 128) {
    case 1: launch<T, 1>(x, w, b, y, rows, d, eps, s); break;
    case 2: launch<T, 2>(x, w, b, y, rows, d, eps, s); break;
    case 3: launch<T, 3>(x, w, b, y, rows, d, eps, s); break;
    case 4: launch<T, 4>(x, w, b, y, rows, d, eps, s); break;
    case 5: launch<T, 5>(x, w, b, y, rows, d, eps, s); break;
    case 6: launch<T, 6>(x, w, b, y, rows, d, eps, s); break;
    case 7: launch<T, 7>(x, w, b, y, rows, d, eps, s); break;
    default: launch<T, 8>(x, w, b, y, rows, d, eps, s); break;
  }
}

}  // namespace

// x, y: [rows, d] contiguous, 16-byte aligned, f32 (bf16_io = 0) or bf16
// (bf16_io = 1); w, b: [d] f32. d must be a multiple of 4 and at most
// 1024. Returns cudaGetLastError().
extern "C" int nomad_layernorm_fwd(const void* x, const void* w, const void* b,
                                   void* y, int rows, int d, float eps, int bf16_io,
                                   void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > 1024 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (bf16_io) {
    launch_width<__nv_bfloat16>(x, wf, bf, y, rows, d, eps, s);
  } else {
    launch_width<float>(x, wf, bf, y, rows, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
