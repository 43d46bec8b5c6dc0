// LayerNorm forward over the last axis, float32 (kernel K5 of the port).
//
// Replaces nomad_tpu/ops/layernorm.py::_ln_kernel (launched by _ln_rows):
// per row, f32 mean, biased variance as mean((x - mean)^2), rsqrt(var + eps),
// then scale and shift.
//
// What bounds it on an H100: device memory. Each row is read once and
// written once (8 bytes per element) against ~8 flops per element, far
// below the card's flops-per-byte balance; at the main-path shape
// [49056, 768] that is 301 MB, ~90 us at 3.35 TB/s.
//
// Design: one warp per row, 8 rows per 256-thread block. The row stays in
// registers as float4 (D / 128 per lane), so the two statistics passes
// (mean, then the centred variance, never E[x^2] - mean^2) read no memory
// twice; neighbouring lanes load and store neighbouring 16-byte words.
// The pass over the row is a warp shuffle reduction, no shared memory and
// no __syncthreads. Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VEC float4 words per lane: rows of up to 128 * VEC floats.
template <int VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
layernorm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y,
                     int rows, int d, float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int d4 = d / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * d);
  float4 v[VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
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
  float4* yr = reinterpret_cast<float4*>(y + static_cast<size_t>(row) * d);
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
      yr[c] = o;
    }
  }
}

template <int VEC>
void launch(const float* x, const float* w, const float* b, float* y, int rows,
            int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_fwd_kernel<VEC><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      x, w, b, y, rows, d, eps);
}

}  // namespace

// x, y: [rows, d] contiguous f32, 16-byte aligned; w, b: [d] f32.
// d must be a multiple of 4 and at most 1024. Returns cudaGetLastError().
extern "C" int nomad_layernorm_fwd(const void* x, const void* w, const void* b,
                                   void* y, int rows, int d, float eps,
                                   void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 4 != 0 || d > 1024 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  switch ((d + 127) / 128) {
    case 1: launch<1>(xf, wf, bf, yf, rows, d, eps, s); break;
    case 2: launch<2>(xf, wf, bf, yf, rows, d, eps, s); break;
    case 3: launch<3>(xf, wf, bf, yf, rows, d, eps, s); break;
    case 4: launch<4>(xf, wf, bf, yf, rows, d, eps, s); break;
    case 5: launch<5>(xf, wf, bf, yf, rows, d, eps, s); break;
    case 6: launch<6>(xf, wf, bf, yf, rows, d, eps, s); break;
    case 7: launch<7>(xf, wf, bf, yf, rows, d, eps, s); break;
    default: launch<8>(xf, wf, bf, yf, rows, d, eps, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nomad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
