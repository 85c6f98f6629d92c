// Multi-scale deformable attention sampling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ms_deform_attn_pallas`
// (aloception_tpu/ops/pallas/ms_deform_attn_kernel.py:245). It computes
//
//   out[b, q, h, c] = sum_{l, p} w[b, q, h, l, p] *
//       bilinear(value_l[b, :, :, h, c], loc[b, q, h, l, p] * (W_l, H_l) - 0.5)
//
// with align_corners=False and zeros outside each level, as a direct
// 4-corner gather (the reference's ms_deform_im2col_cuda.cuh). The TPU
// kernel's one-hot MXU recast, lane padding and query padding exist because a
// TPU has no fast gather; none of them carries over.
//
// What bounds it on an H100: gather bandwidth and latency, not arithmetic.
// Each output element costs L*P*4 scattered value reads and a few FMAs each.
// At the encoder site of Deformable-DETR-R50 (bs16, 640 px, bf16) value is
// 16 * 8500 * 256 * 2 B ~= 70 MB, above the 50 MB L2; one image's value
// (~4.4 MB) fits. The design answers that simply:
//   - one thread per output element (b, q, h, c), channel fastest, so the
//     threads of a warp read neighbouring channels of one value row: each
//     corner of each point is one coalesced row read per warp;
//   - blocks are numbered with b slowest, so the blocks in flight at a time
//     work on one or two images and their gathers hit L2;
//   - loc and w are read once per point and broadcast across the warp;
//     coordinates, weights and the sum are fp32 whatever the input dtype;
//   - level shapes and starts are kernel arguments; index math is 64-bit and
//     the kernel masks its own ragged edge, so any C, Lq and level shape work.
// Staging a level in shared memory, several queries per warp and cp.async
// are later work.
//
// C interface (built with nvcc -shared, loaded with ctypes):
//   int msda_forward(value, loc, w, out, dtype, B, Len_v, nH, C, Lq, L, P,
//                    shapes, stream)
// value (B, Len_v, nH, C), loc (B, Lq, nH, L, P, 2), w (B, Lq, nH, L, P) and
// out (B, Lq, nH, C) are contiguous device arrays of one dtype (0 = float32,
// 1 = bfloat16); shapes is a host array of L (H_l, W_l) pairs. Returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int64_t start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_forward_kernel(const T* __restrict__ value, const T* __restrict__ loc,
                    const T* __restrict__ attn, T* __restrict__ out,
                    int64_t total, int64_t len_v, int n_heads, int channels,
                    int64_t len_q, int n_points, Levels levels) {
  const int64_t row = static_cast<int64_t>(n_heads) * channels;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % channels);
    const int64_t bqh = i / channels;            // (b * Lq + q) * nH + h
    const int h = static_cast<int>(bqh % n_heads);
    const int64_t b = bqh / (static_cast<int64_t>(n_heads) * len_q);

    // value[b, s, h, c] = v_base[s * row]
    const T* v_base = value + b * len_v * row + h * channels + c;
    const int64_t lp0 = bqh * levels.n * n_points;  // offset into w; loc is 2x
    float acc = 0.f;
    for (int l = 0; l < levels.n; ++l) {
      const int hl = levels.h[l];
      const int wl = levels.w[l];
      const T* v_lvl = v_base + levels.start[l] * row;
      for (int p = 0; p < n_points; ++p) {
        const int64_t k = lp0 + l * n_points + p;
        const float x = to_float(loc[2 * k]) * wl - 0.5f;
        const float y = to_float(loc[2 * k + 1]) * hl - 0.5f;
        const float a = to_float(attn[k]);
        // every corner lies outside the level (also catches NaN)
        if (!(x > -1.f && y > -1.f && x < wl && y < hl)) continue;
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float wx = x - x0f;
        const float wy = y - y0f;
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        float s = 0.f;
        if (y0 >= 0) {
          if (x0 >= 0)
            s += (1.f - wy) * (1.f - wx) *
                 to_float(v_lvl[(static_cast<int64_t>(y0) * wl + x0) * row]);
          if (x0 + 1 < wl)
            s += (1.f - wy) * wx *
                 to_float(v_lvl[(static_cast<int64_t>(y0) * wl + x0 + 1) * row]);
        }
        if (y0 + 1 < hl) {
          if (x0 >= 0)
            s += wy * (1.f - wx) *
                 to_float(v_lvl[(static_cast<int64_t>(y0 + 1) * wl + x0) * row]);
          if (x0 + 1 < wl)
            s += wy * wx *
                 to_float(v_lvl[(static_cast<int64_t>(y0 + 1) * wl + x0 + 1) * row]);
        }
        acc += a * s;
      }
    }
    out[i] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, int64_t batch, int64_t len_v, int n_heads,
                   int channels, int64_t len_q, int n_points,
                   const Levels& levels, cudaStream_t stream) {
  const int64_t total = batch * len_q * n_heads * channels;
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  // the grid-stride loop covers whatever a capped grid leaves over
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  msda_forward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const T*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(attn), static_cast<T*>(out), total, len_v,
      n_heads, channels, len_q, n_points, levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" int msda_forward(const void* value, const void* loc,
                            const void* attn, void* out, int dtype,
                            int64_t batch, int64_t len_v, int n_heads,
                            int channels, int64_t len_q, int n_levels,
                            int n_points, const int64_t* shapes,
                            void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  Levels levels;
  levels.n = n_levels;
  int64_t start = 0;
  for (int l = 0; l < n_levels; ++l) {
    levels.h[l] = static_cast<int>(shapes[2 * l]);
    levels.w[l] = static_cast<int>(shapes[2 * l + 1]);
    levels.start[l] = start;
    start += shapes[2 * l] * shapes[2 * l + 1];
  }
  if (start != len_v) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(value, loc, attn, out, batch, len_v, n_heads, channels,
                        len_q, n_points, levels, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(value, loc, attn, out, batch, len_v, n_heads,
                                channels, len_q, n_points, levels, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
