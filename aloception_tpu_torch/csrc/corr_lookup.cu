// RAFT's correlation lookup, for Hopper (sm_90a).
//
// It replaces no TPU kernel. The JAX package's lookup is XLA: a gather
// (aloception_tpu/ops/correlation.py::corr_lookup) and, on its RAFT's main
// path, a one-hot matmul recast of the same lookup (corr_lookup_onehot), built
// for the TPU's matrix unit; its fused Pallas RAFT kernel was deleted in round
// 4. The kernel was added because the port's plain version
// (ops/correlation.py::corr_lookup_torch) writes an int64 index tensor and a
// float32 weight tensor of (B, N, 4, L*d*d), gathers each bilinear corner on
// its own, and writes a float32 output that the update block casts again:
// ~4-5 GB of traffic and ~40 launches a call at RAFT's Sintel batch.
//
// It computes, for the query n = (h, w) of image b and level l,
//
//   out[b, n, l*d*d + i*d + j] = bilinear sample of level l of pyramid row
//       (b, n) at (x * 2^-l + i - r, y * 2^-l + j - r),   d = 2r + 1,
//
// (x, y) = coords[b, :, h, w], the x offset on the outer axis, each of the
// four corners outside the level adding zero. The arithmetic is the plain
// version's, operation for operation and without contraction into FMAs: each
// tap's position c * 2^-l + off, its floor and fraction, the corner weights
// (1 - f) * inside and f * inside, their product wy * wx, each corner's value
// read in the pyramid's dtype and widened, value times weight, and the four
// products summed in float32 in the plain version's order of corners,
// (x0, y0), (x0, y1), (x1, y0), (x1, y1). The sum is rounded once, to the
// output's dtype, when it is stored.
//
// What bounds it on an H100 at RAFT's serving call (B 8, 55x128 queries, 4
// levels 55x128 .. 6x16, r 4, bf16 pyramid and output): bytes. Each query
// owns one row of 9,280 pyramid values (the correlation of its pixel with
// every pixel of every level), so no two queries share a byte. A window
// touches (2r+2)^2 = 100 values of a level, 10 rows of 20 bytes at level 0:
// 44.6 MB of distinct values a call and 36.5 MB of bf16 output, 81.1 MB,
// against about 0.2 GFLOP; at 3.35 TB/s that is 24.2 us. (The benchmark's
// yardstick counts the output in float32, 117.6 MB and 35.1 us.) Measured
// on an H100, a call takes ~0.094 ms, ~26 % of the 24.2 us: by design
// estimates, not profiler readings, a 20-byte row costs one or two 32-byte
// sectors (~134 MB of sectors a call), and short rows, a warp's dependent
// loads and ~35 instructions an output, not HBM's rate, set its pace.
//
// The design:
//  1. A warp owns a query. For each level it loads the (2r+2) x (2r+2) patch
//     of the pyramid row that the window's corners touch, once, into shared
//     memory as float32: lane t loads the patch's values t, t+32, ..., so the
//     lanes of one load cover 3-4 patch rows of 2r+2 contiguous values each
//     (one or two sectors a row). Values outside the level are stored as 0
//     and not read. With r and L known at compile time (RAFT's (4, 4), RAFT-
//     small's (3, 4)) every level's loads are unrolled and issued before the
//     first is used: 16 independent loads a lane in flight. Other r and L take
//     the instance with runtime loops, which takes 1.9x as long at RAFT's
//     serving call and 1.7x at RAFT-small's 368x496 (H100).
//  2. The patch starts at floor(c * 2^-l) - r on each axis. A tap's corner
//     then lies at patch index t or t+1 (c * 2^-l + off can round up to the
//     next integer, with fraction 0); the far corner of the last tap can fall
//     one past the patch, and then its weight is 0, so its index is clamped.
//     A start far outside the level is clamped to just outside it: the patch
//     is all zeros and every corner's weight is 0.
//  3. A tap's corner indices and weights depend on one axis only: the lanes
//     compute the L * 2d of them (x of tap i, y of tap j) once into a table
//     in shared memory, the plain way, tap by tap.
//  4. Lane t forms outputs t, t+32, ... of the query's L*d*d: two table reads,
//     four patch reads, the weighted sum. Channels-last puts a query's outputs
//     side by side, so a warp's 32 stores are contiguous.
//  Offsets: a row's base is 64-bit (B*N*S reaches 5.2e8 at the cell); within
//  a row they are 32-bit, and the caller guarantees S < 2^31.
//
// C interface (built with nvcc -shared, loaded with ctypes):
//   int corr_lookup(pyramid, coords, out, in_dtype, out_dtype, batch, height,
//                   width, coord_strides, levels, sizes, radius, stream)
// pyramid (batch, height*width, S) contiguous, in_dtype (0 = float32,
// 1 = bfloat16; a bfloat16 pyramid into a bfloat16 output only); coords (batch, 2, height, width) float32 with the element
// strides coord_strides[4]; out (batch, height, width, L*d*d) contiguous,
// out_dtype; sizes a host array of L (H_l, W_l) pairs, S their sum of
// products. Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxLevels = 8;
constexpr int kBlockWarps = 8;
// dynamic shared memory a block may take without opting in
constexpr int kSmemBytes = 48 * 1024;

struct Params {
  int64_t n_queries;  // batch * height * width
  int64_t row;        // S, the length of a pyramid row
  int64_t cs_b, cs_c, cs_h, cs_w;  // the coordinates' strides, elements
  int height, width, levels, radius;
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
  float scale[kMaxLevels];  // 2^-l, exact
};

// One tap of one axis: the patch indices of its two corners (premultiplied by
// the patch width for y) and their weights.
struct __align__(16) Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O>
__device__ __forceinline__ O narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The first patch position on an axis, floor(c) - r, clamped to
// [-(P + 1), size + 1] (a NaN to the low end): outside those bounds no corner
// of the window lies inside the level.
__device__ __forceinline__ int patch_start(float c, int r, int P, int size) {
  const float lo = floorf(c) - static_cast<float>(r);
  return static_cast<int>(fminf(fmaxf(lo, -static_cast<float>(P + 1)),
                                static_cast<float>(size + 1)));
}

// Tap t of an axis, as the plain version computes it: position c + (t - r),
// its floor v0 and fraction, the corners v0 and v0 + 1, each weighted by
// (1 - f) or f times whether it lies in [0, size).
__device__ __forceinline__ Tap axis_tap(float c, int t, int r, int lo, int P,
                                        int size, int stride) {
  const float v = __fadd_rn(c, static_cast<float>(t - r));
  const float v0 = floorf(v);
  const float f = __fsub_rn(v, v0);
  const float v1 = __fadd_rn(v0, 1.0f);
  const float sz = static_cast<float>(size);
  const float in0 = (v0 >= 0.0f && v0 < sz) ? 1.0f : 0.0f;
  const float in1 = (v1 >= 0.0f && v1 < sz) ? 1.0f : 0.0f;
  const float flo = static_cast<float>(lo), last = static_cast<float>(P - 1);
  Tap tap;
  tap.w0 = __fmul_rn(__fsub_rn(1.0f, f), in0);
  tap.w1 = __fmul_rn(f, in1);
  tap.i0 = static_cast<int>(fminf(fmaxf(__fsub_rn(v0, flo), 0.0f), last)) *
           stride;
  tap.i1 = static_cast<int>(fminf(fmaxf(__fsub_rn(v1, flo), 0.0f), last)) *
           stride;
  return tap;
}

// R, LV: the radius and level count, or 0 for the runtime-loop instance.
template <typename T, typename O, int R, int LV>
__global__ void __launch_bounds__(kBlockWarps * kWarp)
    corr_lookup_kernel(const T* __restrict__ pyramid,
                       const float* __restrict__ coords, O* __restrict__ out,
                       const Params p, int block_warps) {
  extern __shared__ float4 smem[];
  const int r = R ? R : p.radius;
  const int L = LV ? LV : p.levels;
  const int D = 2 * r + 1, P = 2 * r + 2;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * block_warps + warp;
  if (q >= p.n_queries) return;  // the whole warp

  // this warp's table (L * 2D taps) and patches (L * P * P floats)
  Tap* tab = reinterpret_cast<Tap*>(smem) +
             static_cast<int64_t>(warp) * (L * 2 * D + L * P * P / 4);
  float* patch = reinterpret_cast<float*>(tab + L * 2 * D);

  const int64_t hw = static_cast<int64_t>(p.height) * p.width;
  const int64_t b = q / hw, n = q - b * hw;
  const int qh = static_cast<int>(n / p.width);
  const int qw = static_cast<int>(n - static_cast<int64_t>(qh) * p.width);
  const float* c = coords + b * p.cs_b + qh * p.cs_h + qw * p.cs_w;
  const float cx = __ldg(c), cy = __ldg(c + p.cs_c);
  const T* row = pyramid + q * p.row;

  // 1. every level's patch; unrolled where r and L are known, so that the
  // loads are issued before their stores
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int hl = p.h[l], wl = p.w[l];
    const int x0 = patch_start(cx * p.scale[l], r, P, wl);
    const int y0 = patch_start(cy * p.scale[l], r, P, hl);
    const T* level = row + p.start[l];
    float* dst = patch + l * P * P;
    auto load = [&](int e) {
      const int py = e / P, px = e - py * P;
      const int y = y0 + py, x = x0 + px;
      float v = 0.0f;
      if (static_cast<unsigned>(y) < static_cast<unsigned>(hl) &&
          static_cast<unsigned>(x) < static_cast<unsigned>(wl))
        v = widen(__ldg(level + y * wl + x));
      dst[e] = v;
    };
    if (R) {
#pragma unroll
      for (int e0 = 0; e0 < (2 * R + 2) * (2 * R + 2); e0 += kWarp)
        if (e0 + lane < P * P) load(e0 + lane);
    } else {
      for (int e = lane; e < P * P; e += kWarp) load(e);
    }
  }

  // 2. the taps of both axes of every level
  for (int e = lane; e < L * 2 * D; e += kWarp) {
    const int l = e / (2 * D), t = e - l * 2 * D;
    const bool is_y = t >= D;
    const float cs = (is_y ? cy : cx) * p.scale[l];
    const int size = is_y ? p.h[l] : p.w[l];
    tab[e] = axis_tap(cs, is_y ? t - D : t, r, patch_start(cs, r, P, size), P,
                      size, is_y ? P : 1);
  }
  __syncwarp();

  // 3. the query's L*d*d samples, stored side by side
  O* dst = out + q * (static_cast<int64_t>(L) * D * D);
  for (int k = lane; k < L * D * D; k += kWarp) {
    const int l = k / (D * D), t = k - l * D * D;
    const int i = t / D, j = t - i * D;
    const Tap tx = tab[l * 2 * D + i], ty = tab[l * 2 * D + D + j];
    const float* src = patch + l * P * P;
    float acc = __fmul_rn(src[ty.i0 + tx.i0], __fmul_rn(ty.w0, tx.w0));
    acc = __fadd_rn(acc, __fmul_rn(src[ty.i1 + tx.i0], __fmul_rn(ty.w1, tx.w0)));
    acc = __fadd_rn(acc, __fmul_rn(src[ty.i0 + tx.i1], __fmul_rn(ty.w0, tx.w1)));
    acc = __fadd_rn(acc, __fmul_rn(src[ty.i1 + tx.i1], __fmul_rn(ty.w1, tx.w1)));
    dst[k] = narrow<O>(acc);
  }
}

int64_t warp_smem_bytes(int levels, int radius) {
  const int64_t d = 2 * radius + 1, P = d + 1;
  return levels * (2 * d * static_cast<int64_t>(sizeof(Tap)) + P * P * 4);
}

template <typename T, typename O, int R, int LV>
cudaError_t launch(const void* pyramid, const float* coords, void* out,
                   const Params& p, cudaStream_t stream) {
  const int64_t per_warp = warp_smem_bytes(p.levels, p.radius);
  int warps = static_cast<int>(kSmemBytes / per_warp);
  warps = warps < kBlockWarps ? warps : kBlockWarps;
  const int64_t blocks = (p.n_queries + warps - 1) / warps;
  corr_lookup_kernel<T, O, R, LV>
      <<<static_cast<unsigned>(blocks), warps * kWarp, warps * per_warp,
         stream>>>(static_cast<const T*>(pyramid), coords,
                   static_cast<O*>(out), p, warps);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_shape(const void* pyramid, const float* coords, void* out,
                         const Params& p, cudaStream_t s) {
  if (p.levels == 4 && p.radius == 4)
    return launch<T, O, 4, 4>(pyramid, coords, out, p, s);
  if (p.levels == 4 && p.radius == 3)
    return launch<T, O, 3, 4>(pyramid, coords, out, p, s);
  return launch<T, O, 0, 0>(pyramid, coords, out, p, s);
}

}  // namespace

extern "C" int corr_lookup(const void* pyramid, const float* coords,
                           void* out, int in_dtype, int out_dtype,
                           int64_t batch, int height, int width,
                           const int64_t* coord_strides, int levels,
                           const int64_t* sizes, int radius, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || batch < 0 ||
      height < 1 || width < 1 || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || (in_dtype == 1 && out_dtype == 0) ||
      warp_smem_bytes(levels, radius) > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.n_queries = batch * height * width;
  p.height = height;
  p.width = width;
  p.levels = levels;
  p.radius = radius;
  p.cs_b = coord_strides[0];
  p.cs_c = coord_strides[1];
  p.cs_h = coord_strides[2];
  p.cs_w = coord_strides[3];
  int64_t start = 0;
  for (int l = 0; l < levels; ++l) {
    if (sizes[2 * l] < 1 || sizes[2 * l + 1] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    p.h[l] = static_cast<int>(sizes[2 * l]);
    p.w[l] = static_cast<int>(sizes[2 * l + 1]);
    p.start[l] = static_cast<int>(start);
    p.scale[l] = 1.0f / static_cast<float>(1 << l);
    start += sizes[2 * l] * sizes[2 * l + 1];
  }
  if (start >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.row = start;
  for (int l = levels; l < kMaxLevels; ++l) {
    p.h[l] = p.w[l] = p.start[l] = 0;
    p.scale[l] = 0.0f;
  }
  if (p.n_queries == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 1)
    err = launch_shape<__nv_bfloat16, __nv_bfloat16>(pyramid, coords, out, p,
                                                     s);
  else if (out_dtype == 1)
    err = launch_shape<float, __nv_bfloat16>(pyramid, coords, out, p, s);
  else
    err = launch_shape<float, float>(pyramid, coords, out, p, s);
  return static_cast<int>(err);
}
