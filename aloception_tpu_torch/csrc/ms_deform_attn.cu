// Multi-scale deformable attention sampling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ms_deform_attn_pallas`
// (aloception_tpu/ops/pallas/ms_deform_attn_kernel.py:245, its pallas_call at
// :293). It computes
//
//   out[b, q, h, c] = sum_{l, p} w[b, q, h, l, p] *
//       bilinear(value_l[b, :, :, h, c], loc[b, q, h, l, p] * (W_l, H_l) - 0.5)
//
// with align_corners=False and zeros outside each level. The TPU kernel
// recasts the sampling as one-hot MXU products (`_coeff_plane` :69, `_kernel`
// :108, `_corner_indices_weights` :204) because a TPU has no fast gather. That
// does not carry over: MSDA is a gather with 4 FMAs per corner per channel,
// not a matrix product, so tensor cores do not apply.
//
// What bounds it on an H100, at Deformable-DETR-R50's sites (bs16, 640 px,
// bf16, nH = 8, C = 32, L = P = 4):
//   - encoder, Lq = Len_v = 8500: value 69.6 MB, loc 69.6 MB, w 34.8 MB and
//     out 69.6 MB cross HBM once, 243.7 MB or 0.073 ms at 3.35 TB/s. With the
//     attention weight folded into the 4 bilinear corner weights there are 64
//     FMAs per output element, 4.46 GFLOP or 0.067 ms at 67 TFLOP/s fp32. So
//     the site is HBM-bound. The gathers also pull 64 B corner rows from L2 to
//     the SMs, 4.46 GB, about 0.8 ms at a rough 5.5 TB/s: the practical floor
//     of a gather;
//   - decoder, Lq = 300: the value rows its points touch plus 6 MB of loc, w
//     and out; at most all of value, about 0.023 ms.
//
// The design, step by step:
//  1. A group of G = C * itemsize / VEC threads serves one (b, q, h) triple.
//     Each thread owns VEC bytes of channels (16 B: 8 bf16 or 4 fp32), loads
//     them with one ld.global.nc per corner, sums them in fp32 registers and
//     stores them with one VEC-byte store. Triples are numbered with h fastest,
//     so a bf16 warp holds the 8 heads of one query and its loc and w are
//     contiguous. Where 16 B does not divide C * itemsize or a pointer, VEC is
//     8, 4 or 2 bytes: another instance of the same template.
//  2. Coordinate work is done once per point, not per channel: a point's
//     clamped corner offsets and four fp32 corner weights (bilinear weight x
//     in-level validity x attention weight) are computed by one thread of a
//     group of at least P threads (4 in bf16 at C = 32: thread j takes point j
//     of each level) and handed to the others with __shfl_sync. A smaller
//     group has each thread compute all its points from vector loads of loc
//     and w; for a group of 4 that is about 7 % slower at the encoder site on
//     an H100 (chip_smoke.py times both). It is
//     branch-free: a corner outside its level gets weight 0 and a clamped,
//     valid address; a NaN or fully outside point gets weight 0 at (0, 0), so
//     it adds exactly 0. Offsets are 32-bit within one image (the caller
//     guarantees Len_v * nH * C < 2^31); only the batch base is 64-bit.
//  3. (L, P) = (4, 4), the model's, is instantiated with every point unrolled,
//     so the compiler can issue many independent corner gathers before the
//     first FMA, under a cap of 85 registers (3 blocks an SM), with no spill.
//     Any other L <= 8 and P takes the runtime-loop instance.
//  4. Split launch: when the triples fill under about two waves of resident
//     warps (the decoder's 38,400), S sub-groups of each triple take L / S
//     levels each, and their partial sums meet by __shfl_xor_sync.
//  5. Blocks run batch-slowest, so the blocks in flight gather from one
//     image's value (4.35 MB at the encoder site) in the 50 MB L2. Value is not
//     staged in shared memory: one head's level 0 at 640 px is
//     80 * 80 * 32 * 2 B = 410 KB, above the 227 KB a block may use. A
//     persistent grid (2 to 8 blocks an SM) that walks query tiles and stages
//     the next tile's loc and w in shared memory by cp.async was tried and
//     was slower at both sites: loc and w are not what holds the gathers.
// The launch plan (VEC, S, unrolled or not, shared points or not) is chosen by
// ops/cuda/ms_deform_attn_kernel.py::launch_plan and passed in here.
//
// C interface (built with nvcc -shared, loaded with ctypes):
//   int msda_forward(value, loc, w, out, dtype, B, Len_v, nH, C, Lq, L, P,
//                    shapes, vec_bytes, split, unrolled, share_points, stream)
// value (B, Len_v, nH, C), loc (B, Lq, nH, L, P, 2), w (B, Lq, nH, L, P) and
// out (B, Lq, nH, C) are contiguous device arrays of one dtype (0 = float32,
// 1 = bfloat16); shapes is a host array of L (H_l, W_l) pairs. Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for a plan
// or shape the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
// blocks an SM must hold: 3 caps a thread at 85 registers, under which no
// instance spills
constexpr int kMinBlocks = 3;
constexpr int kUnrolledL = 4, kUnrolledP = 4;

struct Params {
  int64_t n_triples;          // B * Lq * nH
  int64_t triples_per_image;  // Lq * nH
  int64_t image_elems;        // Len_v * nH * C: one image's value
  int n_heads, channels, row;  // row = nH * C
  int n_levels, n_points;
  int groups;    // G: threads of a sub-group that own channels
  int log2_gp;   // a sub-group is 2^log2_gp >= G threads
  int log2_tpt;  // a triple is 2^log2_tpt threads: split sub-groups
  int split;
  int share_points;  // the unrolled instance shares points by shuffles
  int h[kMaxLevels], w[kMaxLevels];
  int start[kMaxLevels];      // first row of each level
};

// BYTES of global memory as 32-bit words, through the read-only path
template <int BYTES>
__device__ __forceinline__ void ldg_words(const void* p, uint32_t* w) {
  if constexpr (BYTES == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (BYTES == 4) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  } else {
    static_assert(BYTES == 2, "loads of 2, 4, 8 or 16 bytes");
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

// N elements of T packed little-endian in words -> float
template <typename T, int N>
__device__ __forceinline__ void words_to_floats(const uint32_t* w, float* f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value)
      f[i] = __uint_as_float(w[i]);
    else
      f[i] = __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
}

// N elements at p (aligned to CHUNK bytes) -> float, CHUNK bytes a load
template <typename T, int N, int CHUNK>
__device__ __forceinline__ void load_floats(const T* p, float* f) {
  constexpr int kPer = CHUNK / static_cast<int>(sizeof(T));
  static_assert(kPer >= 1 && N % kPer == 0, "chunks must tile the run");
#pragma unroll
  for (int i = 0; i < N; i += kPer) {
    uint32_t w[(CHUNK + 3) / 4];
    ldg_words<CHUNK>(p + i, w);
    words_to_floats<T, kPer>(w, f + i);
  }
}

template <typename T>
__device__ __forceinline__ float load_float(const T* p) {
  float f;
  load_floats<T, 1, sizeof(T)>(p, &f);
  return f;
}

// VEC bytes of floats, rounded to T, stored at p
template <typename T, int VEC>
__device__ __forceinline__ void store_floats(T* p, const float* f) {
  constexpr int N = VEC / static_cast<int>(sizeof(T));
  uint32_t w[(VEC + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value)
      w[i] = __float_as_uint(f[i]);
    else
      w[i >> 1] |= static_cast<uint32_t>(
                       __bfloat16_as_ushort(__float2bfloat16_rn(f[i])))
                   << (16 * (i & 1));
  }
  if constexpr (VEC == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (VEC == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else if constexpr (VEC == 4)
    *reinterpret_cast<unsigned int*>(p) = w[0];
  else
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
}

// The bilinear sample at (lx * wl - 0.5, ly * hl - 0.5) of the level that
// starts at row `start`, as four corners: element offsets from row 0 (clamped
// into the level) and fp32 weights that fold in the bilinear weight, the
// corner's validity and the attention weight a.
__device__ __forceinline__ void corners(int row, int start, int hl, int wl,
                                        float lx, float ly, float a,
                                        int (&off)[4], float (&wt)[4]) {
  const float x = lx * wl - 0.5f;
  const float y = ly * hl - 0.5f;
  // false for NaN, and where all four corners lie outside the level
  const bool in = x > -1.f && y > -1.f && x < wl && y < hl;
  const float xc = in ? x : 0.f;
  const float yc = in ? y : 0.f;
  const float x0f = floorf(xc);
  const float y0f = floorf(yc);
  const float fx = xc - x0f;
  const float fy = yc - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const float ay = in ? a : 0.f;
  const float wy0 = y0 >= 0 ? ay * (1.f - fy) : 0.f;
  const float wy1 = y0 + 1 < hl ? ay * fy : 0.f;
  const float wx0 = x0 >= 0 ? 1.f - fx : 0.f;
  const float wx1 = x0 + 1 < wl ? fx : 0.f;
  const int r0 = start + max(y0, 0) * wl;
  const int r1 = start + min(y0 + 1, hl - 1) * wl;
  const int c0 = max(x0, 0);
  const int c1 = min(x0 + 1, wl - 1);
  off[0] = (r0 + c0) * row; wt[0] = wy0 * wx0;
  off[1] = (r0 + c1) * row; wt[1] = wy0 * wx1;
  off[2] = (r1 + c0) * row; wt[2] = wy1 * wx0;
  off[3] = (r1 + c1) * row; wt[3] = wy1 * wx1;
}

// acc += the four corners' weighted channels; vb points at this thread's
// channels of row 0 of the image, for its head
template <typename T, int VEC>
__device__ __forceinline__ void gather(const T* __restrict__ vb,
                                       const int (&off)[4],
                                       const float (&wt)[4], float* acc) {
  constexpr int E = VEC / static_cast<int>(sizeof(T));
  float v[4][E];
#pragma unroll
  for (int c = 0; c < 4; ++c) load_floats<T, E, VEC>(vb + off[c], v[c]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(wt[c], v[c][e], acc[e]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void sample(const T* __restrict__ vb, int row,
                                       int start, int hl, int wl, float lx,
                                       float ly, float a, float* acc) {
  int off[4];
  float wt[4];
  corners(row, start, hl, wl, lx, ly, a, off, wt);
  gather<T, VEC>(vb, off, wt, acc);
}

// The unrolled instance's sum over LPS levels from l0, for one sub-group.
// SHARE: thread g of a sub-group of at least P threads computes point g % P
// of each level, and the sub-group's first P lanes hand their corners round
// by shuffles; else every thread computes every point.
template <typename T, int VEC, int LPS, int P, bool SHARE>
__device__ __forceinline__ void unrolled_levels(
    const T* __restrict__ vb, const T* __restrict__ loc,
    const T* __restrict__ attn, const Params& prm, int64_t triple, int l0,
    int g, float* acc) {
  constexpr int E = VEC / static_cast<int>(sizeof(T));
  // loc of one level is P * 2 elements, w P: whole vectors of 16 or 8 B
  constexpr int kLocChunk = P * 2 * sizeof(T) < 16 ? P * 2 * sizeof(T) : 16;
  constexpr int kWChunk = P * sizeof(T) < 16 ? P * sizeof(T) : 16;
  // levels unrolled together: all of them without a split, else one at a
  // time; also one at a time for vectors of 1 or 2 elements. Under the
  // 85-register cap the others spill (the split-2 bf16 instance, and many
  // small loads in flight)
  constexpr int kU = E > 2 && LPS == kUnrolledL ? LPS : 1;
  const int first = static_cast<int>(threadIdx.x & 31) &
                    ~((1 << prm.log2_gp) - 1);
#pragma unroll 1
  for (int i0 = 0; i0 < LPS; i0 += kU) {
#pragma unroll
    for (int i = i0; i < i0 + kU; ++i) {
      const int l = l0 + i;
      const int hl = prm.h[l], wl = prm.w[l], st = prm.start[l];
      const int64_t k0 = (triple * prm.n_levels + l) * P;
      if constexpr (SHARE) {
        const int64_t k = k0 + (g & (P - 1));
        float xy[2];
        load_floats<T, 2, 2 * sizeof(T)>(loc + 2 * k, xy);
        int off[4];
        float wt[4];
        corners(prm.row, st, hl, wl, xy[0], xy[1], load_float(attn + k), off,
                wt);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          int o[4];
          float w[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            o[c] = __shfl_sync(0xffffffffu, off[c], first + p);
            w[c] = __shfl_sync(0xffffffffu, wt[c], first + p);
          }
          gather<T, VEC>(vb, o, w, acc);
        }
      } else {
        float xy[P * 2], aw[P];
        load_floats<T, P * 2, kLocChunk>(loc + 2 * k0, xy);
        load_floats<T, P, kWChunk>(attn + k0, aw);
#pragma unroll
        for (int p = 0; p < P; ++p)
          sample<T, VEC>(vb, prm.row, st, hl, wl, xy[2 * p], xy[2 * p + 1],
                         aw[p], acc);
      }
    }
  }
}

// LPS > 0: the unrolled instance, P points in each of LPS levels a sub-group;
// LPS == 0: runtime loops over levels s, s + split, ... and n_points points.
template <typename T, int VEC, int LPS, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
msda_forward_kernel(const T* __restrict__ value, const T* __restrict__ loc,
                    const T* __restrict__ attn, T* __restrict__ out,
                    const Params prm) {
  constexpr int E = VEC / static_cast<int>(sizeof(T));
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t triple = tid >> prm.log2_tpt;
  const int lane = static_cast<int>(tid & ((1 << prm.log2_tpt) - 1));
  const int g = lane & ((1 << prm.log2_gp) - 1);
  const int s = lane >> prm.log2_gp;
  // every thread runs to the shuffles; the surplus ones on clamped inputs
  const bool live = triple < prm.n_triples && g < prm.groups;
  if (triple >= prm.n_triples) triple = prm.n_triples - 1;
  const int gc = g < prm.groups ? g : 0;
  const int64_t b = triple / prm.triples_per_image;
  const int h = static_cast<int>(triple % prm.n_heads);
  const T* vb = value + b * prm.image_elems + h * prm.channels + gc * E;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  if constexpr (LPS > 0) {
    // without a split the levels are compile-time indices
    const int l0 = LPS == kUnrolledL ? 0 : s * LPS;
    if (prm.share_points)
      unrolled_levels<T, VEC, LPS, P, true>(vb, loc, attn, prm, triple, l0, g,
                                            acc);
    else
      unrolled_levels<T, VEC, LPS, P, false>(vb, loc, attn, prm, triple, l0,
                                             g, acc);
  } else {
    const int64_t k0 = triple * prm.n_levels * prm.n_points;
    for (int l = s; l < prm.n_levels; l += prm.split) {
      const int hl = prm.h[l], wl = prm.w[l], st = prm.start[l];
      for (int p = 0; p < prm.n_points; ++p) {
        const int64_t k = k0 + l * prm.n_points + p;
        sample<T, VEC>(vb, prm.row, st, hl, wl, load_float(loc + 2 * k),
                       load_float(loc + 2 * k + 1), load_float(attn + k), acc);
      }
    }
  }

  // the sub-groups of a triple are lanes 2^log2_gp apart in one warp
  for (int o = 1 << prm.log2_gp; o < (1 << prm.log2_tpt); o <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (live && s == 0)
    store_floats<T, VEC>(out + triple * prm.channels + gc * E, acc);
}

template <typename T, int VEC, int LPS, int P>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, const Params& prm, cudaStream_t stream) {
  const int64_t threads = prm.n_triples << prm.log2_tpt;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  msda_forward_kernel<T, VEC, LPS, P>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(value), static_cast<const T*>(loc),
          static_cast<const T*>(attn), static_cast<T*>(out), prm);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* value, const void* loc, const void* attn,
                       void* out, const Params& prm, int lps,
                       cudaStream_t stream) {
  constexpr int P = kUnrolledP;
  switch (lps) {
    case 0: return launch<T, VEC, 0, 0>(value, loc, attn, out, prm, stream);
    case 1: return launch<T, VEC, 1, P>(value, loc, attn, out, prm, stream);
    case 2: return launch<T, VEC, 2, P>(value, loc, attn, out, prm, stream);
    case 4: return launch<T, VEC, 4, P>(value, loc, attn, out, prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* value, const void* loc, const void* attn,
                     void* out, const Params& prm, int vec_bytes, int lps,
                     cudaStream_t stream) {
  switch (vec_bytes) {
    case 16: return launch_vec<T, 16>(value, loc, attn, out, prm, lps, stream);
    case 8: return launch_vec<T, 8>(value, loc, attn, out, prm, lps, stream);
    case 4: return launch_vec<T, 4>(value, loc, attn, out, prm, lps, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, 2>(value, loc, attn, out, prm, lps, stream);
      else
        return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

int ceil_log2(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Fills prm and lps (levels a sub-group unrolls, 0 for the loop instance)
// from the call; cudaErrorInvalidValue for what the kernel does not take.
cudaError_t make_params(Params& prm, int& lps, const void* value,
                        const void* loc, const void* attn, const void* out,
                        int dtype, int64_t batch, int64_t len_v, int n_heads,
                        int channels, int64_t len_q, int n_levels,
                        int n_points, const int64_t* shapes, int vec_bytes,
                        int split, int unrolled, int share_points) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 1 || n_heads < 1 ||
      channels < 1 || batch < 0 || len_q < 0)
    return cudaErrorInvalidValue;
  if (len_v * n_heads * channels >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  if (vec_bytes < item || vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) ||
      (channels * item) % vec_bytes || !aligned(value, vec_bytes) ||
      !aligned(out, vec_bytes) || !aligned(loc, item) || !aligned(attn, item))
    return cudaErrorInvalidValue;
  prm.groups = channels * item / vec_bytes;
  prm.log2_gp = ceil_log2(prm.groups);
  if (split < 1 || split > n_levels || (split & (split - 1)))
    return cudaErrorInvalidValue;
  prm.split = split;
  prm.log2_tpt = prm.log2_gp + ceil_log2(split);
  if (prm.log2_tpt > 5) return cudaErrorInvalidValue;  // a triple in one warp
  lps = 0;
  if (unrolled) {
    if (n_levels != kUnrolledL || n_points != kUnrolledP ||
        kUnrolledL % split || !aligned(loc, 16) || !aligned(attn, 16))
      return cudaErrorInvalidValue;
    lps = kUnrolledL / split;
  }
  // sharing needs the unrolled instance and a sub-group of >= P threads
  if (share_points && (!unrolled || (1 << prm.log2_gp) < kUnrolledP))
    return cudaErrorInvalidValue;
  prm.share_points = share_points;
  prm.n_levels = n_levels;
  prm.n_points = n_points;
  int64_t start = 0;
  for (int l = 0; l < n_levels; ++l) {
    prm.h[l] = static_cast<int>(shapes[2 * l]);
    prm.w[l] = static_cast<int>(shapes[2 * l + 1]);
    if (prm.h[l] < 1 || prm.w[l] < 1) return cudaErrorInvalidValue;
    prm.start[l] = static_cast<int>(start);
    start += shapes[2 * l] * shapes[2 * l + 1];
  }
  if (start != len_v) return cudaErrorInvalidValue;
  prm.n_heads = n_heads;
  prm.channels = channels;
  prm.row = n_heads * channels;
  prm.n_triples = batch * len_q * n_heads;
  prm.triples_per_image = len_q * n_heads;
  prm.image_elems = len_v * prm.row;
  return cudaSuccess;
}

}  // namespace

extern "C" int msda_forward(const void* value, const void* loc,
                            const void* attn, void* out, int dtype,
                            int64_t batch, int64_t len_v, int n_heads,
                            int channels, int64_t len_q, int n_levels,
                            int n_points, const int64_t* shapes, int vec_bytes,
                            int split, int unrolled, int share_points,
                            void* stream) {
  Params prm;
  int lps;
  cudaError_t err = make_params(prm, lps, value, loc, attn, out, dtype, batch,
                                len_v, n_heads, channels, len_q, n_levels,
                                n_points, shapes, vec_bytes, split, unrolled,
                                share_points);
  if (err != cudaSuccess || prm.n_triples == 0) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_t<float>(value, loc, attn, out, prm, vec_bytes, lps, s)
            : launch_t<__nv_bfloat16>(value, loc, attn, out, prm, vec_bytes,
                                      lps, s);
  return static_cast<int>(err);
}
