// Batched rectangular linear assignment (Hungarian matching) for Hopper
// (sm_90a): the Jonker-Volgenant shortest augmenting path algorithm, one
// thread block per cost matrix.
//
// Replaces the on-device JV of the JAX package,
// `aloception_tpu/ops/hungarian.py:28` (`hungarian`, with `hungarian_rect`
// :100 and `batched_hungarian_rect` :125): there it is XLA code, lax loops
// batched with vmap, not a Pallas kernel. In eager PyTorch the same loops
// would read a value back to the host for every loop test, thousands of
// syncs a training step, so here the whole solve is one kernel that reads
// n_valid on the device and never syncs.
//
// Problem: cost (M, Nq, Nt) float32, laid out queries x targets as the
// matchers build it; n_valid (M,) int32. For matrix m the first n = n_valid[m]
// targets are the rows of the problem and the Nq queries its columns
// (n <= Nt <= Nq), in the e-maxx form of JV with 1-indexed potentials u (rows)
// and v (columns) and the virtual column 0. The JAX package pads to a square
// Nq x Nq matrix instead; the padding adds one constant to every assignment,
// so the optimum for the valid targets is the same. out (M, Nt) int32 holds,
// for each valid target, the query it is matched to, and -1 past n.
//
// Each augmenting step is a relaxation over the columns, in parallel (thread
// t takes columns t+1, t+1+blockDim, ...), then a block-wide argmin of minv
// over the unused columns (warp shuffles, then one pass over the warps'
// results) whose ties go to the lowest column, as numpy's and jnp's argmin,
// then the potential update over the columns, again in parallel (a used
// column j moves u[p[j]] and v[j]: p is one-to-one on used columns, so no two
// threads touch one u). Thread 0 marks the chosen column used and unwinds the
// augmenting path. Every float operation is a float32 subtraction or
// comparison in the order of the plain version (ops/hungarian.py::jv_solve),
// with no multiply the compiler could contract, so the assignment is the
// plain version's exactly. NaN costs never relax a column; a row with no
// column left to reach is left unmatched, as in the plain version, so the
// loop ends for any input (at most Nq + 1 steps a row).
//
// Shared memory holds u, v, minv, p, way and used, and the n x Nq cost slice
// transposed (targets x queries, so a step reads one contiguous row) when
// Nt x Nq floats fit (120 KB at 100 x 300); otherwise steps read the cost
// from global memory.
//
// What bounds it: not bytes (5.76 MB of cost at 48 x 300 x 100 is 1.7 us of
// HBM) but its serial chain: every step of every augmenting path is a
// relaxation, a block-wide reduction and two barriers, each waiting on the
// last. Making it fast (one warp per matrix where n_valid is small, several
// matrices per block, fewer barriers a step) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct ArgMin {
  float v;
  int j;
};

// the smaller value; on a tie the lower column. j = -1 only with v = +inf.
__device__ __forceinline__ ArgMin pick(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    ArgMin o{__shfl_down_sync(kFull, x.v, off),
             __shfl_down_sync(kFull, x.j, off)};
    x = pick(x, o);
  }
  return x;
}

// block-wide argmin; every thread gets the result. Holds two barriers.
__device__ __forceinline__ ArgMin block_argmin(ArgMin x, float* red_v,
                                              int* red_j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  x = warp_argmin(x);
  if (lane == 0) {
    red_v[warp] = x.v;
    red_j[warp] = x.j;
  }
  __syncthreads();
  if (warp == 0) {
    ArgMin y = lane < n_warps ? ArgMin{red_v[lane], red_j[lane]}
                              : ArgMin{CUDART_INF_F, -1};
    y = warp_argmin(y);
    if (lane == 0) {
      red_v[32] = y.v;
      red_j[32] = y.j;
    }
  }
  __syncthreads();
  return ArgMin{red_v[32], red_j[32]};
}

__global__ void __launch_bounds__(1024)
hungarian_kernel(const float* __restrict__ cost,
                 const int* __restrict__ n_valid, int* __restrict__ out,
                 int nq, int nt, int staged) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * nq * nt;
  int* o = out + static_cast<size_t>(blockIdx.x) * nt;

  // layout: u[nt+1] v[nq+1] minv[nq+1] red_v[33] | p way used [nq+1]
  // red_j[33] | staged cost a[n][nq]
  float* u = smem;
  float* v = u + (nt + 1);
  float* minv = v + (nq + 1);
  float* red_v = minv + (nq + 1);
  int* p = reinterpret_cast<int*>(red_v + 33);
  int* way = p + (nq + 1);
  int* used = way + (nq + 1);
  int* red_j = used + (nq + 1);
  float* a = reinterpret_cast<float*>(red_j + 33);

  const int n = min(max(n_valid[blockIdx.x], 0), nt);
  for (int k = tid; k < nt; k += nth) o[k] = -1;
  if (n == 0) return;

  for (int k = tid; k <= nt; k += nth) u[k] = 0.f;
  for (int j = tid; j <= nq; j += nth) {
    v[j] = 0.f;
    p[j] = 0;
    way[j] = 0;
  }
  if (staged) {
    // consecutive threads read consecutive targets of one query's row
    for (int k = tid; k < n * nq; k += nth) {
      const int q = k / n, t = k - q * n;
      a[t * nq + q] = c[static_cast<size_t>(q) * nt + t];
    }
  }
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    for (int j = tid; j <= nq; j += nth) {
      minv[j] = CUDART_INF_F;
      used[j] = 0;
    }
    if (tid == 0) p[0] = i;
    __syncthreads();
    int j0 = 0;
    bool reached = false;
    while (true) {
      if (tid == 0) used[j0] = 1;
      __syncthreads();
      const int i0 = p[j0];
      const float ui0 = u[i0];
      ArgMin best{CUDART_INF_F, -1};
      for (int j = tid + 1; j <= nq; j += nth) {
        if (used[j]) continue;
        const float aij = staged ? a[(i0 - 1) * nq + (j - 1)]
                                 : c[static_cast<size_t>(j - 1) * nt + (i0 - 1)];
        const float cur = __fsub_rn(__fsub_rn(aij, ui0), v[j]);
        float mv = minv[j];
        if (cur < mv) {
          mv = cur;
          minv[j] = cur;
          way[j] = j0;
        }
        if (mv < best.v) best = ArgMin{mv, j};
      }
      best = block_argmin(best, red_v, red_j);
      if (best.j < 0) break;  // no column left to reach: row unmatched
      const float delta = best.v;
      for (int j = tid; j <= nq; j += nth) {
        if (used[j]) {
          u[p[j]] = __fadd_rn(u[p[j]], delta);
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      __syncthreads();
      j0 = best.j;
      if (p[j0] == 0) {
        reached = true;
        break;
      }
    }
    if (reached && tid == 0) {
      while (j0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }
  for (int j = tid + 1; j <= nq; j += nth)
    if (p[j]) o[p[j] - 1] = j - 1;
}

size_t smem_bytes(int nq, int nt, int staged) {
  size_t b = sizeof(float) * ((nt + 1) + 2 * (nq + 1) + 33) +
             sizeof(int) * (3 * (nq + 1) + 33);
  if (staged) b += sizeof(float) * static_cast<size_t>(nt) * nq;
  return b;
}

}  // namespace

// Threads a block for Nq columns: a whole number of warps, at most 1024.
extern "C" int hungarian_threads(int nq) {
  int t = ((nq + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

extern "C" long long hungarian_smem_bytes(int nq, int nt, int staged) {
  return static_cast<long long>(smem_bytes(nq, nt, staged));
}

// cost (m, nq, nt) float32, n_valid (m,) int32, out (m, nt) int32, all
// contiguous on the device of `stream`. Returns the CUDA error of the launch.
extern "C" int hungarian_forward(const float* cost, const int* n_valid,
                                 int* out, int m, int nq, int nt, int staged,
                                 void* stream) {
  if (m <= 0 || nt <= 0) return 0;
  const size_t bytes = smem_bytes(nq, nt, staged);
  // the opt-in above 48 KB, raised per device only when a launch needs more,
  // so that launches captured in a CUDA graph make no attribute call
  static size_t opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > 48 * 1024 && bytes > opted_in[dev]) {
    err = cudaFuncSetAttribute(hungarian_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = bytes;
  }
  hungarian_kernel<<<m, hungarian_threads(nq), bytes,
                     static_cast<cudaStream_t>(stream)>>>(cost, n_valid, out,
                                                          nq, nt, staged);
  return static_cast<int>(cudaGetLastError());
}
