// Batched rectangular linear assignment (Hungarian matching) for Hopper
// (sm_90a): the Jonker-Volgenant shortest augmenting path algorithm, one
// warp per cost matrix, several matrices per block.
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
// What bounds it: not bytes (5.78 MB of cost at 48 x 300 x 100 is 1.7 us of
// HBM) but the serial chain of augmenting steps, 141 in the longest matrix
// at that shape, each waiting on the last. The first design (one block a
// matrix) spent 1.13 us a step on four block-wide barriers, a two-level
// argmin and state re-read from shared memory. This one:
//   - A warp solves a matrix. Lane l owns columns l+1, l+33, ... (K of
//     them, a template parameter) and keeps their v, minv, way, matched row
//     (p) and that row's potential (u) in registers, with a used bit mask.
//     A step is a relaxation over the lane's K columns, an argmin by two
//     `redux.sync` minima (the value as an order-preserving integer key,
//     then the lowest column holding it), the update of the same columns,
//     and two shuffles that hand every lane the next row and its
//     potential from the lane owning the chosen column. Every per-column
//     update is a select or a predicated add: no branch, no barrier and no
//     shared-memory traffic in a step but the cost loads.
//   - A row whose search took one step (the common case) is assigned in
//     registers. A longer one writes the lanes' way, p and u into the
//     warp's slice of shared memory, where lane 0 unwinds the path between
//     two `__syncwarp`s, and the lanes read p and u back.
//   - The cost slice is staged into shared memory by all the block's
//     threads with 4-byte `cp.async` copies, only the n valid targets of
//     each query, in its native layout with an odd row stride (Nt | 1), so
//     that a step's 32 lanes, which read one target of 32 queries, fall in
//     32 distinct banks. The block's one `__syncthreads` follows the
//     copies; a warp whose matrix has n = 0 leaves only after it. A slice
//     that does not fit in 227 KB is read from global memory (L1 serves the
//     steps about as fast).
//   - Several matrices share a block (4 warps) once the grid would pass a
//     wave of 132 blocks; the wrapper's `launch_plan` sizes the launch once
//     a shape.
// Measured on an H100 (scripts/hungarian_times.py; PERF.md): 0.62 us a
// step at 300 queries (10 columns a lane), 0.23 us at 100 (4 a lane): the
// step's cost grows with the columns a lane holds, so what bounds the
// kernel now is the one warp's dependent instruction stream, not memory or
// barriers. Two or four warps a matrix, exchanging their candidates through
// shared memory under one named barrier a step, were tried and not kept:
// the exchange cost about what the shorter loop saved at 300 queries, and
// more at 100.
// Every float operation is a float32 subtraction, addition or comparison in
// the order of the plain version (ops/hungarian.py::jv_solve), through
// __fsub_rn/__fadd_rn, so the assignment is the plain version's exactly.
// Argmin ties go to the lowest column, as numpy's argmin; a zero's sign is
// ignored in the key, as numpy's comparisons ignore it. NaN costs never
// relax a column; a row with no column left to reach is left unmatched, as
// in the plain version, so the loop ends for any input (at most Nq + 1
// steps a row).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 128;  // the block's warps all stage the costs
constexpr unsigned kInfKey = 0xff800000u;  // key(+inf)

// float -> unsigned with the same order; -0 and +0 share +0's key
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(__fadd_rn(f, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// a warp's slice: a[nq][stride] (staged only) | u[nt+1] | p[nq+1] |
// way[nq+1], in 4-byte words; rounded to 4 words
__host__ __device__ inline long long slice_words(int nq, int nt, int stride,
                                                 int staged) {
  long long w = (nt + 1) + 2LL * (nq + 1);
  if (staged) w += static_cast<long long>(nq) * stride;
  return (w + 3) & ~3LL;
}

template <int K, bool kStaged>
__global__ void __launch_bounds__(kBlockThreads)
hungarian_kernel(const float* __restrict__ cost,
                 const int* __restrict__ n_valid, int* __restrict__ out,
                 int m_total, int nq, int nt, int per_block) {
  constexpr bool staged = kStaged;
  using Mask = typename std::conditional<(K > 32), unsigned long long,
                                         unsigned>::type;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stride = nt | 1;
  const long long words = slice_words(nq, nt, stride, staged);
  const int m0 = blockIdx.x * per_block;

  // stage every matrix of the block: all threads, the valid targets of
  // each query, element e of a slot's n x nq values at query e / n
  if (staged) {
    for (int s = 0; s < per_block && m0 + s < m_total; ++s) {
      const int n = min(max(n_valid[m0 + s], 0), nt);
      if (n == 0) continue;
      float* a = smem + s * words;
      const float* c = cost + static_cast<size_t>(m0 + s) * nq * nt;
      int q = tid / n, t = tid - q * n;
      const int dq = kBlockThreads / n, dt = kBlockThreads - dq * n;
      for (int e = tid; e < n * nq; e += kBlockThreads) {
        cp_async4(a + q * stride + t, c + static_cast<size_t>(q) * nt + t);
        q += dq;
        t += dt;
        if (t >= n) {
          t -= n;
          ++q;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n");
  }

  // each warp's matrix; u, p and way in its slice are written before they
  // are read (by a row's unwinding and the output)
  const int m = m0 + warp;
  const bool mine = warp < per_block && m < m_total;
  float* slice = smem + (mine ? warp : 0) * words;
  float* u = slice + (staged ? static_cast<long long>(nq) * stride : 0);
  int* p = reinterpret_cast<int*>(u + (nt + 1));
  int* way = p + (nq + 1);
  const int n = mine ? min(max(n_valid[m], 0), nt) : 0;
  if (staged) asm volatile("cp.async.wait_all;\n");
  __syncthreads();  // the block's only barrier
  if (!mine) return;

  // lane's columns j = lane + 1 + 32 k, k < K; bit k of `live` marks
  // those <= nq. Per column: v, minv, way (wy), the row matched to it (pj),
  // that row's potential (uc) and where the column's costs start (at: of a
  // staged row j - 1, or of the global one); every per-column update is a
  // select or a predicated add, not a branch. u in shared memory is read
  // only by a row's unwinding, which first brings it up to date.
  const float* c = cost + static_cast<size_t>(m) * nq * nt;
  float v[K], minv[K], uc[K];
  int pj[K], wy[K], at[K];
  Mask live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.f;
    uc[k] = 0.f;
    pj[k] = 0;
    wy[k] = 0;
    const int j = min(lane + 1 + 32 * k, nq);
    at[k] = (j - 1) * (staged ? stride : nt) - 1;
    if (lane + 1 + 32 * k <= nq) live |= Mask(1) << k;
  }
  const float* costs = staged ? slice : c;

  for (int i = 1; i <= n; ++i) {
    Mask used = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) minv[k] = CUDART_INF_F;
    float ui = 0.f;           // row i's potential (column 0's row); a row's
    float ui0 = ui;           // u is 0 until its own search
    int j0 = 0, i0 = i, steps = 0;
    bool reached = false;
    while (true) {
      // relax the lane's unused columns from row i0 (potential ui0), and
      // keep the least (value, column) with that column's row and potential;
      // a tie keeps the lower column, as numpy's argmin
      const Mask open = live & ~used;
      float bv = CUDART_INF_F, bu = 0.f;
      int bj = 0x7fffffff, bp = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float aij = staged ? costs[at[k] + i0] : __ldg(costs + at[k] + i0);
        const float cur = __fsub_rn(__fsub_rn(aij, ui0), v[k]);
        const bool is_open = (open & (Mask(1) << k)) != 0;
        const bool better = is_open && cur < minv[k];
        minv[k] = better ? cur : minv[k];
        wy[k] = better ? j0 : wy[k];
        const float mk = is_open ? minv[k] : CUDART_INF_F;
        const bool least = mk < bv;
        bv = least ? mk : bv;
        bj = least ? lane + 1 + 32 * k : bj;
        bu = least ? uc[k] : bu;
        bp = least ? pj[k] : bp;
      }
      ++steps;
      // the warp's argmin: the least key, then the lowest column with it
      const unsigned key = order_key(bv);
      const unsigned min_key = __reduce_min_sync(kFull, key);
      const unsigned j1 = __reduce_min_sync(
          kFull, key == min_key ? static_cast<unsigned>(bj) : 0xffffffffu);
      if (min_key >= kInfKey) break;  // no column left to reach: unmatched
      const float delta = key_value(min_key);
      // move the potentials: the tree's rows and columns, and the gaps of
      // the others (a used column's gap is not read again in this row)
      ui = __fadd_rn(ui, delta);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (used & (Mask(1) << k)) {
          v[k] = __fsub_rn(v[k], delta);
          uc[k] = __fadd_rn(uc[k], delta);
        }
        minv[k] = __fsub_rn(minv[k], delta);
      }
      // the lane owning column j1 marks it used and hands out its row and
      // that row's potential (outside the tree: not moved in this step)
      const int owner = static_cast<int>((j1 - 1) & 31);
      used |= Mask(lane == owner) << ((j1 - 1) >> 5);
      i0 = __shfl_sync(kFull, bp, owner);
      ui0 = __shfl_sync(kFull, bu, owner);
      j0 = static_cast<int>(j1);
      if (i0 == 0) {
        reached = true;
        break;
      }
    }
    if (!reached) {
      // unmatched: the tree's potentials stay in registers; row i's is
      // not read again
      continue;
    }
    const int owner = (j0 - 1) & 31, kk = (j0 - 1) >> 5;
    if (steps == 1) {
      // the path is column j0 alone (its way is 0): row i takes it
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == kk && lane == owner) {
          pj[k] = i;
          uc[k] = ui;
        }
      continue;
    }
    // unwind the path through shared memory: potentials and ways first
    if (lane == 0) u[i] = ui;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (pj[k]) u[pj[k]] = uc[k];
      if (live & (Mask(1) << k)) {
        way[lane + 1 + 32 * k] = wy[k];
        p[lane + 1 + 32 * k] = pj[k];
      }
    }
    __syncwarp();
    if (lane == 0) {
      p[0] = i;
      while (j0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pj[k] = (live & (Mask(1) << k)) ? p[lane + 1 + 32 * k] : 0;
      uc[k] = pj[k] ? u[pj[k]] : 0.f;
    }
    __syncwarp();
  }
  // the query of each target, through way's words (no longer needed)
  int* col = way;
  for (int t = lane; t < nt; t += 32) col[t] = -1;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (((live >> k) & 1) && pj[k]) col[pj[k] - 1] = lane + 32 * k;
  __syncwarp();
  int* o = out + static_cast<size_t>(m) * nt;
  for (int t = lane; t < nt; t += 32) o[t] = col[t];
}

typedef void (*KernelFn)(const float*, const int*, int*, int, int, int, int);

// the instantiated K (columns a lane); the wrapper rounds ceil(Nq / 32) up
// to one of these (ops/cuda/hungarian_kernel.py::LANE_COLUMNS). A slice
// too large to stage has Nq x Nt above 56,000, so K >= 8 there.
constexpr int kLaneColumns[] = {1, 2, 4, 8, 10, 16, 24, 32, 48, 64};
constexpr int kInstances = sizeof(kLaneColumns) / sizeof(int);

KernelFn kernel_of(int k, bool staged) {
  switch (k) {
    case 1: return staged ? hungarian_kernel<1, true> : nullptr;
    case 2: return staged ? hungarian_kernel<2, true> : nullptr;
    case 4: return staged ? hungarian_kernel<4, true> : nullptr;
    case 8: return staged ? hungarian_kernel<8, true> : hungarian_kernel<8, false>;
    case 10: return staged ? hungarian_kernel<10, true> : hungarian_kernel<10, false>;
    case 16: return staged ? hungarian_kernel<16, true> : hungarian_kernel<16, false>;
    case 24: return staged ? hungarian_kernel<24, true> : hungarian_kernel<24, false>;
    case 32: return staged ? hungarian_kernel<32, true> : hungarian_kernel<32, false>;
    case 48: return staged ? hungarian_kernel<48, true> : hungarian_kernel<48, false>;
    case 64: return staged ? hungarian_kernel<64, true> : hungarian_kernel<64, false>;
    default: return nullptr;
  }
}

int instance_index(int k) {
  for (int i = 0; i < kInstances; ++i)
    if (kLaneColumns[i] == k) return i;
  return -1;
}

}  // namespace

// cost (m, nq, nt) float32, n_valid (m,) int32, out (m, nt) int32, all
// contiguous on the device of `stream`; k columns a lane (one of
// kLaneColumns, 32 k >= nq), `per_block` matrices (warps) a block of 128
// threads, `smem_bytes` of dynamic shared memory, at least per_block
// slices. Returns the CUDA error of the launch.
extern "C" int hungarian_forward(const float* cost, const int* n_valid,
                                 int* out, int m, int nq, int nt, int k,
                                 int staged, int per_block,
                                 long long smem_bytes, void* stream) {
  if (m <= 0 || nt <= 0) return 0;
  const int idx = instance_index(k);
  if (idx < 0 || 32 * k < nq || nt > nq || per_block < 1 ||
      per_block > kBlockThreads / 32 ||
      smem_bytes < 4 * slice_words(nq, nt, nt | 1, staged) * per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in above 48 KB, raised per device and instance only when a
  // launch needs more, so that launches captured in a CUDA graph make no
  // attribute call
  KernelFn fn = kernel_of(k, staged != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  static long long opted_in[64][kInstances][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  long long& opted = opted_in[dev][idx][staged != 0];
  if (smem_bytes > 48 * 1024 && smem_bytes > opted) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem_bytes;
  }
  const int blocks = (m + per_block - 1) / per_block;
  fn<<<blocks, kBlockThreads, static_cast<size_t>(smem_bytes),
       static_cast<cudaStream_t>(stream)>>>(cost, n_valid, out, m, nq, nt,
                                             per_block);
  return static_cast<int>(cudaGetLastError());
}
