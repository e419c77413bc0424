// Masked, scaled row scatter-add as a deterministic segmented sum, for
// sm_90a: the backward of both hand-written forward kernels.
//
// Replaces: dgl_operator_tpu/ops/pallas_gather.py::_fanout_sum_bwd (the
// VJP of fanout_sum_pallas, an XLA segment_sum of the cotangent
// broadcast over the fanout axis) together with the mean's division
// that dgl_operator_tpu/ops/fanout.py::fanout_mean applies outside
// that kernel, and ::_gather_rows_bwd (the VJP of gather_rows_pallas,
// a segment_sum of the cotangent).
//
// Computes, into dst [R, D] float32 (every row written, zeros for a
// target with no entry),
//   dst[t, :] = sum over the entries e of t, in the plan's order, of
//               g[src[e], :] / (mean ? max(cnt[src[e]], 1) : 1)
// in fp32. The plan (ops/scatter.py::scatter_plan, built on the host)
// is the transpose of the [ND, F] index table over its valid slots:
// target t's entries are src[offsets[t] .. offsets[t+1]), sorted by
// source row i, then slot k. g is float32 or bfloat16.
//
// Bound: HBM bytes. The function must write dst once (R x D x 4) and
// read g (ND x D x sizeof(T)) and the index table; the adds and
// divisions are far below the card's fp32 rate. This design moves
// those bytes and the plan (about (R + 2 x nnz) x 4 bytes): g's rows
// are read once per entry, mostly from L2.
//
// Design: a warp writes `tile` consecutive target rows. It loads their
// offsets in one coalesced load and walks their entries as one stream
// in target order: lane e loads entry e's source row and divisor, and
// the warp issues kLoads / G rows' loads (a lane holding G x VW
// columns) before adding them, so loads run ahead across target
// boundaries while each target adds its entries one at a time. The
// mean's division goes through the divisor's reciprocal and one FMA
// correction (div_by_count): the IEEE quotient without the IEEE
// division's branch, which kept the divisions of a batch from
// overlapping. Each row is written once with vector stores, zeros for a
// target with no entry: no zero fill and no float atomics, so the sum
// does not depend on timing. A target with up to kChunk entries adds
// them in exactly the order of a sequential index_add_ (bit-equal to
// the CPU). A longer one (a hub named by many dst rows, or the
// gather's padded id 0) is cut into kChunk-entry pieces, each summed by
// its own warp into a partial row; a second launch on the same stream
// (a programmatic dependent launch, which hides the gap between the
// two) then adds each such target's partials in a fixed order, a block
// a target, and writes its row. The plan is read only, so launches may
// share it. Piece warps come first in the grid, so the long sums start
// first. What holds it back: a target of up to kChunk entries is one
// warp's sequential chain of load rounds, and a warp's offsets, entries
// and rows are three dependent trips before its first store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 32;     // = ops/scatter.py CHUNK, one entry a lane
// targets a warp writes: enough that the grid holds about kWarpsPerSm
// warps an SM in all (2 at R = 19,200 on 132 SMs, 10 at 118,720),
// at most one a lane
constexpr int kWarpsPerSm = 96;
// a lane holds G groups of VW columns per pass and loads kLoads / G
// rows ahead of their adds (G = 2 when one group does not span D)
constexpr int kLoads = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x / den rounded to nearest, for den a positive integer below 2^24 and
// 1 / den rounded to nearest in rcp: the product, then one exact FMA
// residual and correction (Markstein), which yields the IEEE quotient
// whenever it is a normal number. Branch-free, unlike the IEEE
// division, so the divisions of several entries interleave.
__device__ __forceinline__ float div_by_count(float x, float den,
                                              float rcp) {
  const float q = __fmul_rn(x, rcp);
  return __fmaf_rn(__fmaf_rn(-q, den, x), rcp, q);
}

// VW consecutive elements moved as one aligned load or store
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

// Rows out, out + d, ... get, for targets j .. k-1 of a batch, the
// in-order fp32 sums of their entries among src[lo .. lo + n) (n <=
// kChunk), 0 for a target with none; target m's entries end where lane
// m's `hi` says. Lane e holds entry e's source row and divisor, and the
// warp issues kLoads / G rows' loads (a lane holding G x VW columns)
// before adding them, so loads run ahead across target boundaries
// while each target still adds its entries one at a time.
template <typename T, int VW, int G>
__device__ __forceinline__ void sum_batch(
    const T* __restrict__ g, const int32_t* __restrict__ src,
    const int32_t* __restrict__ cnt, bool mean, int lo, int n, int j, int k,
    int hi, float* __restrict__ out, int64_t d, int lane) {
  int my_src = 0;
  float my_den = 1.0f, my_rcp = 1.0f;
  if (lane < n) {
    my_src = src[lo + lane];
    if (mean) {
      my_den = static_cast<float>(max(cnt[my_src], 1));
      my_rcp = __frcp_rn(my_den);
    }
  }
  for (int64_t base = 0; base < d; base += kWarp * VW * G) {
    int64_t col[G];
    bool on[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      col[q] = base + static_cast<int64_t>(q * kWarp + lane) * VW;
      on[q] = col[q] < d;
    }
    float acc[G][VW];
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[q][v] = 0.0f;
    // write target m's sum and start the next one from 0
    auto flush = [&](int m) {
      float* row = out + (m - j) * d;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (on[q]) {
          Pack<float, VW> o;
#pragma unroll
          for (int v = 0; v < VW; ++v) o.v[v] = acc[q][v];
          *reinterpret_cast<Pack<float, VW>*>(row + col[q]) = o;
        }
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[q][v] = 0.0f;
      }
    };
    int m = j;
    int m_end = __shfl_sync(kFull, hi, m) - lo;
    for (int e0 = 0; e0 < n; e0 += kLoads / G) {
      Pack<T, VW> p[kLoads / G][G];
#pragma unroll
      for (int u = 0; u < kLoads / G; ++u) {
        const int e = e0 + u;   // uniform across the warp
        const int64_t i = __shfl_sync(kFull, my_src, e % kWarp);
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (e < n && on[q])
            p[u][q] =
                *reinterpret_cast<const Pack<T, VW>*>(g + i * d + col[q]);
      }
      // the divisors after the loads, so cnt's load overlaps the rows'
#pragma unroll
      for (int u = 0; u < kLoads / G; ++u) {
        const int e = e0 + u;
        const float den = __shfl_sync(kFull, my_den, e % kWarp);
        const float rcp = __shfl_sync(kFull, my_rcp, e % kWarp);
        if (e < n) {
          while (e >= m_end) {   // targets ending before entry e
            flush(m);
            ++m;
            m_end = __shfl_sync(kFull, hi, m) - lo;
          }
#pragma unroll
          for (int q = 0; q < G; ++q)
            if (on[q])
#pragma unroll
              for (int v = 0; v < VW; ++v) {
                const float x = to_float(p[u][q].v[v]);
                acc[q][v] = __fadd_rn(acc[q][v],
                                      mean ? div_by_count(x, den, rcp) : x);
              }
        }
      }
    }
    for (; m < k; ++m) flush(m);   // the last target and empty ones
  }
}

// Writes targets [t0, t0 + tile) that have at most kChunk entries, in
// batches of consecutive such targets with at most kChunk entries
// together.
template <typename T, int VW, int G>
__device__ __forceinline__ void walk_tile(
    const T* __restrict__ g, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ src, const int32_t* __restrict__ cnt,
    bool mean, float* __restrict__ dst, int64_t t0, int tile,
    int64_t num_rows, int64_t d, int lane) {
  const int nt =
      num_rows - t0 < tile ? static_cast<int>(num_rows - t0) : tile;
  int lo = 0, hi = 0;
  if (lane < nt) {
    lo = offsets[t0 + lane];
    hi = offsets[t0 + lane + 1];
  }
  const unsigned long_bits =
      __ballot_sync(kFull, lane < nt && hi - lo > kChunk);
  int j = 0;
  while (j < nt) {
    const unsigned later_long = long_bits & (kFull << j);
    const int first_long = later_long ? __ffs(later_long) - 1 : nt;
    if (first_long == j) {   // written by add_partials_kernel
      ++j;
      continue;
    }
    const int lo_j = __shfl_sync(kFull, lo, j);
    const int k = j + __popc(__ballot_sync(
                          kFull, lane >= j && lane < first_long &&
                                     hi - lo_j <= kChunk));
    const int n = __shfl_sync(kFull, hi, k - 1) - lo_j;
    sum_batch<T, VW, G>(g, src, cnt, mean, lo_j, n, j, k, hi,
                        dst + (t0 + j) * d, d, lane);
    j = k;
  }
}

// Warps [0, n_chunks) sum one piece of a long target each into its
// partial row; the rest write the short targets, `tile` a warp.
template <typename T, int VW, int G>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock, 2)
    segment_sum_kernel(const T* __restrict__ g,
                       const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ src,
                       const int32_t* __restrict__ cnt,
                       const int32_t* __restrict__ chunks,
                       float* __restrict__ partial, float* __restrict__ dst,
                       int64_t num_rows, int64_t n_chunks, int tile,
                       int64_t d, bool mean) {
  // let the dependent launch (add_partials_kernel) be placed early
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (w < n_chunks) {
    const int begin = chunks[2 * w], end = chunks[2 * w + 1];
    sum_batch<T, VW, G>(g, src, cnt, mean, begin, end - begin, 0, 1, end,
                        partial + w * d, d, lane);
    return;
  }
  const int64_t t0 = (w - n_chunks) * tile;
  if (t0 < num_rows)
    walk_tile<T, VW, G>(g, offsets, src, cnt, mean, dst, t0, tile,
                        num_rows, d, lane);
}

// One block a long target q: dst row long_rows[q] = the sum of its
// partial rows long_part[q] .. long_part[q + 1), which the previous
// launch on this stream wrote, in a fixed order: warp w adds, in piece
// order, its contiguous share of the pieces, then warp 0 adds the
// warps' sums in warp order. Launched as a programmatic dependent of
// that launch, so it is resident before it ends and waits for its
// writes (griddepcontrol.wait) only where it reads them.
template <int VW>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    add_partials_kernel(const float* __restrict__ partial,
                        const int32_t* __restrict__ long_rows,
                        const int32_t* __restrict__ long_part,
                        float* __restrict__ dst, int64_t d) {
  __shared__ Pack<float, VW> sums[kWarpsPerBlock][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // the plan is not written by the sum: read it before the wait
  const int p0 = long_part[blockIdx.x], p1 = long_part[blockIdx.x + 1];
  const int share = (p1 - p0 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int r_begin = min(p1, p0 + warp * share);
  const int r_end = min(p1, r_begin + share);
  float* out = dst + static_cast<int64_t>(long_rows[blockIdx.x]) * d;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int64_t base = 0; base < d; base += kWarp * VW) {
    const int64_t c = base + static_cast<int64_t>(lane) * VW;
    const bool on = c < d;
    Pack<float, VW> acc;
#pragma unroll
    for (int j = 0; j < VW; ++j) acc.v[j] = 0.0f;
    for (int r0 = r_begin; r0 < r_end; r0 += kLoads) {
      Pack<float, VW> p[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (r0 + u < r_end && on)
          p[u] = *reinterpret_cast<const Pack<float, VW>*>(
              partial + static_cast<int64_t>(r0 + u) * d + c);
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (r0 + u < r_end && on)
#pragma unroll
          for (int j = 0; j < VW; ++j)
            acc.v[j] = __fadd_rn(acc.v[j], p[u].v[j]);
    }
    sums[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && on) {
      Pack<float, VW> o;
#pragma unroll
      for (int j = 0; j < VW; ++j) o.v[j] = 0.0f;
      for (int w = 0; w < kWarpsPerBlock; ++w)
#pragma unroll
        for (int j = 0; j < VW; ++j)
          o.v[j] = __fadd_rn(o.v[j], sums[w][lane].v[j]);
      *reinterpret_cast<Pack<float, VW>*>(out + c) = o;
    }
    __syncthreads();
  }
}

// The plan's arrays, in ops/scatter.py ScatterPlan.FIELDS order.
struct Plan {
  const int32_t *offsets, *src, *cnt, *chunks, *long_rows, *long_part;
};

template <typename T, int VW, int G>
cudaError_t launch_groups(const T* g, const Plan& plan, float* partial,
                          float* dst, int64_t num_rows, int64_t n_chunks,
                          int64_t n_long, int64_t d, bool mean,
                          cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t per = static_cast<int64_t>(kWarpsPerSm) * sms;
  const int tile = static_cast<int>(
      num_rows > per * kWarp ? kWarp : (num_rows + per - 1) / per);
  const int64_t warps = (num_rows + tile - 1) / tile + n_chunks;
  const dim3 block(kWarp * kWarpsPerBlock);
  segment_sum_kernel<T, VW, G>
      <<<static_cast<unsigned>((warps + kWarpsPerBlock - 1) /
                               kWarpsPerBlock),
         block, 0, stream>>>(g, plan.offsets, plan.src, plan.cnt,
                             plan.chunks, partial, dst, num_rows, n_chunks,
                             tile, d, mean);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_long == 0) return err;
  // a programmatic dependent launch: its blocks are placed once every
  // block of the sum has started, and wait (griddepcontrol.wait) for
  // the sum's writes, so the gap between the launches is hidden
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_long));
  cfg.blockDim = block;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, add_partials_kernel<VW>,
                            static_cast<const float*>(partial),
                            plan.long_rows, plan.long_part, dst, d);
}

template <typename T, int VW>
cudaError_t launch_vec(const void* g, const Plan& plan, void* partial,
                       void* dst, int64_t num_rows, int64_t n_chunks,
                       int64_t n_long, int64_t d, bool mean,
                       cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  float* pp = static_cast<float*>(partial);
  float* dp = static_cast<float*>(dst);
  if (d > kWarp * VW)
    return launch_groups<T, VW, 2>(gp, plan, pp, dp, num_rows, n_chunks,
                                   n_long, d, mean, stream);
  return launch_groups<T, VW, 1>(gp, plan, pp, dp, num_rows, n_chunks,
                                 n_long, d, mean, stream);
}

template <typename T>
cudaError_t launch_typed(const void* g, const Plan& plan, void* partial,
                         void* dst, int64_t num_rows, int64_t n_chunks,
                         int64_t n_long, int64_t d, bool mean,
                         cudaStream_t stream) {
  // a vector of VW columns needs D % VW == 0 and VW-aligned rows of g
  // (VW x sizeof(T) bytes) and of dst and partial (VW x 4 bytes)
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t fa = reinterpret_cast<uintptr_t>(dst) |
                       reinterpret_cast<uintptr_t>(partial);
  if (d % 4 == 0 && ga % (4 * sizeof(T)) == 0 && fa % 16 == 0) {
    return launch_vec<T, 4>(g, plan, partial, dst, num_rows, n_chunks,
                            n_long, d, mean, stream);
  }
  if (d % 2 == 0 && ga % (2 * sizeof(T)) == 0 && fa % 8 == 0) {
    return launch_vec<T, 2>(g, plan, partial, dst, num_rows, n_chunks,
                            n_long, d, mean, stream);
  }
  return launch_vec<T, 1>(g, plan, partial, dst, num_rows, n_chunks, n_long,
                          d, mean, stream);
}

}  // namespace

// The plan's arrays, in ops/scatter.py ScatterPlan.FIELDS order:
// offsets, src, cnt, chunks, long_rows, long_part (int32, read only).
// partial is [n_chunks, d] float32 scratch (unread when n_chunks is
// 0); n_long is the length of long_rows. dtype (of g): 0 = float32,
// 1 = bfloat16. Writes every row of dst [num_rows, d] float32 in one
// launch, or two when the plan has long targets; runs on `stream` and
// does not synchronise; returns cudaGetLastError() after the launches
// (0 = ok).
extern "C" int scatter_add_rows_launch(
    const void* g, const void* offsets, const void* src, const void* cnt,
    const void* chunks, const void* long_rows, const void* long_part,
    void* partial, void* dst, int64_t num_rows, int64_t n_chunks,
    int64_t n_long, int64_t d, int64_t dtype, int64_t mean, void* stream) {
  if (num_rows <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const Plan plan{static_cast<const int32_t*>(offsets),
                  static_cast<const int32_t*>(src),
                  static_cast<const int32_t*>(cnt),
                  static_cast<const int32_t*>(chunks),
                  static_cast<const int32_t*>(long_rows),
                  static_cast<const int32_t*>(long_part)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_typed<float>(
          g, plan, partial, dst, num_rows, n_chunks, n_long, d, mean != 0,
          s));
    case 1:
      return static_cast<int>(launch_typed<__nv_bfloat16>(
          g, plan, partial, dst, num_rows, n_chunks, n_long, d, mean != 0,
          s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
