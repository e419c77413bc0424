// Masked, scaled row scatter-add into a zero-filled fp32 table, for
// sm_90a: the backward of both hand-written forward kernels.
//
// Replaces: dgl_operator_tpu/ops/pallas_gather.py::_fanout_sum_bwd (the
// VJP of fanout_sum_pallas, an XLA segment_sum of the cotangent
// broadcast over the fanout axis) together with the mean's division
// that dgl_operator_tpu/ops/fanout.py::fanout_mean applies outside
// that kernel, and ::_gather_rows_bwd (the VJP of gather_rows_pallas,
// a segment_sum of the cotangent).
//
// Computes, after zero-filling dst [N, D] float32,
//   dst[idx[i, k], :] += g[i, :] / (mean ? max(cnt_i, 1) : 1)
// for every slot with mask[i, k] != 0 (every slot when there is no
// mask), cnt_i being the row's count of valid slots. g is float32 or
// bfloat16; idx is int32 or int64. As the backward of gather_rows it
// runs with F = 1, no mask and no division: every index counts,
// padded id 0 included, as the segment_sum does.
//
// Bound: HBM bytes. The function must write dst once (N x D x 4) and
// read g (ND x D x sizeof(T)) and idx and mask (ND x F x (sizeof(index)
// + 1)); the ND x F x D adds are far below the card's fp32 rate. This
// design (a zero fill, then atomics) moves more: each distinct target
// row is read and written once more by the atomics (2 x unique x D x 4).
//
// Design: one warp per row of g, 8 rows per 256-thread block. A lane
// loads its VW columns of the row once, scales them in registers, and
// adds them into each valid slot's target row with one vector fp32
// atomic (atomicAdd on float4 / float2, which sm_90 has from CUDA
// 12.1). Masked slots and rows with no valid slot cost nothing beyond
// their mask read. The order in which atomics land varies from run to
// run, so the fp32 sum
// is not bit-reproducible; a deterministic variant (a host-built
// transpose, then a segmented sum) is an open item.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if __CUDACC_VER_MAJOR__ < 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 1)
#error "scatter_add_rows.cu needs CUDA 12.1 or later (float4/float2 atomicAdd)"
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VW consecutive elements moved as one aligned load
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

template <int VW>
__device__ __forceinline__ void atomic_add_vec(float* p, const float* v);

template <>
__device__ __forceinline__ void atomic_add_vec<1>(float* p, const float* v) {
  atomicAdd(p, v[0]);
}

template <>
__device__ __forceinline__ void atomic_add_vec<2>(float* p, const float* v) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

template <>
__device__ __forceinline__ void atomic_add_vec<4>(float* p, const float* v) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

template <typename T, typename I, int VW>
__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
    scatter_add_rows_kernel(const T* __restrict__ g, const I* __restrict__ idx,
                            const uint8_t* __restrict__ mask,
                            float* __restrict__ dst, int64_t nd, int64_t f,
                            int64_t d, bool mean) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= nd) return;
  const int lane = threadIdx.x % kWarp;
  const I* irow = idx + row * f;
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + row * f;
  int64_t cnt = f;
  if (mrow != nullptr) {
    cnt = 0;
    for (int64_t k = 0; k < f; ++k) cnt += mrow[k] != 0;
  }
  if (cnt == 0) return;
  const float denom = mean ? static_cast<float>(cnt) : 1.0f;
  const T* grow = g + row * d;
  for (int64_t c = static_cast<int64_t>(lane) * VW; c < d;
       c += static_cast<int64_t>(kWarp) * VW) {
    const Pack<T, VW> p = *reinterpret_cast<const Pack<T, VW>*>(grow + c);
    float v[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) v[j] = to_float(p.v[j]) / denom;
    for (int64_t k = 0; k < f; ++k) {
      if (mrow != nullptr && mrow[k] == 0) continue;
      atomic_add_vec<VW>(dst + static_cast<int64_t>(irow[k]) * d + c, v);
    }
  }
}

template <typename T, typename I>
cudaError_t launch_typed(const void* g, const void* idx, const void* mask,
                         void* dst, int64_t nd, int64_t f, int64_t d,
                         bool mean, cudaStream_t stream) {
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((nd + kRowsPerBlock - 1) /
                                        kRowsPerBlock));
  const T* gp = static_cast<const T*>(g);
  const I* ip = static_cast<const I*>(idx);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  float* dp = static_cast<float*>(dst);
  // a vector of VW columns needs D % VW == 0 and VW-aligned rows of g
  // (VW x sizeof(T) bytes) and of dst (VW x 4 bytes)
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  if (d % 4 == 0 && ga % (4 * sizeof(T)) == 0 && da % 16 == 0) {
    scatter_add_rows_kernel<T, I, 4>
        <<<grid, block, 0, stream>>>(gp, ip, mp, dp, nd, f, d, mean);
  } else if (d % 2 == 0 && ga % (2 * sizeof(T)) == 0 && da % 8 == 0) {
    scatter_add_rows_kernel<T, I, 2>
        <<<grid, block, 0, stream>>>(gp, ip, mp, dp, nd, f, d, mean);
  } else {
    scatter_add_rows_kernel<T, I, 1>
        <<<grid, block, 0, stream>>>(gp, ip, mp, dp, nd, f, d, mean);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_index(const void* g, const void* idx, const void* mask,
                         void* dst, int64_t nd, int64_t f, int64_t d,
                         int64_t idx_bytes, bool mean, cudaStream_t stream) {
  if (idx_bytes == 4) {
    return launch_typed<T, int32_t>(g, idx, mask, dst, nd, f, d, mean, stream);
  }
  if (idx_bytes == 8) {
    return launch_typed<T, int64_t>(g, idx, mask, dst, nd, f, d, mean, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Zero-fills dst [n, d] float32, then scatters. dtype (of g): 0 =
// float32, 1 = bfloat16; idx_bytes: 4 (int32) or 8 (int64); mask may
// be null (every slot valid). Runs on `stream` and does not
// synchronise; returns the first CUDA error of the fill or the launch
// (0 = ok).
extern "C" int scatter_add_rows_launch(const void* g, const void* idx,
                                       const void* mask, void* dst,
                                       int64_t nd, int64_t f, int64_t d,
                                       int64_t n, int64_t dtype,
                                       int64_t idx_bytes, int64_t mean,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && d > 0) {
    const cudaError_t err = cudaMemsetAsync(
        dst, 0, static_cast<size_t>(n) * static_cast<size_t>(d) * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nd <= 0 || f <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_index<float>(
          g, idx, mask, dst, nd, f, d, idx_bytes, mean != 0, s));
    case 1:
      return static_cast<int>(launch_index<__nv_bfloat16>(
          g, idx, mask, dst, nd, f, d, idx_bytes, mean != 0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
