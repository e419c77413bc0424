// Fused fanout gather + masked sum/mean over a dense [ND, F] neighbor
// table, for sm_90a.
//
// Replaces: dgl_operator_tpu/ops/pallas_gather.py::fanout_sum_pallas
// (its body _fanout_kernel), together with the mean's division that
// dgl_operator_tpu/ops/fanout.py::fanout_mean does outside that kernel.
//
// Computes
//   out[i, :] = (sum over k with mask[i, k] != 0 of h[nbr[i, k], :])
//               / (mean ? max(cnt_i, 1) : 1)
// accumulating in fp32 and writing h's dtype (float32 or bfloat16).
// A row with no valid slot gives 0.
//
// Bound: HBM bytes. A call must read each distinct valid source row
// once (unique rows x D x sizeof(T)), write the output (ND x D x
// sizeof(T)) and read nbr and mask (ND x F x 5 bytes); the F x D adds
// per row are far below the card's arithmetic rate.
//
// Design: one warp per dst row, 8 rows per 256-thread block. The warp
// reads the row's mask and skips masked slots, so each valid row is
// read once per slot that names it and masked slots cost nothing: no
// spare zero row is appended to h (the TPU version copies all of
// [N, D] to add one) and padded dst rows read nothing but write zeros.
// Lanes stride over D with 16-byte loads when D and the pointers allow
// it (4 floats or 8 bf16), 8-byte loads for bf16 when D % 4 == 0, and
// scalar loads otherwise, so no width is refused. Rows shared by
// several dst rows are left to L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VW consecutive elements moved as one aligned load or store
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

template <typename T, int VW>
__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
    fanout_agg_kernel(const T* __restrict__ h,
                      const int32_t* __restrict__ nbr,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      int64_t nd, int64_t f, int64_t d, bool mean) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= nd) return;
  const int lane = threadIdx.x % kWarp;
  const int32_t* nrow = nbr + row * f;
  const uint8_t* mrow = mask + row * f;
  T* orow = out + row * d;
  int cnt = 0;
  for (int64_t k = 0; k < f; ++k) cnt += mrow[k] != 0;
  const float denom = mean ? static_cast<float>(max(cnt, 1)) : 1.0f;
  for (int64_t c = static_cast<int64_t>(lane) * VW; c < d;
       c += static_cast<int64_t>(kWarp) * VW) {
    float acc[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] = 0.0f;
    for (int64_t k = 0; k < f; ++k) {
      if (mrow[k] == 0) continue;
      const int64_t src = static_cast<int64_t>(nrow[k]);
      const Pack<T, VW> p =
          *reinterpret_cast<const Pack<T, VW>*>(h + src * d + c);
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] += to_float(p.v[j]);
    }
    Pack<T, VW> o;
#pragma unroll
    for (int j = 0; j < VW; ++j) o.v[j] = from_float<T>(acc[j] / denom);
    *reinterpret_cast<Pack<T, VW>*>(orow + c) = o;
  }
}

template <typename T>
cudaError_t launch_typed(const void* h, const void* nbr, const void* mask,
                         void* out, int64_t nd, int64_t f, int64_t d,
                         bool mean, cudaStream_t stream) {
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((nd + kRowsPerBlock - 1) /
                                        kRowsPerBlock));
  const T* hp = static_cast<const T*>(h);
  const int32_t* np = static_cast<const int32_t*>(nbr);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(out);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && addr % 16 == 0) {
    fanout_agg_kernel<T, kVec>
        <<<grid, block, 0, stream>>>(hp, np, mp, op, nd, f, d, mean);
  } else if (kVec > 4 && d % 4 == 0 && addr % (4 * sizeof(T)) == 0) {
    fanout_agg_kernel<T, 4>
        <<<grid, block, 0, stream>>>(hp, np, mp, op, nd, f, d, mean);
  } else {
    fanout_agg_kernel<T, 1>
        <<<grid, block, 0, stream>>>(hp, np, mp, op, nd, f, d, mean);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and does not
// synchronise; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int fanout_agg_launch(const void* h, const void* nbr,
                                 const void* mask, void* out, int64_t nd,
                                 int64_t f, int64_t d, int64_t dtype,
                                 int64_t mean, void* stream) {
  if (nd <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_typed<float>(h, nbr, mask, out, nd, f, d, mean != 0, s));
    case 1:
      return static_cast<int>(launch_typed<__nv_bfloat16>(
          h, nbr, mask, out, nd, f, d, mean != 0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
