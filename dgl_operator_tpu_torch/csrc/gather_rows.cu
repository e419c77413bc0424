// Row gather out[i, :] = table[idx[i], :], for sm_90a: the trainer's
// input-feature load (the reference's load_subtensor).
//
// Replaces: dgl_operator_tpu/ops/pallas_gather.py::gather_rows_pallas
// (its body _gather_kernel). The Pallas kernel takes only D % 128 == 0
// and falls back to jnp.take otherwise (D=100 on ogbn-products); this
// kernel takes every width.
//
// Bound: HBM bytes. A call must read each distinct row it names once
// (unique rows x D x sizeof(T)), write the output (M x D x sizeof(T))
// and read idx (M x sizeof(index)); it does no arithmetic.
//
// Design: one warp per output row, 8 rows per 256-thread block. The
// warp reads the row's index once, then its lanes stride over D with
// 16-byte loads and stores when D and the pointers allow it (4 floats
// or 8 bf16), 8-byte moves for bf16 when D % 4 == 0, and scalar moves
// otherwise. Offsets are int64, so a table of more than 2^31 elements
// (ogbn-products at full size is 245M) is addressed correctly. Rows
// named by several outputs are left to L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

// VW consecutive elements moved as one aligned load or store
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

template <typename T, typename I, int VW>
__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
    gather_rows_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                       T* __restrict__ out, int64_t m, int64_t d) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= m) return;
  const int lane = threadIdx.x % kWarp;
  const T* src = table + static_cast<int64_t>(idx[row]) * d;
  T* dst = out + row * d;
  for (int64_t c = static_cast<int64_t>(lane) * VW; c < d;
       c += static_cast<int64_t>(kWarp) * VW) {
    *reinterpret_cast<Pack<T, VW>*>(dst + c) =
        *reinterpret_cast<const Pack<T, VW>*>(src + c);
  }
}

template <typename T, typename I>
cudaError_t launch_typed(const void* table, const void* idx, void* out,
                         int64_t m, int64_t d, cudaStream_t stream) {
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((m + kRowsPerBlock - 1) /
                                        kRowsPerBlock));
  const T* tp = static_cast<const T*>(table);
  const I* ip = static_cast<const I*>(idx);
  T* op = static_cast<T*>(out);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && addr % 16 == 0) {
    gather_rows_kernel<T, I, kVec><<<grid, block, 0, stream>>>(tp, ip, op, m, d);
  } else if (kVec > 4 && d % 4 == 0 && addr % (4 * sizeof(T)) == 0) {
    gather_rows_kernel<T, I, 4><<<grid, block, 0, stream>>>(tp, ip, op, m, d);
  } else {
    gather_rows_kernel<T, I, 1><<<grid, block, 0, stream>>>(tp, ip, op, m, d);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_index(const void* table, const void* idx, void* out,
                         int64_t m, int64_t d, int64_t idx_bytes,
                         cudaStream_t stream) {
  if (idx_bytes == 4) {
    return launch_typed<T, int32_t>(table, idx, out, m, d, stream);
  }
  if (idx_bytes == 8) {
    return launch_typed<T, int64_t>(table, idx, out, m, d, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; idx_bytes: 4 (int32) or 8 (int64).
// Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  void* out, int64_t m, int64_t d,
                                  int64_t dtype, int64_t idx_bytes,
                                  void* stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_index<float>(table, idx, out, m, d, idx_bytes, s));
    case 1:
      return static_cast<int>(
          launch_index<__nv_bfloat16>(table, idx, out, m, d, idx_bytes, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
