// Row gather out[i, :] = table[idx[i], :], for sm_90a: the trainer's
// input-feature load (the reference's load_subtensor), the halo
// exchange's row serving and the KGE embedding lookups.
//
// Replaces: dgl_operator_tpu/ops/pallas_gather.py::gather_rows_pallas
// (its body _gather_kernel). The Pallas kernel takes only D % 128 == 0
// and falls back to jnp.take otherwise (D=100 on ogbn-products); this
// kernel takes every width.
//
// Bound: HBM bytes. A call must read each distinct row it names once
// (unique rows x D x sizeof(T)), write the output (M x D x sizeof(T))
// and read idx (M x sizeof(index)); it does no arithmetic. What keeps a
// gather from that bound is latency: a call is one dependent round trip
// for its ids and one for its rows, and HBM gives its 3.35 TB/s only
// with some 18 KB in flight on each of the 132 SMs (Little's law at
// about 0.7 us). At the KGE lookups (1,024 and 2,304 rows) a call also
// sits on a fixed floor: one near-empty launch under the same timer
// takes 4.7-5.1 us on an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py's
// and chip_smoke.py's floor line), half to two thirds of the call.
//
// Design: the Pallas body starts the DMA of every row of its tile, then
// waits on them all; here a block puts every row of its range in flight
// before anything waits. Blocks take balanced contiguous ranges of
// output rows (sizes differ by at most one), and a block loads its
// range's ids in one coalesced load: one dependent round trip per
// block, not one per row.
//
// Register path (every row the bulk path does not take). The block's
// rows x packs (a pack: W bytes moved as one access, W = 16, 8, 4, 2 or
// 1, the widest that the row and both pointers allow) are one flat range;
// thread t takes packs t, t + 256, ..., at most K of them, issues all K
// loads and only then its K stores. K (1, 2, 4 or 8) is a template
// constant, so the loads are unrolled and issued before the first
// store (a loop with a run-time trip count was compiled to wait for
// each row load before its store), and no lane idles at 25 packs a row.
// A row wider than 256 x 8 packs takes a block to itself in rounds of
// 256 x 8 packs. The launch takes the smallest K whose grid fits on
// the card at once (resident blocks per SM, queried once per device
// and kernel and kept), and at least one block per SM: a launch of
// 1,024 rows puts work on every SM. When no K fits, K = 8 and the grid
// runs in waves.
//
// Bulk path (rows of at least kBulkMinRowBytes, a multiple of 16, table
// and out 16-byte aligned: the KGE tables' 1,600-byte rows). The Hopper
// form of the Pallas DMA loop: a block of one warp, a row a lane, arms
// one mbarrier for all its rows' bytes, each lane issues one TMA bulk
// copy (cp.async.bulk global -> shared) of its row, and once the
// barrier completes one bulk store writes the block's contiguous output
// range from shared memory. At 1,600-byte rows it beat the register
// path by 0.1-0.35 us in two A/B calls (PERF.md).
//
// Element sizes: 4 (float32), 2 (bfloat16) and 1 (int8 and uint8 codes
// of a quantized feature store, graph/quant.py). The kernel copies
// bytes and never reads a value, so one code serves both code types, as
// the Pallas kernel's row DMA serves every dtype. A row of codes has
// any length: ogbn-products' D = 100 gives 100-byte rows (4-byte
// aligned, not 16), D = 602 rows that start on 2-byte boundaries, an
// odd D rows of single bytes; the pack width above follows the row and
// the pointers, so no vector width is assumed, and rows of at least
// kBulkMinRowBytes, a multiple of 16, take the bulk path as float rows
// do.
//
// Offsets are int64, so a table of more than 2^31 elements (ogbn-products
// at full size is 245M, Wikidata5M's entities 1.8G) is addressed
// correctly.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;       // register path: threads per block
constexpr int kMaxRows = kThreads;  // rows a block holds: one id a thread
constexpr int kMaxPacks = 8;        // register path: loads a thread holds
constexpr int kBarBytes = 128;      // bulk path: the mbarrier, then rows
constexpr int kBulkMaxRows = kWarp; // bulk path: rows a block holds
// bulk path only for rows of at least this many bytes
constexpr int64_t kBulkMinRowBytes = 512;

// W bytes moved as one aligned access: the gather copies bytes, so the
// table's dtype only sets the row's size
template <int W>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = uint32_t;
};
template <>
struct Word<2> {
  using type = uint16_t;
};
template <>
struct Word<1> {
  using type = uint8_t;
};

// Block blockIdx.x's rows [*row0, *row0 + *rows) of m: the first
// m % gridDim.x blocks take one row more than the others.
__device__ __forceinline__ void block_rows(int64_t m, int64_t* row0,
                                           int* rows) {
  const int64_t b = blockIdx.x, g = gridDim.x;
  const int64_t q = m / g, r = m % g;
  *row0 = b * q + (b < r ? b : r);
  *rows = static_cast<int>(q + (b < r ? 1 : 0));
}

template <typename I, int W, int K>
__global__ void __launch_bounds__(kThreads)
    gather_rows_regs(const typename Word<W>::type* __restrict__ table,
                     const I* __restrict__ idx,
                     typename Word<W>::type* __restrict__ out, int64_t m,
                     int packs) {
  using P = typename Word<W>::type;
  __shared__ int64_t src[kMaxRows];   // first pack of each row's source
  int64_t row0;
  int rows;
  block_rows(m, &row0, &rows);
  const int tid = threadIdx.x;
  if (tid < rows) src[tid] = static_cast<int64_t>(idx[row0 + tid]) * packs;
  __syncthreads();
  P* dst = out + row0 * packs;   // the block's output rows are contiguous
  const int total = rows * packs;
  for (int base = 0; base < total; base += kThreads * K) {
    P v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int q = base + tid + j * kThreads;
      if (q < total) {
        const int r = q / packs;
        v[j] = table[src[r] + (q - r * packs)];
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int q = base + tid + j * kThreads;
      if (q < total) dst[q] = v[j];
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(kWarp)
    gather_rows_bulk(const unsigned char* __restrict__ table,
                     const I* __restrict__ idx,
                     unsigned char* __restrict__ out, int64_t m,
                     uint32_t row_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  int64_t row0;
  int rows;
  block_rows(m, &row0, &rows);
  const int lane = threadIdx.x;
  const uint32_t bar = smem_addr(smem);
  const uint32_t stage = smem_addr(smem + kBarBytes);
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the barrier expects every byte before any copy can complete it
    mbar_expect(bar, static_cast<uint32_t>(rows) * row_bytes);
  }
  __syncwarp();
  if (lane < rows) {
    bulk_copy(stage + lane * row_bytes,
              table + static_cast<int64_t>(idx[row0 + lane]) * row_bytes,
              row_bytes, bar);
  }
  mbar_wait(bar, 0);
  if (lane == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_store(out + row0 * row_bytes, stage,
               static_cast<uint32_t>(rows) * row_bytes);
    bulk_wait_read();
  }
}

template <typename I, int W>
cudaError_t launch_regs(const void* table, const void* idx, void* out,
                        int64_t m, int64_t row_bytes, int dev, int sms,
                        int optin, cudaStream_t stream) {
  using P = typename Word<W>::type;
  using Kernel = void (*)(const P*, const I*, P*, int64_t, int);
  constexpr int kKs[] = {1, 2, 4, kMaxPacks};
  const Kernel kernels[] = {
      gather_rows_regs<I, W, 1>, gather_rows_regs<I, W, 2>,
      gather_rows_regs<I, W, 4>, gather_rows_regs<I, W, kMaxPacks>};
  const int64_t packs = row_bytes / W;
  // a block's flat range stays an int
  if (packs > (int64_t{1} << 30)) return cudaErrorInvalidValue;
  for (int c = 0; c < 4; ++c) {
    const int64_t fit = std::min<int64_t>(kMaxRows,
                                          kThreads * kKs[c] / packs);
    if (fit == 0 && c < 3) continue;    // a row needs more loads a thread
    const int64_t rows = std::max<int64_t>(fit, 1);
    int64_t blocks = (m + rows - 1) / rows;
    int per_sm = 0;
    const cudaError_t err =
        resident_per_sm(kernels[c], dev, optin, kThreads, 0, &per_sm);
    if (err != cudaSuccess) return err;
    if (c < 3 && blocks > static_cast<int64_t>(per_sm) * sms) continue;
    blocks = std::max(blocks, std::min<int64_t>(m, sms));
    kernels[c]<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const P*>(table), static_cast<const I*>(idx),
        static_cast<P*>(out), m, static_cast<int>(packs));
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;   // not reached: the last K always fits
}

template <typename I>
cudaError_t launch_bulk(const void* table, const void* idx, void* out,
                        int64_t m, int64_t row_bytes, int dev, int sms,
                        int optin, cudaStream_t stream) {
  const int64_t fit = std::min<int64_t>(kBulkMaxRows,
                                        (optin - kBarBytes) / row_bytes);
  const int64_t blocks =
      std::max((m + fit - 1) / fit, std::min<int64_t>(m, sms));
  // allows the kernel the opt-in shared memory (once per row size)
  int per_sm = 0;
  const cudaError_t err = resident_per_sm(
      gather_rows_bulk<I>, dev, optin, kWarp, kBarBytes + fit * row_bytes,
      &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t smem = kBarBytes + (m + blocks - 1) / blocks * row_bytes;
  gather_rows_bulk<I><<<static_cast<unsigned>(blocks), kWarp, smem, stream>>>(
      static_cast<const unsigned char*>(table), static_cast<const I*>(idx),
      static_cast<unsigned char*>(out), m, static_cast<uint32_t>(row_bytes));
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_index(const void* table, const void* idx, void* out,
                         int64_t m, int64_t row_bytes, cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  const cudaError_t err = device_info(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes >= kBulkMinRowBytes && row_bytes % 16 == 0 &&
      addr % 16 == 0 && kBarBytes + row_bytes <= optin) {
    return launch_bulk<I>(table, idx, out, m, row_bytes, dev, sms, optin,
                          stream);
  }
  // the widest access that the row and both pointers allow
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch_regs<I, 16>(table, idx, out, m, row_bytes, dev, sms, optin,
                              stream);
  if (row_bytes % 8 == 0 && addr % 8 == 0)
    return launch_regs<I, 8>(table, idx, out, m, row_bytes, dev, sms, optin,
                             stream);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch_regs<I, 4>(table, idx, out, m, row_bytes, dev, sms, optin,
                             stream);
  if (row_bytes % 2 == 0 && addr % 2 == 0)
    return launch_regs<I, 2>(table, idx, out, m, row_bytes, dev, sms, optin,
                             stream);
  return launch_regs<I, 1>(table, idx, out, m, row_bytes, dev, sms, optin,
                           stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = one-byte codes (int8 or uint8);
// idx_bytes: 4 (int32) or 8 (int64).
// Launches on `stream` and does not synchronise; returns the first CUDA
// error of configuring or launching (0 = ok). The device and occupancy
// queries behind a launch's configuration are made once and kept.
extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  void* out, int64_t m, int64_t d,
                                  int64_t dtype, int64_t idx_bytes,
                                  void* stream) {
  if (m <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = d * (dtype == 0 ? 4 : dtype == 1 ? 2 : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4)
    return static_cast<int>(
        launch_index<int32_t>(table, idx, out, m, row_bytes, s));
  if (idx_bytes == 8)
    return static_cast<int>(
        launch_index<int64_t>(table, idx, out, m, row_bytes, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
