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
// accumulating in fp32 in slot order and writing h's dtype (float32 or
// bfloat16). A row with no valid slot gives 0.
//
// Bound: HBM bytes. A call must read each distinct valid source row
// once (unique rows x D x sizeof(T)), write the output (ND x D x
// sizeof(T)) and read nbr and mask (ND x F x 5 bytes); the F x D adds
// per row are far below the card's arithmetic rate. What keeps a
// gather from that bound is latency: enough row bytes must be in
// flight on every SM.
//
// Two paths, picked per call from the row's size and alignment; both
// add a row's valid neighbours in slot order, so the result is
// deterministic, and neither refuses a width.
//
// The bulk path (rows of at least kBulkMinRowBytes, a multiple of 16,
// h 16-byte aligned: F=25, D=256 f32 and bf16). The Hopper counterpart
// of the Pallas body's double-buffered row DMAs. Each warp owns dst
// rows at a grid stride and a ring of kStages shared-memory stages of
// F rows each, with one mbarrier per stage. For a dst row, lane k reads
// slot k's index and mask byte (one coalesced load; F > 32 loops), the
// warp counts the valid slots with __ballot_sync/__popc, lane 0 arms
// the stage's barrier for valid x D x sizeof(T) bytes, and every lane
// with a valid slot issues one TMA bulk copy
// (cp.async.bulk...mbarrier::complete_tx::bytes) of its neighbour row
// into the stage, at the slot's rank among the valid ones. While those
// copies fly the warp sums the previous row's stage in slot order
// (lanes across columns), divides for the mean and stores. A row with
// no valid slot arms nothing and is not waited for. The ring and the
// warps per block are sized from the shared memory a block may opt in
// to (227 KB on the H100): 4 warps x 2 x 25 KB at F=25, D=256 f32. The
// grid is what stays resident, so each warp has its next row's copies
// in flight while it sums. Few rows (ND=64) get one warp each, all F
// copies of a row in flight at once; a row is not split across warps.
//
// The register path (every other row: F=10, D=100 f32, whose 400-byte
// rows do not repay a bulk copy's fixed cost in the copy engine, and
// bf16 at D=100 or D=37, which bulk copies cannot take). Warps take dst
// rows at a grid stride; lane k loads slot k's index and mask byte for
// the next row while the current row's neighbour rows are in flight,
// kInFlight of them issued before they are added, each lane holding VW
// columns (16, 8 or sizeof(T) bytes).
//
// Masked slots cost nothing beyond their mask byte: no spare zero row
// is appended to h (the TPU version copies all of [N, D] to add one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 2;          // bulk path: ring depth per warp
constexpr int kMaxWarps = 8;        // bulk path: warps per block
constexpr int kBarBytes = 128;      // bulk path: mbarriers, then stages
// bulk path only for rows of at least this many bytes: a bulk copy has
// a fixed cost in the copy engine that a 400-byte row does not repay
// (F=10, D=100 f32 on the H100: registers beat bulk copies, while
// 512- and 1024-byte rows go faster in bulk; PERF.md)
constexpr int64_t kBulkMinRowBytes = 512;
constexpr int kRowsPerBlock = 8;    // register path: one warp a row
constexpr int kInFlight = 4;        // register path: row loads in flight

// VW consecutive elements moved as one aligned load or store
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

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

// Issue the bulk copies of dst row `row`'s valid neighbour rows into
// `stage` (rank among the valid slots = position), armed on `bar`;
// returns the valid count (0: nothing armed).
template <typename T>
__device__ __forceinline__ int issue_row(
    const T* __restrict__ h, const int32_t* __restrict__ nbr,
    const uint8_t* __restrict__ mask, int64_t row, int64_t f, int64_t d,
    unsigned char* stage, uint32_t bar, int lane) {
  const int32_t* nrow = nbr + row * f;
  const uint8_t* mrow = mask + row * f;
  const uint32_t row_bytes = static_cast<uint32_t>(d * sizeof(T));
  int total = 0;
  for (int64_t k0 = 0; k0 < f; k0 += kWarp) {
    const int64_t k = k0 + lane;
    total += __popc(__ballot_sync(kFull, k < f && mrow[k] != 0));
  }
  if (total == 0) return 0;
  // the barrier expects every byte before any copy can complete it
  if (lane == 0) mbar_expect(bar, static_cast<uint32_t>(total) * row_bytes);
  __syncwarp();
  int base = 0;
  for (int64_t k0 = 0; k0 < f; k0 += kWarp) {
    const int64_t k = k0 + lane;
    const bool valid = k < f && mrow[k] != 0;
    const unsigned bits = __ballot_sync(kFull, valid);
    if (valid) {
      const int pos = base + __popc(bits & ((1u << lane) - 1u));
      bulk_copy(smem_addr(stage + static_cast<size_t>(pos) * row_bytes),
                h + static_cast<int64_t>(nrow[k]) * d, row_bytes, bar);
    }
    base += __popc(bits);
  }
  return total;
}

template <typename T, int VW>
__global__ void __launch_bounds__(kWarp* kMaxWarps)
    fanout_agg_bulk(const T* __restrict__ h,
                    const int32_t* __restrict__ nbr,
                    const uint8_t* __restrict__ mask, T* __restrict__ out,
                    int64_t nd, int64_t f, int64_t d, bool mean,
                    int64_t stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const uint32_t bar0 =
      smem_addr(smem) + static_cast<uint32_t>(warp * kStages * 8);
  unsigned char* ring =
      smem + kBarBytes + static_cast<size_t>(warp) * kStages * stage_bytes;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp;
  int cur = 0;
  if (row < nd) cur = issue_row(h, nbr, mask, row, f, d, ring, bar0, lane);
  uint32_t parity = 0;   // bit s: the phase stage s completes next
  for (int it = 0; row < nd; ++it, row += stride) {
    const int s = it % kStages;
    const int64_t next = row + stride;
    int nxt = 0;
    if (next < nd) {
      // the stage it refills was summed last iteration: every lane is
      // past its reads, and they are ordered before the copies' writes
      __syncwarp();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const int ns = (it + 1) % kStages;
      nxt = issue_row(h, nbr, mask, next, f, d, ring + ns * stage_bytes,
                      bar0 + 8 * ns, lane);
    }
    if (cur > 0) {
      mbar_wait(bar0 + 8 * s, (parity >> s) & 1u);
      parity ^= 1u << s;
    }
    const T* st = reinterpret_cast<const T*>(ring + s * stage_bytes);
    const float denom = mean ? static_cast<float>(max(cur, 1)) : 1.0f;
    T* orow = out + row * d;
    for (int64_t c = static_cast<int64_t>(lane) * VW; c < d;
         c += static_cast<int64_t>(kWarp) * VW) {
      float acc[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int r = 0; r < cur; ++r) {
        const Pack<T, VW> p =
            *reinterpret_cast<const Pack<T, VW>*>(st + r * d + c);
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[j] += to_float(p.v[j]);
      }
      Pack<T, VW> o;
#pragma unroll
      for (int j = 0; j < VW; ++j) o.v[j] = from_float<T>(acc[j] / denom);
      *reinterpret_cast<Pack<T, VW>*>(orow + c) = o;
    }
    cur = nxt;
  }
}

// Dst row `row` by one warp: my0/m0 are lane k's index and mask byte
// of slot k < 32 (loaded by the caller); slots past 32 are read here.
template <typename T, int VW>
__device__ __forceinline__ void aggregate_row(
    const T* __restrict__ h, const int32_t* __restrict__ nbr,
    const uint8_t* __restrict__ mask, T* __restrict__ out, int64_t row,
    int64_t f, int64_t d, bool mean, int32_t my0, uint8_t m0, int lane) {
  const int32_t* nrow = nbr + row * f;
  const uint8_t* mrow = mask + row * f;
  const unsigned bits0 = __ballot_sync(kFull, lane < f && m0 != 0);
  int cnt = __popc(bits0);
  for (int64_t k0 = kWarp; k0 < f; k0 += kWarp) {
    const int64_t k = k0 + lane;
    cnt += __popc(__ballot_sync(kFull, k < f && mrow[k] != 0));
  }
  const float denom = mean ? static_cast<float>(max(cnt, 1)) : 1.0f;
  for (int64_t base = 0; base < d; base += static_cast<int64_t>(kWarp) * VW) {
    const int64_t c = base + static_cast<int64_t>(lane) * VW;
    const bool on = c < d;
    float acc[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] = 0.0f;
    for (int64_t k0 = 0; k0 < f; k0 += kWarp) {
      int32_t my = my0;
      unsigned bits = bits0;
      if (k0 > 0) {
        const int64_t k = k0 + lane;
        const bool valid = k < f && mrow[k] != 0;
        my = valid ? nrow[k] : 0;
        bits = __ballot_sync(kFull, valid);
      }
      while (bits) {   // uniform across the warp
        int32_t src[kInFlight];
        int n = 0;
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int slot = bits ? __ffs(bits) - 1 : 0;
          src[u] = __shfl_sync(kFull, my, slot);
          if (bits) {
            bits &= bits - 1u;
            n = u + 1;
          }
        }
        Pack<T, VW> p[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (u < n && on)
            p[u] = *reinterpret_cast<const Pack<T, VW>*>(
                h + static_cast<int64_t>(src[u]) * d + c);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (u < n && on)
#pragma unroll
            for (int j = 0; j < VW; ++j) acc[j] += to_float(p[u].v[j]);
      }
    }
    if (on) {
      Pack<T, VW> o;
#pragma unroll
      for (int j = 0; j < VW; ++j) o.v[j] = from_float<T>(acc[j] / denom);
      *reinterpret_cast<Pack<T, VW>*>(out + row * d + c) = o;
    }
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
    fanout_agg_regs(const T* __restrict__ h,
                    const int32_t* __restrict__ nbr,
                    const uint8_t* __restrict__ mask, T* __restrict__ out,
                    int64_t nd, int64_t f, int64_t d, bool mean) {
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  // slots 0..31 (all of them for F <= 32) of a row: index and mask,
  // loaded one row ahead so they arrive while this row's rows do
  int32_t my_next = 0;
  uint8_t m_next = 0;
  if (row < nd && lane < f) {
    my_next = nbr[row * f + lane];
    m_next = mask[row * f + lane];
  }
  for (; row < nd; row += stride) {
    const int32_t my0 = my_next;
    const uint8_t m0 = m_next;
    const int64_t next = row + stride;
    if (next < nd && lane < f) {
      my_next = nbr[next * f + lane];
      m_next = mask[next * f + lane];
    }
    aggregate_row<T, VW>(h, nbr, mask, out, row, f, d, mean, my0, m0, lane);
  }
}

// The launch the data gets: path 1 = bulk copies (warps per block,
// dynamic shared bytes, bytes per stage), 0 = registers (VW columns a
// lane); blocks are what stays resident, at most one row a warp.
struct Config {
  int path, warps, vw;
  int64_t smem, blocks, stage_bytes;
};

template <typename K>
cudaError_t resident_blocks(K kernel, int dev, int sms, int optin, int warps,
                            int64_t smem, int64_t nd, int64_t* blocks) {
  int per_sm = 0;
  const cudaError_t err =
      resident_per_sm(kernel, dev, optin, warps * kWarp, smem, &per_sm);
  if (err != cudaSuccess) return err;
  *blocks = std::min<int64_t>((nd + warps - 1) / warps,
                              static_cast<int64_t>(per_sm) * sms);
  return cudaSuccess;
}

template <typename T>
cudaError_t configure(const void* h, const void* out, int64_t nd, int64_t f,
                      int64_t d, Config* cfg) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(T));
  const int64_t stage = f * row_bytes;
  const int64_t per_warp = kStages * stage;
  int dev = 0, sms = 0, optin = 0;
  const cudaError_t err = device_info(&dev, &sms, &optin);
  if (err != cudaSuccess) return err;
  if (row_bytes >= kBulkMinRowBytes && row_bytes % 16 == 0 &&
      reinterpret_cast<uintptr_t>(h) % 16 == 0 && stage > 0 &&
      kBarBytes + per_warp <= optin) {
    const int warps = static_cast<int>(
        std::min<int64_t>(kMaxWarps, (optin - kBarBytes) / per_warp));
    const int64_t smem = kBarBytes + warps * per_warp;
    *cfg = Config{1, warps, kVec, smem, 0, stage};
    return resident_blocks(fanout_agg_bulk<T, kVec>, dev, sms, optin, warps,
                           smem, nd, &cfg->blocks);
  }
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  *cfg = Config{0, kRowsPerBlock, 1, 0, 0, 0};
  if (d % kVec == 0 && addr % 16 == 0) {
    cfg->vw = kVec;
    return resident_blocks(fanout_agg_regs<T, kVec>, dev, sms, optin,
                           kRowsPerBlock, 0, nd, &cfg->blocks);
  }
  if (kVec > 4 && d % 4 == 0 && addr % (4 * sizeof(T)) == 0) {
    cfg->vw = 4;
    return resident_blocks(fanout_agg_regs<T, 4>, dev, sms, optin,
                           kRowsPerBlock, 0, nd, &cfg->blocks);
  }
  return resident_blocks(fanout_agg_regs<T, 1>, dev, sms, optin,
                         kRowsPerBlock, 0, nd, &cfg->blocks);
}

template <typename T>
cudaError_t launch_typed(const void* h, const void* nbr, const void* mask,
                         void* out, int64_t nd, int64_t f, int64_t d,
                         bool mean, cudaStream_t stream) {
  Config cfg;
  const cudaError_t err = configure<T>(h, out, nd, f, d, &cfg);
  if (err != cudaSuccess) return err;
  const T* hp = static_cast<const T*>(h);
  const int32_t* np = static_cast<const int32_t*>(nbr);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* op = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(cfg.blocks);
  const unsigned block = cfg.warps * kWarp;
  constexpr int kVec = 16 / sizeof(T);
  if (cfg.path == 1) {
    fanout_agg_bulk<T, kVec><<<grid, block, cfg.smem, stream>>>(
        hp, np, mp, op, nd, f, d, mean, cfg.stage_bytes);
  } else if (cfg.vw == kVec) {
    fanout_agg_regs<T, kVec>
        <<<grid, block, 0, stream>>>(hp, np, mp, op, nd, f, d, mean);
  } else if (cfg.vw == 4) {
    fanout_agg_regs<T, 4>
        <<<grid, block, 0, stream>>>(hp, np, mp, op, nd, f, d, mean);
  } else {
    fanout_agg_regs<T, 1>
        <<<grid, block, 0, stream>>>(hp, np, mp, op, nd, f, d, mean);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and does not
// synchronise; returns the first CUDA error of configuring or
// launching (0 = ok). The device and occupancy queries behind a launch's
// configuration are made once and kept.
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
