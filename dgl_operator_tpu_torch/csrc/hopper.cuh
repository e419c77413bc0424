// Pieces the port's kernels share on sm_90a: the mbarrier and TMA
// bulk-copy instructions, and the launch queries (SMs, opt-in shared
// memory, resident blocks per SM) that a launcher asks once per device
// and kernel and then keeps.
//
// Each csrc/*.cu source includes this header and is built into its own
// shared library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(1)
               : "memory");
}

// arrive once and expect `bytes` of copies before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` a multiple of 16 at 16-byte aligned
// addresses, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global in the thread's bulk group; the shared bytes stay
// in use until bulk_wait_read returns
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// commit the thread's bulk stores and wait until they have read shared
// memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// What a launch asks of the runtime besides the launch, read once per
// device (SMs, opt-in shared memory) and per (device, kernel, threads,
// shared bytes) (resident blocks per SM; a kernel with dynamic shared
// memory is first allowed the device's whole opt-in amount), then kept
// for later launches.
std::mutex g_mu;
std::map<int, std::pair<int, int>> g_device;   // dev -> (sms, optin)
std::map<std::tuple<int, const void*, int, int64_t>, int> g_resident;

cudaError_t device_info(int* dev, int* sms, int* optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_device.find(*dev);
  if (it == g_device.end()) {
    int s = 0, o = 0;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &o, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    it = g_device.emplace(*dev, std::make_pair(s, o)).first;
  }
  *sms = it->second.first;
  *optin = it->second.second;
  return cudaSuccess;
}

// Blocks of `kernel` (`threads` threads, `smem` dynamic shared bytes)
// resident on one SM of device `dev` at once (at least 1).
template <typename K>
cudaError_t resident_per_sm(K kernel, int dev, int optin, int threads,
                            int64_t smem, int* per_sm) {
  const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel),
                                   threads, smem);
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_resident.find(key);
  if (it == g_resident.end()) {
    int n = 0;
    cudaError_t err = cudaSuccess;
    // above 48 KB only once the kernel is allowed that much
    if (smem > 0)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, threads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    it = g_resident.emplace(key, n > 1 ? n : 1).first;
  }
  *per_sm = it->second;
  return cudaSuccess;
}

}  // namespace
