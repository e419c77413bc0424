// Tree sampling for the device sampler, for sm_90a: one launch a layer
// draws every fanout slot of the layer, reads the in-edge range of the
// slot's node and the neighbour the draw names, and writes the
// neighbour's id and validity into the tree's input ids and the block's
// mask; the same launch builds the backward plan of the layer before.
//
// Replaces no Pallas kernel: the JAX sampler
// (dgl_operator_tpu/ops/device_sample.py::sample_fanout_tree) is plain
// jnp. It replaces the port's plain torch path
// (ops/device_sample.py::sample_fanout_tree_from_draws over tree_draws,
// and ops/scatter.py::tree_scatter_plan), which took some 90 launches a
// layer: the key's and the draws' hash as int64 tensor ops (a multiply
// split into 16-bit halves), index_select, cat, cumsum and scatter_.
// That path stays the CPU's and what this kernel is held against.
//
// Bound: latency. A slot's work is three dependent reads (its node's id,
// the node's indptr pair, one entry of indices) and a few bytes
// written. At the cell's outer layer (26,000 rows of 10 slots) the
// least bytes are about 2.1 MB, 0.6 us at 3.35 TB/s; a launch is a few
// dependent HBM round trips and the launch itself.
//
// Design:
// - One thread a slot (i, k). A block of kThreads takes whole rows,
//   kThreads / F of them (one row, looped, past kThreads slots), so the
//   F threads of a row read its node's id and indptr pair from the same
//   sectors.
// - The key: every thread hashes the caller's parts in its prologue.
//   The host hashes the leading integer parts into `start`; a later
//   part is a host value or an int64 device scalar (the trainer's step
//   counter) read through its pointer when the kernel runs, so no tensor
//   op computes the key and a captured graph replays with the counter's
//   current value. Layer l's key is mix32(key ^ mix32(l + 1)) and slot
//   s = i * F + k draws mix32(mix32(s) ^ key_l) >> 1: the values of
//   ops/device_sample.py::draw_key and tree_draws, in 32-bit arithmetic.
// - Layers run in sampling order, the seeds' layer first, one launch
//   each: a layer reads the ids and validity its predecessors wrote
//   into the one [n_L] array (the first n ids are the seeds, written by
//   the first launch). Nothing is concatenated or copied.
// - The plan. A tree block's rows are wholly valid or wholly masked, so
//   a slot's running count of valid slots is F times the valid rows
//   before its row, plus k + 1 on a valid row. Each sampling block
//   counts its valid rows into counts[b]. The plan of a layer's block
//   is built by extra blocks of the next launch (the next layer's, or a
//   launch of its own after the last layer): a plan block sums the
//   counts before its rows and all of them, scans its rows' flags in
//   shared memory and writes offsets, src, cnt and long_part laid out as
//   tree_scatter_plan lays them (src's masked tail included). Its
//   blocks come first in the grid, beside the sampling ones.
// - Every shape is fixed by the batch and the fanouts, nothing syncs the
//   host and nothing is allocated here: the wrapper allocates outputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParts = 4;

struct KeyParts {
  uint32_t start;                 // the hash of the leading host parts
  const int64_t* ptr[kMaxParts];  // a device scalar part, or null
  uint32_t folded[kMaxParts];     // else the part folded to 32 bits
  int n;
};

// One layer's sampling: n rows of `fanout` slots.
template <typename I, typename S>
struct SampleJob {
  const I* indptr;
  const I* indices;
  int64_t last_ptr;
  int64_t last_idx;
  const S* seeds;  // the seeds' layer's row ids; null on a later layer
  I* ids;          // [n_L] the tree's ids; this layer writes [n, n + nF)
  uint8_t* valid;  // [n_L] their validity
  uint8_t* mask;   // [n, F]
  int32_t* counts; // valid rows a block, or null when no plan needs them
  int64_t n;
  int fanout;
  int rows_per_block;
  int blocks;
  int layer;
};

// The plan of an earlier layer's block: n rows of `fanout` slots.
struct PlanJob {
  const uint8_t* mask;
  const int32_t* counts;  // that layer's sampling blocks' valid rows
  int32_t* offsets;       // [n (F + 1) + 1]
  int32_t* src;           // [n F]
  int32_t* cnt;           // [n F] with slots, else [n]
  int32_t* long_part;     // [1]
  int64_t n;
  int fanout;
  int rows_per_block;
  int blocks;
  int slots;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t hash_key(const KeyParts& key) {
  uint32_t h = key.start;
  // unrolled, so the parts stay in parameter space (no stack copy)
#pragma unroll
  for (int j = 0; j < kMaxParts; ++j) {
    if (j < key.n) {
      uint32_t part = key.folded[j];
      if (key.ptr[j] != nullptr) {
        const uint64_t v = static_cast<uint64_t>(*key.ptr[j]);
        part = static_cast<uint32_t>(v) ^ static_cast<uint32_t>(v >> 32);
      }
      h = mix32(h ^ part);
    }
  }
  return h;
}

template <typename I, typename S>
__device__ __forceinline__ I seed_id(S seed) {
  const I f = static_cast<I>(seed);
  return f < 0 ? I(0) : f;
}

template <typename I, typename S>
__device__ void sample_rows(const SampleJob<I, S>& job, const KeyParts& key,
                            int b) {
  __shared__ int valid_rows;
  const int fan = job.fanout;
  const int64_t row0 = static_cast<int64_t>(b) * job.rows_per_block;
  const int64_t slots =
      min(static_cast<int64_t>(job.rows_per_block), job.n - row0) * fan;
  const uint32_t key_l =
      mix32(hash_key(key) ^ mix32(static_cast<uint32_t>(job.layer) + 1u));
  if (threadIdx.x == 0) valid_rows = 0;
  __syncthreads();
  int mine = 0;
  for (int64_t t = threadIdx.x; t < slots; t += kThreads) {
    const int64_t i = row0 + t / fan;
    const int k = static_cast<int>(t % fan);
    const int64_t s = i * fan + k;
    I f;
    bool up;
    if (job.seeds != nullptr) {
      const S seed = job.seeds[i];
      f = seed_id<I>(seed);
      up = seed >= 0;
      if (s < job.n) {  // the tree's first n ids: the seeds
        const S own = job.seeds[s];
        job.ids[s] = seed_id<I>(own);
        job.valid[s] = own >= 0;
      }
    } else {
      f = job.ids[i];
      up = job.valid[i] != 0;
    }
    const int64_t at_f = min(static_cast<int64_t>(f), job.last_ptr);
    const int64_t at_e = min(static_cast<int64_t>(f) + 1, job.last_ptr);
    const I start = job.indptr[at_f];
    const I deg = job.indptr[at_e] - start;
    const bool m = up && deg > 0;
    const I draw =
        static_cast<I>(mix32(mix32(static_cast<uint32_t>(s)) ^ key_l) >> 1);
    const int64_t at = min(
        max(static_cast<int64_t>(start) + (draw % (deg > 1 ? deg : I(1))),
            int64_t(0)),
        job.last_idx);
    const I nbr = job.indices[at];
    job.ids[job.n + s] = m ? nbr : I(0);
    job.valid[job.n + s] = m;
    job.mask[s] = m;
    mine += k == 0 && m;
  }
  if (job.counts != nullptr) {
    if (mine) atomicAdd(&valid_rows, mine);
    __syncthreads();
    if (threadIdx.x == 0) job.counts[b] = valid_rows;
  }
}

__device__ void build_plan(const PlanJob& job, int c) {
  __shared__ int sums[2];  // valid rows before this block's, and in all
  __shared__ int warp_sums[kWarps];
  __shared__ int rank[kThreads];
  __shared__ unsigned char row_valid[kThreads];
  const int fan = job.fanout;
  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(c) * job.rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<int64_t>(job.rows_per_block), job.n - row0));
  if (t < 2) sums[t] = 0;
  __syncthreads();
  int before = 0, all = 0;
  for (int j = t; j < job.blocks; j += kThreads) {
    const int v = job.counts[j];
    all += v;
    if (j < c) before += v;
  }
  if (before) atomicAdd(&sums[0], before);
  if (all) atomicAdd(&sums[1], all);
  // this block's rows' flags (rows <= kThreads), scanned
  const int v = t < rows ? job.mask[(row0 + t) * fan] != 0 : 0;
  const int lane = t & 31, warp = t >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += warp_sums[w];
  rank[t] = off + x - v;
  row_valid[t] = static_cast<unsigned char>(v);
  __syncthreads();
  const int rows_before = sums[0];
  const int nnz = fan * sums[1];
  for (int u = t; u < rows * fan; u += kThreads) {
    const int r = u / fan;
    const int k = u % fan;
    const int i = static_cast<int>(row0) + r;
    const int s = i * fan + k;
    const int vi = row_valid[r];
    const int run = fan * (rows_before + rank[r]) + (k + 1) * vi;
    job.offsets[job.n + 1 + s] = run;
    // the valid slots first, then the masked ones, each in slot order
    job.src[vi ? run - 1 : nnz + s - run] = job.slots ? s : i;
    if (job.slots)
      job.cnt[s] = vi;
    else if (k == 0)
      job.cnt[i] = fan * vi;
  }
  if (t < rows) job.offsets[row0 + t] = 0;
  if (c == job.blocks - 1 && t == 0) {
    job.offsets[job.n] = 0;
    job.long_part[0] = 0;
  }
}

template <typename I, typename S>
__global__ void __launch_bounds__(kThreads)
    tree_sample_layer(SampleJob<I, S> sample, PlanJob plan, KeyParts key) {
  const int b = static_cast<int>(blockIdx.x);
  if (b < plan.blocks)
    build_plan(plan, b);
  else
    sample_rows(sample, key, b - plan.blocks);
}

int rows_per_block(int64_t fanout) {
  return fanout >= kThreads ? 1 : kThreads / static_cast<int>(fanout);
}

int blocks_of(int64_t n, int rows) {
  return static_cast<int>((n + rows - 1) / rows);
}

struct Args {
  const void* indptr;
  const void* indices;
  int64_t last_ptr, last_idx;
  const void* seeds;
  void *ids, *valid, *mask, *counts;
  int64_t n, fanout, layer;
  KeyParts key;
  PlanJob plan;
};

template <typename I, typename S>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  SampleJob<I, S> job;
  job.indptr = static_cast<const I*>(a.indptr);
  job.indices = static_cast<const I*>(a.indices);
  job.last_ptr = a.last_ptr;
  job.last_idx = a.last_idx;
  job.seeds = static_cast<const S*>(a.seeds);
  job.ids = static_cast<I*>(a.ids);
  job.valid = static_cast<uint8_t*>(a.valid);
  job.mask = static_cast<uint8_t*>(a.mask);
  job.counts = static_cast<int32_t*>(a.counts);
  job.n = a.n;
  job.fanout = static_cast<int>(a.fanout);
  job.rows_per_block = a.n > 0 ? rows_per_block(a.fanout) : 1;
  job.blocks = a.n > 0 ? blocks_of(a.n, job.rows_per_block) : 0;
  job.layer = static_cast<int>(a.layer);
  const int grid = a.plan.blocks + job.blocks;
  if (grid == 0) return cudaSuccess;
  tree_sample_layer<I, S><<<grid, kThreads, 0, stream>>>(job, a.plan, a.key);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_seeds(const Args& a, int64_t seed_bytes,
                         cudaStream_t stream) {
  if (a.seeds == nullptr || seed_bytes == sizeof(I))
    return launch<I, I>(a, stream);
  if (seed_bytes == 4) return launch<I, int32_t>(a, stream);
  if (seed_bytes == 8) return launch<I, int64_t>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch: layer `layer` (sampling order) of n rows of `fanout` slots
// when n > 0, and the plan of an earlier layer's block (plan_n rows of
// plan_fanout slots, from its mask and counts) when plan_n > 0.
// idx_bytes: the CSR's index size, 4 or 8 (ids has that type);
// seeds: the seeds' layer's [n] ids (seed_bytes 4 or 8), else null;
// counts: at least one int32 a block (n is enough), or null; the key:
// key_start, then num_parts (<= 4) parts, each part_ptrs[j] (an int64
// device scalar) or, where that is null, part_vals[j]; plan_slots: the
// plan of the slots (else of the rows). Launches on `stream` and does
// not synchronise; returns the first CUDA error (0 = ok).
extern "C" int tree_sample_layer_launch(
    const void* indptr, const void* indices, int64_t num_ptr, int64_t num_idx,
    int64_t idx_bytes, const void* seeds, int64_t seed_bytes, void* ids,
    void* valid, void* mask, void* counts, int64_t n, int64_t fanout,
    int64_t layer, int64_t key_start, const void* const* part_ptrs,
    const uint32_t* part_vals, int64_t num_parts, const void* plan_mask,
    const void* plan_counts, void* offsets, void* src, void* cnt,
    void* long_part, int64_t plan_n, int64_t plan_fanout, int64_t plan_slots,
    void* stream) {
  if (num_parts < 0 || num_parts > kMaxParts || num_ptr < 1 || num_idx < 1 ||
      (n > 0 && fanout < 1) || (plan_n > 0 && plan_fanout < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.indptr = indptr;
  a.indices = indices;
  a.last_ptr = num_ptr - 1;
  a.last_idx = num_idx - 1;
  a.seeds = seeds;
  a.ids = ids;
  a.valid = valid;
  a.mask = mask;
  a.counts = counts;
  a.n = n;
  a.fanout = fanout;
  a.layer = layer;
  a.key.start = static_cast<uint32_t>(key_start);
  a.key.n = static_cast<int>(num_parts);
  for (int j = 0; j < kMaxParts; ++j) {
    a.key.ptr[j] = j < num_parts
                       ? static_cast<const int64_t*>(part_ptrs[j])
                       : nullptr;
    a.key.folded[j] = j < num_parts ? part_vals[j] : 0u;
  }
  PlanJob& p = a.plan;
  p.mask = static_cast<const uint8_t*>(plan_mask);
  p.counts = static_cast<const int32_t*>(plan_counts);
  p.offsets = static_cast<int32_t*>(offsets);
  p.src = static_cast<int32_t*>(src);
  p.cnt = static_cast<int32_t*>(cnt);
  p.long_part = static_cast<int32_t*>(long_part);
  p.n = plan_n;
  p.fanout = static_cast<int>(plan_fanout);
  p.rows_per_block = plan_n > 0 ? rows_per_block(plan_fanout) : 1;
  p.blocks = plan_n > 0 ? blocks_of(plan_n, p.rows_per_block) : 0;
  p.slots = static_cast<int>(plan_slots);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4)
    return static_cast<int>(launch_seeds<int32_t>(a, seed_bytes, s));
  if (idx_bytes == 8)
    return static_cast<int>(launch_seeds<int64_t>(a, seed_bytes, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
