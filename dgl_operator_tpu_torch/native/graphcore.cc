// graphcore — host-side irregular graph kernels for dgl_operator_tpu_torch.
//
// CSR construction, fixed-fanout neighbour sampling, frontier compaction
// and the partitioner's kernels (greedy BFS seeding, heavy-edge-matching
// coarsening, boundary refinement). The card never sees this code: it
// prepares the fixed-shape tables the card consumes. The functions and
// their C ABI are those of the JAX package's native graph core, so the
// same seeds give the same samples and partitions in both packages.
// Exposed as a plain C ABI through ctypes (graph/_native.py), which
// releases the interpreter lock for the length of every call.
//
// Built at first use by ops/_build.py::build_host with the host C++
// compiler: -O2 -std=c++17 -fPIC -Wall -shared, and nothing that lets
// the compiler reorder or contract float arithmetic.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// Counting-sort COO (rows, cols) into CSR. Outputs:
//   indptr  [num_nodes+1] int64
//   indices [num_edges]   int32   column of each edge, grouped by row
//   eids    [num_edges]   int64   original edge position (stable order)
void gc_build_csr(const int32_t* rows, const int32_t* cols, int64_t num_edges,
                  int64_t num_nodes, int64_t* indptr, int32_t* indices,
                  int64_t* eids) {
  std::memset(indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < num_edges; ++e) indptr[rows[e] + 1]++;
  for (int64_t i = 0; i < num_nodes; ++i) indptr[i + 1] += indptr[i];
  std::vector<int64_t> cursor(indptr, indptr + num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    const int64_t pos = cursor[rows[e]]++;
    indices[pos] = cols[e];
    eids[pos] = e;
  }
}

// splitmix64 — tiny counter-based PRNG, deterministic given (seed, counter).
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Uniform fixed-fanout sampling without replacement per seed node.
// Degree <= fanout keeps everything, pads with -1 (DGL's
// sample_neighbors(replace=False)). Floyd's algorithm keeps it O(fanout)
// per node regardless of degree.
void gc_sample_fanout(const int64_t* indptr, const int32_t* indices,
                      const int64_t* eids, int64_t num_nodes,
                      const int64_t* seeds, int64_t num_seeds, int32_t fanout,
                      uint64_t seed, int32_t* out_nbr, int32_t* out_eid) {
  std::vector<int64_t> picks(fanout);
  for (int64_t i = 0; i < num_seeds; ++i) {
    const int64_t v = seeds[i];
    int32_t* nbr_row = out_nbr + i * fanout;
    int32_t* eid_row = out_eid + i * fanout;
    if (v < 0 || v >= num_nodes) {
      std::fill(nbr_row, nbr_row + fanout, -1);
      std::fill(eid_row, eid_row + fanout, -1);
      continue;
    }
    const int64_t lo = indptr[v], hi = indptr[v + 1];
    const int64_t deg = hi - lo;
    int64_t npick;
    if (deg <= fanout) {
      npick = deg;
      for (int64_t k = 0; k < deg; ++k) picks[k] = lo + k;
    } else {
      // Floyd's sampling: uniform without replacement, O(fanout).
      npick = fanout;
      uint64_t ctr = seed ^ (0x9e3779b97f4a7c15ULL * (uint64_t)(v + 1));
      int64_t n = 0;
      for (int64_t j = deg - fanout; j < deg; ++j) {
        const int64_t t = (int64_t)(splitmix64(ctr++) % (uint64_t)(j + 1));
        bool dup = false;
        for (int64_t k = 0; k < n; ++k)
          if (picks[k] == lo + t) { dup = true; break; }
        picks[n++] = lo + (dup ? j : t);
      }
    }
    for (int64_t k = 0; k < fanout; ++k) {
      if (k < npick) {
        nbr_row[k] = indices[picks[k]];
        eid_row[k] = (int32_t)eids[picks[k]];
      } else {
        nbr_row[k] = -1;
        eid_row[k] = -1;
      }
    }
  }
}

// Greedy BFS edge-cut partitioner: grow num_parts regions breadth-first from
// spread seeds, each step extending the currently-smallest part at its
// frontier. Produces contiguous, balanced regions with low edge cut on
// locality-friendly graphs; graph/partition.py seeds its assignment with it.
void gc_greedy_partition(const int64_t* indptr, const int32_t* indices,
                         int64_t num_nodes, int32_t num_parts, uint64_t seed,
                         int32_t* parts) {
  // empty graph: nothing to assign — and the random-probe modulo below
  // would divide by zero
  if (num_nodes <= 0) return;
  std::fill(parts, parts + num_nodes, -1);
  if (num_parts <= 1) {
    std::fill(parts, parts + num_nodes, 0);
    return;
  }
  std::vector<std::queue<int64_t>> frontier(num_parts);
  std::vector<int64_t> sizes(num_parts, 0);
  uint64_t ctr = seed;
  auto next_unassigned = [&]() -> int64_t {
    // random probes then linear scan fallback
    for (int t = 0; t < 64; ++t) {
      int64_t c = (int64_t)(splitmix64(ctr++) % (uint64_t)num_nodes);
      if (parts[c] < 0) return c;
    }
    for (int64_t u = 0; u < num_nodes; ++u)
      if (parts[u] < 0) return u;
    return -1;
  };
  for (int32_t p = 0; p < num_parts; ++p) {
    const int64_t s = next_unassigned();
    if (s < 0) break;
    parts[s] = p;
    sizes[p] = 1;
    frontier[p].push(s);
  }
  int64_t assigned = 0;
  for (int64_t u = 0; u < num_nodes; ++u) assigned += (parts[u] >= 0);
  while (assigned < num_nodes) {
    // pick the smallest part that still has a frontier
    int32_t best = -1;
    for (int32_t p = 0; p < num_parts; ++p)
      if (!frontier[p].empty() && (best < 0 || sizes[p] < sizes[best]))
        best = p;
    if (best < 0) {
      // all frontiers empty but nodes remain (disconnected component):
      // reseed the smallest part
      best = 0;
      for (int32_t p = 1; p < num_parts; ++p)
        if (sizes[p] < sizes[best]) best = p;
      const int64_t s = next_unassigned();
      parts[s] = best;
      sizes[best]++;
      assigned++;
      frontier[best].push(s);
      continue;
    }
    const int64_t u = frontier[best].front();
    frontier[best].pop();
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      const int64_t w = indices[e];
      if (parts[w] < 0) {
        parts[w] = best;
        sizes[best]++;
        assigned++;
        frontier[best].push(w);
      }
    }
  }
}

// Frontier compaction for multi-layer sampling (the per-layer hot path
// of graph/blocks.py build_fanout_blocks). Given the current frontier
// (the block's dst prefix) and the sampled neighbor table, emits the next
// source-node array [frontier..., sorted new unique neighbors...] — optionally
// capped, dropping a random subset of the NEW nodes (the respill of
// calibrated caps) — plus per-slot positions into it and the validity
// mask (dropped or invalid slots: pos 0, mask 0).
//
//   frontier [nf] int64, nbr [ns*fanout] int32 (-1 = empty slot)
//   cap < 0 = uncapped
//   src_nodes: caller-allocated, >= nf + ns*fanout entries
void gc_compact_frontier(const int64_t* frontier, int64_t nf,
                         const int32_t* nbr, int64_t ns, int32_t fanout,
                         int64_t cap, uint64_t seed, int64_t* src_nodes,
                         int64_t* n_src_out, int32_t* pos, float* mask) {
  const int64_t nslots = ns * (int64_t)fanout;
  std::unordered_map<int64_t, int64_t> index;
  index.reserve((size_t)(nf + nslots));
  for (int64_t i = 0; i < nf; ++i) {
    src_nodes[i] = frontier[i];
    index.emplace(frontier[i], i);
  }
  std::vector<int64_t> news;
  for (int64_t s = 0; s < nslots; ++s) {
    const int64_t id = nbr[s];
    if (id < 0) continue;
    if (index.emplace(id, -1).second) news.push_back(id);
  }
  if (cap >= 0 && nf + (int64_t)news.size() > cap) {
    // respill: keep a uniform random subset of the new nodes
    // (partial Fisher–Yates), deterministic in `seed`
    const int64_t keep = std::max<int64_t>(cap - nf, 0);
    uint64_t ctr = seed;
    for (int64_t i = 0; i < keep; ++i) {
      const int64_t j =
          i + (int64_t)(splitmix64(ctr++) %
                        (uint64_t)((int64_t)news.size() - i));
      std::swap(news[i], news[j]);
    }
    news.resize((size_t)keep);
  }
  // sorted-unique ordering matches the plain numpy version (np.unique)
  std::sort(news.begin(), news.end());
  for (size_t k = 0; k < news.size(); ++k) {
    index[news[k]] = nf + (int64_t)k;
    src_nodes[nf + (int64_t)k] = news[k];
  }
  *n_src_out = nf + (int64_t)news.size();
  for (int64_t s = 0; s < nslots; ++s) {
    const int64_t id = nbr[s];
    int64_t p = -1;
    if (id >= 0) {
      const auto it = index.find(id);
      if (it != index.end()) p = it->second;
    }
    pos[s] = (p >= 0) ? (int32_t)p : 0;
    mask[s] = (p >= 0) ? 1.0f : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Multilevel partitioning kernels (the METIS structure): heavy-edge-matching
// coarsening and boundary-restricted refinement. Both consume an undirected weighted graph
// given as a COO edge list (each undirected pair once is enough; duplicates
// and both-direction inputs are fine — weights just accumulate) and build
// the symmetric CSR internally.

// Symmetric weighted CSR from a COO list: adjacency rows contain first the
// u->v entries then the v->u entries, each group in input order — the exact
// layout numpy's stable argsort over the concatenated arrays produces, so
// the plain numpy version can mirror traversal order bit-for-bit.
static void build_sym_csr(const int32_t* u, const int32_t* v, const float* w,
                          int64_t ne, int64_t n, std::vector<int64_t>* indptr,
                          std::vector<int32_t>* adj, std::vector<float>* aw) {
  indptr->assign(n + 1, 0);
  for (int64_t e = 0; e < ne; ++e) {
    (*indptr)[u[e] + 1]++;
    (*indptr)[v[e] + 1]++;
  }
  for (int64_t i = 0; i < n; ++i) (*indptr)[i + 1] += (*indptr)[i];
  adj->resize(2 * ne);
  aw->resize(2 * ne);
  std::vector<int64_t> cur(indptr->begin(), indptr->begin() + n);
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t p = cur[u[e]]++;
    (*adj)[p] = v[e];
    (*aw)[p] = w[e];
  }
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t p = cur[v[e]]++;
    (*adj)[p] = u[e];
    (*aw)[p] = w[e];
  }
}

// One level of heavy-edge-matching coarsening (Karypis & Kumar '98): visit
// vertices in a seeded random order; each unmatched vertex matches its
// max-weight unmatched neighbor (first wins on ties, CSR row order).
// Matched pairs contract into one coarse vertex (ids assigned in ascending
// fine-vertex order); parallel coarse edges merge with accumulated weight,
// self-loops drop (their mass lives on in the coarse vertex weights).
//
//   u, v, w  [ne]  undirected COO (one direction per pair suffices)
//   vw       [n]   vertex weights
//   coarse_id[n]   out: fine -> coarse vertex id
//   cu/cv/cw [<=ne] out: coarse COO, each pair once (cu < cv), sorted
//   cvw      [<=n] out: coarse vertex weights
void gc_hem_coarsen(const int32_t* u, const int32_t* v, const float* w,
                    int64_t ne, const float* vw, int64_t n, uint64_t seed,
                    int32_t* coarse_id, int32_t* cu, int32_t* cv, float* cw,
                    float* cvw, int64_t* out_nc, int64_t* out_nce) {
  std::vector<int64_t> indptr;
  std::vector<int32_t> adj;
  std::vector<float> aw;
  build_sym_csr(u, v, w, ne, n, &indptr, &adj, &aw);

  // seeded Fisher-Yates visit order (mirrored by the plain version)
  std::vector<int64_t> perm(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  uint64_t ctr = seed;
  for (int64_t i = 0; i + 1 < n; ++i) {
    const int64_t j =
        i + (int64_t)(splitmix64(ctr++) % (uint64_t)(n - i));
    std::swap(perm[i], perm[j]);
  }

  std::vector<int64_t> match(n, -1);
  for (int64_t t = 0; t < n; ++t) {
    const int64_t x = perm[t];
    if (match[x] >= 0) continue;
    int64_t best = -1;
    float bw = 0.0f;
    for (int64_t p = indptr[x]; p < indptr[x + 1]; ++p) {
      const int64_t y = adj[p];
      if (y == x || match[y] >= 0) continue;
      if (best < 0 || aw[p] > bw) {
        best = y;
        bw = aw[p];
      }
    }
    if (best >= 0) {
      match[x] = best;
      match[best] = x;
    }
  }

  // coarse ids in ascending fine order (deterministic, mirrored by the
  // plain version)
  std::fill(coarse_id, coarse_id + n, -1);
  int32_t nc = 0;
  for (int64_t x = 0; x < n; ++x) {
    if (coarse_id[x] >= 0) continue;
    coarse_id[x] = nc;
    if (match[x] >= 0) coarse_id[match[x]] = nc;
    ++nc;
  }
  *out_nc = nc;

  // contract: walk each coarse vertex's (<=2) constituents, merging
  // duplicate targets through a per-row marker table; emit only cy > c so
  // each undirected coarse pair appears once with its full weight (every
  // input edge is seen from exactly one side).
  std::vector<int32_t> m1(nc, -1), m2(nc, -1);
  for (int64_t x = 0; x < n; ++x) {
    const int32_t c = coarse_id[x];
    if (m1[c] < 0) m1[c] = (int32_t)x; else m2[c] = (int32_t)x;
  }
  std::vector<int32_t> owner(nc, -1);
  std::vector<int64_t> slot(nc, -1);
  std::vector<std::pair<int32_t, float>> row;
  int64_t pos = 0;
  for (int32_t c = 0; c < nc; ++c) {
    row.clear();
    float cweight = 0.0f;
    const int32_t members[2] = {m1[c], m2[c]};
    for (int mi = 0; mi < 2; ++mi) {
      const int32_t x = members[mi];
      if (x < 0) continue;
      cweight += vw[x];
      for (int64_t p = indptr[x]; p < indptr[x + 1]; ++p) {
        const int32_t cy = coarse_id[adj[p]];
        if (cy <= c) continue;
        if (owner[cy] == c) {
          row[slot[cy]].second += aw[p];
        } else {
          owner[cy] = c;
          slot[cy] = (int64_t)row.size();
          row.emplace_back(cy, aw[p]);
        }
      }
    }
    cvw[c] = cweight;
    std::sort(row.begin(), row.end());
    for (const auto& e : row) {
      cu[pos] = c;
      cv[pos] = e.first;
      cw[pos] = e.second;
      ++pos;
    }
  }
  *out_nce = pos;
}

// Boundary-restricted refinement (the KL/FM role in the multilevel
// pipeline): a worklist seeded with the cut vertices; each visit moves the
// vertex to its max-connection part when that strictly reduces the weighted
// cut — or, for balance, on a tie that shrinks the heavier part, or
// unconditionally while the vertex's own part exceeds `cap` — subject to
// the target staying within `cap` total vertex weight. Moves re-enqueue the
// neighbors; `max_steps` bounds total visits (METIS-style few-pass budget).
void gc_refine_boundary(const int32_t* u, const int32_t* v, const float* w,
                        int64_t ne, const float* vw, int64_t n,
                        int32_t num_parts, double cap, int64_t max_steps,
                        int32_t* parts) {
  if (num_parts <= 1 || n == 0) return;
  std::vector<int64_t> indptr;
  std::vector<int32_t> adj;
  std::vector<float> aw;
  build_sym_csr(u, v, w, ne, n, &indptr, &adj, &aw);
  std::vector<double> pw(num_parts, 0.0);
  for (int64_t x = 0; x < n; ++x) pw[parts[x]] += vw[x];
  std::vector<uint8_t> queued(n, 0);
  std::queue<int64_t> work;
  for (int64_t e = 0; e < ne; ++e) {
    if (parts[u[e]] != parts[v[e]]) {
      if (!queued[u[e]]) { queued[u[e]] = 1; work.push(u[e]); }
      if (!queued[v[e]]) { queued[v[e]] = 1; work.push(v[e]); }
    }
  }
  std::vector<double> conn(num_parts, 0.0);
  std::vector<int32_t> touched;
  int64_t steps = 0;
  while (!work.empty() && steps < max_steps) {
    const int64_t x = work.front();
    work.pop();
    queued[x] = 0;
    ++steps;
    const int32_t px = parts[x];
    touched.clear();
    for (int64_t p = indptr[x]; p < indptr[x + 1]; ++p) {
      const int32_t py = parts[adj[p]];
      if (conn[py] == 0.0) touched.push_back(py);
      conn[py] += aw[p];
    }
    int32_t best = -1;
    double bconn = -1.0;
    for (const int32_t py : touched) {
      if (py == px) continue;
      if (pw[py] + vw[x] > cap) continue;
      if (conn[py] > bconn || (conn[py] == bconn && py < best)) {
        best = py;
        bconn = conn[py];
      }
    }
    const double cconn = conn[px];
    for (const int32_t py : touched) conn[py] = 0.0;
    if (best < 0) continue;
    const bool gain = bconn > cconn;
    const bool tie_balance = bconn == cconn && pw[px] > pw[best] + vw[x];
    const bool drain = pw[px] > cap;
    if (!(gain || tie_balance || drain)) continue;
    parts[x] = best;
    pw[px] -= vw[x];
    pw[best] += vw[x];
    for (int64_t p = indptr[x]; p < indptr[x + 1]; ++p) {
      const int64_t y = adj[p];
      if (!queued[y]) { queued[y] = 1; work.push(y); }
    }
  }
}

}  // extern "C"
