// HNSW graph build + search: the host component of faiss_tpu_torch's graph
// indexes (models/hnsw.py), a copy of faiss_tpu's native/hnsw.cpp kept in
// the port so that neither package loads or rebuilds the other's library.
// The code below is that file's, unchanged: the graph parity with faiss_tpu
// (same levels, same links, bit-identical float distances) needs the same
// seed, insertion order, arithmetic and compiler flags.
//
// Role: the reference implements HNSW in C++ (faiss/impl/HNSW.{h,cpp}) since
// graph construction is an inherently sequential, pointer-chasing workload.
// This is an independent implementation of the HNSW algorithm (Malkov &
// Yashunin, 2016): exponential level draws, greedy descent on upper levels,
// bounded beam (ef) search on level 0, and the distance-domination
// neighbor-shrink heuristic. Exposed as a C ABI for ctypes.
//
// Build (faiss_tpu_torch/host_build.py, at first use, into _build/):
//   g++ -O3 -march=native -shared -fPIC -fopenmp hnsw.cpp -o libhnsw.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using idx_t = int64_t;

// -- stats + cooperative cancellation (reference: impl/HNSW.h:260
// HNSWStats / AuxIndexStructures.h:138 InterruptCallback) ------------------
std::atomic<long long> g_n1{0};    // searches run
std::atomic<long long> g_ndis{0};  // distance evaluations (level-0 visits)
std::atomic<long long> g_nhops{0}; // beam-search expansions
std::atomic<int> g_stop{0};        // set by hnsw_set_interrupt

struct HNSW {
  int d = 0;
  int M = 32;             // neighbors per node on upper levels (2M on level 0)
  int ef_construction = 40;
  int metric = 1;         // 1 = L2, 0 = inner product
  idx_t ntotal = 0;
  int max_level = -1;
  idx_t entry_point = -1;
  double level_mult = 1.0;
  std::mt19937_64 rng{1234};

  std::vector<float> vecs;            // [ntotal, d]
  std::vector<int> levels;            // level of each node
  // neighbors: per node, per level: fixed slots (level0: 2M, others: M)
  // layout: offsets[node] .. per-level contiguous
  std::vector<std::vector<idx_t>> neighbors;  // [node][level concat]

  // Panorama progressive-refinement state (reference: IndexHNSW.h:171
  // IndexHNSWFlatPanorama): per-node SUFFIX norms at pano_levels+1
  // dimension boundaries; level-0 beam distances evaluate block-by-block
  // and prune when the Cauchy-Schwarz lower bound on the remaining
  // dimensions already exceeds the beam threshold.
  int pano_levels = 0;
  std::vector<float> cum_sums;  // [ntotal, pano_levels+1]

  int pano_boundary(int l) const {
    return (int)(((int64_t)l * d) / pano_levels);
  }

  void pano_suffix_norms(const float* v, float* out) const {
    // out[l] = ||v[b_l:]|| for l = 0..pano_levels
    int L = pano_levels;
    out[L] = 0.f;
    for (int l = L - 1; l >= 0; --l) {
      float s = out[l + 1] * out[l + 1];
      for (int i = pano_boundary(l); i < pano_boundary(l + 1); ++i)
        s += v[i] * v[i];
      out[l] = std::sqrt(s);
    }
  }

  void pano_update_cum_sums(idx_t from) {
    if (!pano_levels) return;
    cum_sums.resize((size_t)ntotal * (pano_levels + 1));
    for (idx_t i = from; i < ntotal; ++i)
      pano_suffix_norms(vecs.data() + (size_t)i * d,
                        cum_sums.data() + (size_t)i * (pano_levels + 1));
  }

  int nb_per_level(int level) const { return level == 0 ? 2 * M : M; }

  idx_t* neigh(idx_t node, int level) {
    size_t off = 0;
    for (int l = 0; l < level; ++l) off += nb_per_level(l);
    return neighbors[node].data() + off;
  }

  float dist(const float* a, const float* b) const {
    float s = 0;
    if (metric == 1) {
      for (int i = 0; i < d; ++i) {
        float t = a[i] - b[i];
        s += t * t;
      }
      return s;
    }
    for (int i = 0; i < d; ++i) s += a[i] * b[i];
    return -s;  // smaller = better
  }

  float dist_id(const float* q, idx_t id) const {
    return dist(q, vecs.data() + (size_t)id * d);
  }

  // Progressive L2 with early exit: evaluates dimension blocks in order;
  // after each block the remaining distance is lower-bounded by
  // (||q_rest|| - ||y_rest||)^2 (Cauchy-Schwarz), and evaluation stops as
  // soon as the bound exceeds ``thresh`` (returns a value > thresh).
  // qcs holds the query's suffix norms (pano_suffix_norms of q).
  float dist_pano(const float* q, idx_t id, const float* qcs,
                  float thresh) const {
    const float* y = vecs.data() + (size_t)id * d;
    const float* ycs = cum_sums.data() + (size_t)id * (pano_levels + 1);
    float s = 0.f;
    for (int l = 0; l < pano_levels; ++l) {
      for (int i = pano_boundary(l); i < pano_boundary(l + 1); ++i) {
        float t = q[i] - y[i];
        s += t * t;
      }
      float rq = qcs[l + 1], ry = ycs[l + 1];
      float rd = rq - ry;
      float lb = s + rd * rd;
      if (lb > thresh) return lb;
    }
    return s;
  }

  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = -std::log(std::max(u(rng), 1e-12)) * level_mult;
    return (int)r;
  }
};

using PairDI = std::pair<float, idx_t>;

// greedy descent to the nearest node on a given level
idx_t greedy_step(HNSW& h, const float* q, idx_t start, int level, float& dcur) {
  idx_t cur = start;
  bool improved = true;
  while (improved) {
    improved = false;
    idx_t* nb = h.neigh(cur, level);
    int nn = h.nb_per_level(level);
    for (int i = 0; i < nn; ++i) {
      idx_t v = nb[i];
      if (v < 0) break;
      float dv = h.dist_id(q, v);
      if (dv < dcur) {
        dcur = dv;
        cur = v;
        improved = true;
      }
    }
  }
  return cur;
}

// beam search on one level; returns up to ef closest as max-heap contents
std::vector<PairDI> search_level(
    HNSW& h, const float* q, idx_t entry, float dentry, int level, int ef,
    std::vector<uint8_t>& visited, std::vector<idx_t>& visited_list,
    const float* qcs = nullptr) {
  // qcs != nullptr engages Panorama progressive pruning on this level
  // (level-0 search only; upper-level greedy descent stays exact)
  const bool pano = qcs != nullptr && h.pano_levels > 0 && h.metric == 1;
  // visited is a byte map reused across calls; visited_list records touches
  std::priority_queue<PairDI> results;                       // max-heap (worst on top)
  std::priority_queue<PairDI, std::vector<PairDI>, std::greater<PairDI>> cands;
  results.emplace(dentry, entry);
  cands.emplace(dentry, entry);
  visited[entry] = 1;
  visited_list.push_back(entry);

  long long hops = 0;
  while (!cands.empty()) {
    auto [dc, c] = cands.top();
    if (dc > results.top().first && (idx_t)results.size() >= ef) break;
    cands.pop();
    ++hops;
    idx_t* nb = h.neigh(c, level);
    int nn = h.nb_per_level(level);
    for (int i = 0; i < nn; ++i) {
      idx_t v = nb[i];
      if (v < 0) break;
      if (visited[v]) continue;
      visited[v] = 1;
      visited_list.push_back(v);
      bool full = (idx_t)results.size() >= ef;
      float dv;
      if (pano) {
        float thresh = full ? results.top().first : INFINITY;
        dv = h.dist_pano(q, v, qcs, thresh);
        // a pruned candidate returned its lower bound > thresh: skip
        if (full && dv >= thresh) continue;
      } else {
        dv = h.dist_id(q, v);
      }
      if (!full || dv < results.top().first) {
        results.emplace(dv, v);
        cands.emplace(dv, v);
        if ((idx_t)results.size() > ef) results.pop();
      }
    }
  }
  g_nhops.fetch_add(hops, std::memory_order_relaxed);
  g_ndis.fetch_add((long long)visited_list.size(),
                   std::memory_order_relaxed);
  std::vector<PairDI> out;
  out.reserve(results.size());
  while (!results.empty()) {
    out.push_back(results.top());
    results.pop();
  }
  std::reverse(out.begin(), out.end());  // best first
  return out;
}

// Query-path beam search with the reference's bounded-queue discipline
// (impl/HNSW.cpp search_from_candidates + hnsw/MinimaxHeap.h): candidates
// live in an ef-capacity max-heap where pop_min marks a hole but leaves
// the distance in the array, every evaluated neighbor is pushed
// unconditionally (the heap evicts the worst), results go to a separate
// k-heap, and expansion stops only when ef tracked distances are already
// below the popped candidate. Explores more than the classic hnswlib
// termination at equal ef — measurably higher recall per efSearch.
struct MinimaxHeap {
  int cap, k = 0, nvalid = 0;
  std::vector<PairDI> a;  // max-heap by distance; id -1 marks a popped hole
  explicit MinimaxHeap(int c) : cap(c) { a.reserve(c); }
  void push(idx_t id, float d) {
    if (k == cap) {
      if (d >= a.front().first) return;
      std::pop_heap(a.begin(), a.end());
      if (a.back().second != -1) --nvalid;
      a.pop_back();
      --k;
    }
    a.emplace_back(d, id);
    std::push_heap(a.begin(), a.end());
    ++k;
    ++nvalid;
  }
  idx_t pop_min(float* dout) {
    int imin = -1;
    float dmin = INFINITY;
    for (int i = 0; i < k; ++i)
      if (a[i].second != -1 && a[i].first < dmin) {
        dmin = a[i].first;
        imin = i;
      }
    if (imin < 0) return -1;
    *dout = dmin;
    idx_t id = a[imin].second;
    a[imin].second = -1;  // hole: distance stays for count_below
    --nvalid;
    return id;
  }
  int count_below(float t) const {
    int c = 0;
    for (int i = 0; i < k; ++i) c += a[i].first < t;
    return c;
  }
};

std::vector<PairDI> search_level0_bounded(
    HNSW& h, const float* q, idx_t entry, float dentry, int k, int ef,
    std::vector<uint8_t>& visited, std::vector<idx_t>& visited_list,
    const float* qcs = nullptr) {
  const bool pano = qcs != nullptr && h.pano_levels > 0 && h.metric == 1;
  std::priority_queue<PairDI> results;  // k-heap (worst on top)
  MinimaxHeap cands(ef);
  results.emplace(dentry, entry);
  cands.push(entry, dentry);
  visited[entry] = 1;
  visited_list.push_back(entry);

  long long hops = 0;
  for (;;) {
    float d0;
    idx_t c = cands.pop_min(&d0);
    if (c < 0) break;
    if (cands.count_below(d0) >= ef) break;
    ++hops;
    idx_t* nb = h.neigh(c, 0);
    int nn = h.nb_per_level(0);
    for (int i = 0; i < nn; ++i) {
      idx_t v = nb[i];
      if (v < 0) break;
      if (visited[v]) continue;
      visited[v] = 1;
      visited_list.push_back(v);
      float dv;
      if (pano) {
        // prune against the k-th result (the result heap's threshold);
        // a pruned bound still enters the candidate heap — it only loses
        // its result-heap slot, mirroring the reference where Panorama
        // thresholds on the result handler
        float thresh =
            (idx_t)results.size() >= k ? results.top().first : INFINITY;
        dv = h.dist_pano(q, v, qcs, thresh);
      } else {
        dv = h.dist_id(q, v);
      }
      if ((idx_t)results.size() < k || dv < results.top().first) {
        results.emplace(dv, v);
        if ((idx_t)results.size() > k) results.pop();
      }
      cands.push(v, dv);
    }
  }
  g_nhops.fetch_add(hops, std::memory_order_relaxed);
  g_ndis.fetch_add((long long)visited_list.size(),
                   std::memory_order_relaxed);
  std::vector<PairDI> out;
  out.reserve(results.size());
  while (!results.empty()) {
    out.push_back(results.top());
    results.pop();
  }
  std::reverse(out.begin(), out.end());
  return out;
}

// neighbor selection: distance-domination shrink heuristic
void shrink_neighbors(HNSW& h, std::vector<PairDI>& cand, int max_size) {
  if ((int)cand.size() <= max_size) return;
  std::sort(cand.begin(), cand.end());
  std::vector<PairDI> kept;
  for (auto& [dc, c] : cand) {
    bool dominated = false;
    const float* vc = h.vecs.data() + (size_t)c * h.d;
    for (auto& [dk, kid] : kept) {
      const float* vk = h.vecs.data() + (size_t)kid * h.d;
      if (h.dist(vc, vk) < dc) {
        dominated = true;
        break;
      }
    }
    if (!dominated) {
      kept.emplace_back(dc, c);
      if ((int)kept.size() >= max_size) break;
    }
  }
  cand = std::move(kept);
}

void link_nodes(HNSW& h, idx_t node, int level, std::vector<PairDI> cand) {
  int maxn = h.nb_per_level(level);
  shrink_neighbors(h, cand, maxn);
  idx_t* nb = h.neigh(node, level);
  int i = 0;
  for (auto& [dc, c] : cand) nb[i++] = c;
  for (; i < maxn; ++i) nb[i] = -1;

  // backlinks
  for (auto& [dc, c] : cand) {
    idx_t* cnb = h.neigh(c, level);
    int j = 0;
    while (j < maxn && cnb[j] >= 0) ++j;
    if (j < maxn) {
      cnb[j] = node;
    } else {
      // rebuild c's neighbor list including node, then shrink
      std::vector<PairDI> cl;
      const float* vc = h.vecs.data() + (size_t)c * h.d;
      cl.reserve(maxn + 1);
      for (int t = 0; t < maxn; ++t)
        cl.emplace_back(h.dist(vc, h.vecs.data() + (size_t)cnb[t] * h.d),
                        cnb[t]);
      cl.emplace_back(dc, node);
      shrink_neighbors(h, cl, maxn);
      int t = 0;
      for (auto& [dd, v] : cl) cnb[t++] = v;
      for (; t < maxn; ++t) cnb[t] = -1;
    }
  }
}

void insert_node(HNSW& h, idx_t node, std::vector<uint8_t>& visited,
                 std::vector<idx_t>& vlist) {
  const float* q = h.vecs.data() + (size_t)node * h.d;
  int level = h.levels[node];

  if (h.entry_point < 0) {
    h.entry_point = node;
    h.max_level = level;
    return;
  }

  idx_t cur = h.entry_point;
  float dcur = h.dist_id(q, cur);
  for (int l = h.max_level; l > level; --l) cur = greedy_step(h, q, cur, l, dcur);

  for (int l = std::min(level, h.max_level); l >= 0; --l) {
    auto cand = search_level(h, q, cur, dcur, l, h.ef_construction, visited, vlist);
    for (idx_t v : vlist) visited[v] = 0;
    vlist.clear();
    link_nodes(h, node, l, cand);
    if (!cand.empty()) {
      cur = cand[0].second;
      dcur = cand[0].first;
    }
  }
  if (level > h.max_level) {
    h.max_level = level;
    h.entry_point = node;
  }
}

}  // namespace

extern "C" {

void* hnsw_new(int d, int M, int ef_construction, int metric, uint64_t seed) {
  auto* h = new HNSW();
  h->d = d;
  h->M = std::max(2, M);
  h->ef_construction = ef_construction;
  h->metric = metric;
  h->level_mult = 1.0 / std::log(double(h->M));
  h->rng.seed(seed);
  return h;
}

void hnsw_free(void* ptr) { delete static_cast<HNSW*>(ptr); }

int64_t hnsw_ntotal(void* ptr) { return static_cast<HNSW*>(ptr)->ntotal; }

// append n vectors and link them into the graph; returns the number of
// nodes actually linked (< n iff interrupted via hnsw_set_interrupt)
int64_t hnsw_add(void* ptr, const float* x, int64_t n) {
  auto& h = *static_cast<HNSW*>(ptr);
  idx_t base = h.ntotal;
  h.vecs.insert(h.vecs.end(), x, x + (size_t)n * h.d);
  h.levels.resize(base + n);
  h.neighbors.resize(base + n);
  for (idx_t i = 0; i < n; ++i) {
    int lv = h.random_level();
    h.levels[base + i] = lv;
    size_t tot = 0;
    for (int l = 0; l <= lv; ++l) tot += h.nb_per_level(l);
    h.neighbors[base + i].assign(tot, -1);
  }
  h.ntotal += n;
  h.pano_update_cum_sums(base);
  // Insertion order: bucket-sort the batch by level, HIGHEST level first,
  // with a random shuffle inside each bucket (reference
  // IndexHNSW.cpp:97-146 hnsw_add_vertices): hub nodes exist before the
  // level-0 mass links in, which measurably improves recall at equal
  // efConstruction vs arrival-order insertion.
  int max_lv = 0;
  for (idx_t i = 0; i < n; ++i) max_lv = std::max(max_lv, h.levels[base + i]);
  std::vector<idx_t> order;
  order.reserve(n);
  for (int lv = max_lv; lv >= 0; --lv) {
    size_t b0 = order.size();
    for (idx_t i = 0; i < n; ++i)
      if (h.levels[base + i] == lv) order.push_back(base + i);
    for (size_t j = b0; j + 1 < order.size(); ++j) {
      std::uniform_int_distribution<size_t> u(j, order.size() - 1);
      std::swap(order[j], order[u(h.rng)]);
    }
  }
  idx_t prev_entry = h.entry_point;
  int prev_max = h.max_level;
  std::vector<uint8_t> visited(h.ntotal, 0);
  std::vector<idx_t> vlist;
  for (idx_t i = 0; i < n; ++i) {
    if (g_stop.load(std::memory_order_relaxed)) {
      // linked nodes are scattered through the id range (level-ordered
      // insertion), so roll back the WHOLE batch: strip backlinks into
      // [base, base+n) from the pre-existing nodes and restore the entry
      // point. The caller sees 0 added and re-raises.
      for (idx_t v = 0; v < base; ++v) {
        for (int l = 0; l <= h.levels[v]; ++l) {
          idx_t* nb = h.neigh(v, l);
          int nn = h.nb_per_level(l), w = 0;
          for (int t = 0; t < nn && nb[t] >= 0; ++t)
            if (nb[t] < base) nb[w++] = nb[t];
          for (; w < nn; ++w) nb[w] = -1;
        }
      }
      h.ntotal = base;
      h.vecs.resize((size_t)base * h.d);
      h.levels.resize(base);
      h.neighbors.resize(base);
      h.entry_point = prev_entry;
      h.max_level = prev_max;
      h.pano_update_cum_sums(base);
      return 0;
    }
    insert_node(h, order[i], visited, vlist);
  }
  return n;
}

// Panorama progressive refinement (IndexHNSW.h:171): levels > 0 switches
// level-0 beam distances to block-progressive evaluation with
// Cauchy-Schwarz pruning against the beam threshold.
void hnsw_set_pano(void* ptr, int levels) {
  auto& h = *static_cast<HNSW*>(ptr);
  h.pano_levels = std::max(0, levels);
  h.pano_update_cum_sums(0);
}

// stats + cancellation C ABI (HNSWStats analogue)
void hnsw_stats_get(long long* out3) {
  out3[0] = g_n1.load();
  out3[1] = g_ndis.load();
  out3[2] = g_nhops.load();
}
void hnsw_stats_reset() { g_n1 = 0; g_ndis = 0; g_nhops = 0; }
void hnsw_set_interrupt(int v) { g_stop.store(v); }

void hnsw_search(void* ptr, const float* xq, int64_t nq, int64_t k,
                 int ef_search, float* D, int64_t* I) {
  auto& h = *static_cast<HNSW*>(ptr);
  g_n1.fetch_add(nq, std::memory_order_relaxed);
  int ef = std::max<int64_t>(ef_search, k);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<uint8_t> visited(h.ntotal, 0);
    std::vector<idx_t> vlist;
    std::vector<float> qcs(h.pano_levels ? h.pano_levels + 1 : 0);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t qi = 0; qi < nq; ++qi) {
      const float* q = xq + (size_t)qi * h.d;
      float* Dq = D + qi * k;
      int64_t* Iq = I + qi * k;
      for (int64_t j = 0; j < k; ++j) {
        Dq[j] = h.metric == 1 ? INFINITY : -INFINITY;
        Iq[j] = -1;
      }
      if (h.entry_point < 0) continue;
      idx_t cur = h.entry_point;
      float dcur = h.dist_id(q, cur);
      for (int l = h.max_level; l > 0; --l)
        cur = greedy_step(h, q, cur, l, dcur);
      const float* qcs_p = nullptr;
      if (h.pano_levels && h.metric == 1) {
        h.pano_suffix_norms(q, qcs.data());
        qcs_p = qcs.data();
      }
      auto res = search_level0_bounded(h, q, cur, dcur, (int)k, ef, visited,
                                       vlist, qcs_p);
      for (idx_t v : vlist) visited[v] = 0;
      vlist.clear();
      int64_t m = std::min<int64_t>(k, res.size());
      for (int64_t j = 0; j < m; ++j) {
        Dq[j] = h.metric == 1 ? res[j].first : -res[j].first;
        Iq[j] = res[j].second;
      }
    }
  }
}

// --- serialization support: export/import the raw graph ---------------------

int hnsw_max_level(void* ptr) { return static_cast<HNSW*>(ptr)->max_level; }
int64_t hnsw_entry_point(void* ptr) {
  return static_cast<HNSW*>(ptr)->entry_point;
}

void hnsw_get_levels(void* ptr, int* out) {
  auto& h = *static_cast<HNSW*>(ptr);
  std::copy(h.levels.begin(), h.levels.end(), out);
}

int64_t hnsw_neighbor_bytes(void* ptr) {
  auto& h = *static_cast<HNSW*>(ptr);
  int64_t tot = 0;
  for (auto& v : h.neighbors) tot += v.size();
  return tot * (int64_t)sizeof(idx_t);
}

void hnsw_get_neighbors(void* ptr, idx_t* out) {
  auto& h = *static_cast<HNSW*>(ptr);
  for (auto& v : h.neighbors) {
    std::copy(v.begin(), v.end(), out);
    out += v.size();
  }
}

void hnsw_get_vecs(void* ptr, float* out) {
  auto& h = *static_cast<HNSW*>(ptr);
  std::copy(h.vecs.begin(), h.vecs.end(), out);
}

void hnsw_import(void* ptr, const float* vecs, int64_t n, const int* levels,
                 const idx_t* neighbors, int64_t entry_point, int max_level) {
  auto& h = *static_cast<HNSW*>(ptr);
  h.ntotal = n;
  h.vecs.assign(vecs, vecs + (size_t)n * h.d);
  h.levels.assign(levels, levels + n);
  h.neighbors.resize(n);
  const idx_t* p = neighbors;
  for (idx_t i = 0; i < n; ++i) {
    size_t tot = 0;
    for (int l = 0; l <= h.levels[i]; ++l) tot += h.nb_per_level(l);
    h.neighbors[i].assign(p, p + tot);
    p += tot;
  }
  h.entry_point = entry_point;
  h.max_level = max_level;
  h.pano_update_cum_sums(0);
}

}  // extern "C"
