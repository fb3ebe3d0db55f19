// NSG graph build + search: the host component of faiss_tpu_torch's NSG and
// NN-descent indexes (models/nsg.py), a copy of faiss_tpu's native/nsg.cpp
// with one change: the NN-descent is deterministic (see nndescent below).
// The MRNG prune, the reverse-link pass, the connectivity pass and the search
// are that file's, unchanged.
//
// Role: the reference implements NSG and its NN-descent bootstrap in C++
// (faiss/impl/NSG.{h,cpp}, faiss/impl/NNDescent.{h,cpp}) because both are
// sequential, pointer-chasing graph algorithms. This is an independent
// implementation of NN-Descent (Dong et al., WWW'11) and NSG (Fu et al.,
// VLDB'19): build an approximate kNN graph by iterative local joins, then
// prune it with the MRNG edge-selection rule navigated from the medoid, and
// add a spanning pass for connectivity. C ABI for ctypes.
//
// Build (faiss_tpu_torch/host_build.py, at first use, into _build/):
//   g++ -O3 -march=native -shared -fPIC -fopenmp nsg.cpp -o libnsg.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

std::atomic<long long> g_ndis{0};  // search-pool distance evals
std::atomic<int> g_stop{0};

using idx_t = int64_t;

struct NSG {
  int d = 0;
  int R = 32;  // max out-degree
  idx_t ntotal = 0;
  idx_t enterpoint = -1;
  std::vector<float> vecs;
  std::vector<idx_t> graph;  // [ntotal, R], -1 padded

  float dist(const float* a, const float* b) const {
    float s = 0;
    for (int i = 0; i < d; ++i) {
      float t = a[i] - b[i];
      s += t * t;
    }
    return s;
  }
  const float* vec(idx_t i) const { return vecs.data() + (size_t)i * d; }
};

using PairDI = std::pair<float, idx_t>;

// ---------------- NN-descent approximate kNN graph --------------------------

void nndescent(const NSG& g, int K, int iters,
               std::vector<std::vector<PairDI>>& knn) {
  idx_t n = g.ntotal;
  std::mt19937_64 rng(1234);
  knn.assign(n, {});
  {
    std::uniform_int_distribution<idx_t> u(0, n - 1);
    for (idx_t i = 0; i < n; ++i) {
      for (int j = 0; j < K; ++j) {
        idx_t cand = u(rng);
        if (cand == i) cand = (cand + 1) % n;
        knn[i].emplace_back(g.dist(g.vec(i), g.vec(cand)), cand);
      }
      std::sort(knn[i].begin(), knn[i].end());
    }
  }

  auto try_insert = [&](std::vector<PairDI>& lst, float dv, idx_t v, idx_t self) {
    if (v == self) return false;
    if ((int)lst.size() >= K && dv >= lst.back().first) return false;
    for (auto& [dd, u] : lst)
      if (u == v) return false;
    lst.emplace_back(dv, v);
    std::sort(lst.begin(), lst.end());
    if ((int)lst.size() > K) lst.pop_back();
    return true;
  };

  // Each iteration joins against a snapshot of the previous iteration's
  // lists, so no thread reads a list that another is writing. faiss_tpu's
  // copy pushes each pair (u, v) of knn[i] into knn[u] and knn[v] under a
  // critical section while other threads copy knn[i] outside it: a data
  // race whose graph depends on the thread schedule. Here every node pulls
  // instead: the nodes i whose snapshot list holds u (rev[u], in increasing
  // i), and for each the other members v of snap[i] in list order: the
  // order in which a serial push over i = 0..n-1 against the snapshot would
  // offer them to u. Each node's new list is written by one thread only, so
  // the graph does not depend on the number of threads.
  std::vector<std::vector<PairDI>> snap;
  std::vector<idx_t> rev_off(n + 1), rev;
  for (int it = 0; it < iters; ++it) {
    snap = knn;
    // rev[rev_off[u] .. rev_off[u + 1]): the i with u in snap[i], once each
    std::fill(rev_off.begin(), rev_off.end(), 0);
    for (idx_t i = 0; i < n; ++i)
      for (size_t a = 0; a < snap[i].size(); ++a) {
        idx_t u = snap[i][a].second;
        bool first = true;
        for (size_t b = 0; b < a; ++b) first &= snap[i][b].second != u;
        if (first) ++rev_off[u + 1];
      }
    for (idx_t u = 0; u < n; ++u) rev_off[u + 1] += rev_off[u];
    rev.resize(rev_off[n]);
    {
      std::vector<idx_t> fill(rev_off.begin(), rev_off.end() - 1);
      for (idx_t i = 0; i < n; ++i)
        for (size_t a = 0; a < snap[i].size(); ++a) {
          idx_t u = snap[i][a].second;
          bool first = true;
          for (size_t b = 0; b < a; ++b) first &= snap[i][b].second != u;
          if (first) rev[fill[u]++] = i;
        }
    }
    // A node v offered to u a second time is refused again whatever came in
    // between (it is in the list, or its distance is >= the list's last,
    // which only falls), and so is a member of u's list: ``seen`` skips
    // both without computing the distance. The lists are those of offering
    // every candidate.
    int64_t updates = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : updates)
#endif
    {
      std::vector<idx_t> seen(n, -1);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
      for (idx_t u = 0; u < n; ++u) {
        auto& lst = knn[u];
        seen[u] = u;
        for (const auto& [dd, v] : lst) seen[v] = u;
        for (idx_t r = rev_off[u]; r < rev_off[u + 1]; ++r) {
          for (const auto& [dd, v] : snap[rev[r]]) {
            if (seen[v] == u) continue;
            seen[v] = u;
            updates += try_insert(lst, g.dist(g.vec(u), g.vec(v)), v, u);
          }
        }
      }
    }
    if (updates == 0) break;
  }
}

// greedy beam search over an arbitrary graph (stride ``deg``); defaults
// used at search time run over the pruned g.graph (deg = g.R), the prune
// phase passes the FULL-degree knn graph (reference NSG::link searches on
// knn_graph, not the truncated provisional graph — NSG.cpp:363).
std::vector<PairDI> search_pool(const NSG& g, const float* q, idx_t entry,
                                int L, std::vector<uint8_t>& visited,
                                std::vector<idx_t>& vlist,
                                const idx_t* graph = nullptr, int deg = 0) {
  if (!graph) {
    graph = g.graph.data();
    deg = g.R;
  }
  std::priority_queue<PairDI> results;
  std::priority_queue<PairDI, std::vector<PairDI>, std::greater<PairDI>> cands;
  float d0 = g.dist(q, g.vec(entry));
  results.emplace(d0, entry);
  cands.emplace(d0, entry);
  visited[entry] = 1;
  vlist.push_back(entry);
  while (!cands.empty()) {
    auto [dc, c] = cands.top();
    if ((idx_t)results.size() >= L && dc > results.top().first) break;
    cands.pop();
    const idx_t* nb = graph + (size_t)c * deg;
    for (int i = 0; i < deg; ++i) {
      idx_t v = nb[i];
      if (v < 0) break;
      if (visited[v]) continue;
      visited[v] = 1;
      vlist.push_back(v);
      float dv = g.dist(q, g.vec(v));
      if ((idx_t)results.size() < L || dv < results.top().first) {
        results.emplace(dv, v);
        cands.emplace(dv, v);
        if ((idx_t)results.size() > L) results.pop();
      }
    }
  }
  std::vector<PairDI> out;
  while (!results.empty()) {
    out.push_back(results.top());
    results.pop();
  }
  std::reverse(out.begin(), out.end());
  return out;
}

}  // namespace

extern "C" {

void* nsg_new(int d, int R) {
  auto* g = new NSG();
  g->d = d;
  g->R = std::max(4, R);
  return g;
}

void nsg_free(void* p) { delete static_cast<NSG*>(p); }
int64_t nsg_ntotal(void* p) { return static_cast<NSG*>(p)->ntotal; }
int64_t nsg_enterpoint(void* p) { return static_cast<NSG*>(p)->enterpoint; }

// full build: NN-descent kNN graph (degree K) then MRNG pruning to degree R
// returns 0, or -1 if interrupted (graph left unusable; caller must reset)
int nsg_build(void* p, const float* x, int64_t n, int K, int nnd_iters,
              int L_build) {
  auto& g = *static_cast<NSG*>(p);
  g.ntotal = n;
  g.vecs.assign(x, x + (size_t)n * g.d);

  std::vector<std::vector<PairDI>> knn;
  nndescent(g, K, nnd_iters, knn);

  // medoid = point closest to the mean
  std::vector<double> mean(g.d, 0.0);
  for (idx_t i = 0; i < n; ++i)
    for (int j = 0; j < g.d; ++j) mean[j] += g.vec(i)[j];
  std::vector<float> meanf(g.d);
  for (int j = 0; j < g.d; ++j) meanf[j] = (float)(mean[j] / n);
  idx_t medoid = 0;
  float best = INFINITY;
  for (idx_t i = 0; i < n; ++i) {
    float dv = g.dist(meanf.data(), g.vec(i));
    if (dv < best) {
      best = dv;
      medoid = i;
    }
  }
  g.enterpoint = medoid;

  // FULL-degree knn graph for prune-time candidate search (the reference
  // searches knn_graph, degree GK, not an R-truncated graph — NSG.cpp:363)
  std::vector<idx_t> knng((size_t)n * K, -1);
  for (idx_t i = 0; i < n; ++i) {
    int m = std::min<int>(K, knn[i].size());
    for (int j = 0; j < m; ++j) knng[(size_t)i * K + j] = knn[i][j].second;
  }

  // MRNG-style prune: candidates = knn ∪ search pool from medoid
  std::vector<std::vector<idx_t>> pruned(n);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<uint8_t> visited(n, 0);
    std::vector<idx_t> vlist;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (idx_t i = 0; i < n; ++i) {
      if (g_stop.load(std::memory_order_relaxed)) continue;  // drain fast
      auto pool = search_pool(g, g.vec(i), medoid, L_build, visited, vlist,
                              knng.data(), K);
      g_ndis.fetch_add((long long)vlist.size(), std::memory_order_relaxed);
      for (idx_t v : vlist) visited[v] = 0;
      vlist.clear();
      for (auto& [dv, v] : knn[i]) pool.emplace_back(dv, v);
      std::sort(pool.begin(), pool.end());
      std::vector<idx_t> keep;
      for (auto& [dv, v] : pool) {
        if (v == i) continue;
        bool dominated = false;
        for (idx_t u : keep) {
          if (g.dist(g.vec(u), g.vec(v)) < dv) {
            dominated = true;
            break;
          }
        }
        if (!dominated) {
          bool dup = false;
          for (idx_t u : keep) dup |= (u == v);
          if (!dup) keep.push_back(v);
          if ((int)keep.size() >= g.R) break;
        }
      }
      pruned[i] = std::move(keep);
    }
  }

  g.graph.assign((size_t)n * g.R, -1);
  for (idx_t i = 0; i < n; ++i)
    for (size_t j = 0; j < pruned[i].size(); ++j)
      g.graph[(size_t)i * g.R + j] = pruned[i][j];

  // reverse-link pass (reference NSG::add_reverse_links, NSG.cpp:455):
  // every pruned edge i->v also proposes v->i; an overfull destination
  // re-prunes its list with the same occlusion rule. Without this pass
  // the digraph has poor navigability (measured inter@10 0.05 vs the
  // reference's 0.33 on the golden set).
  for (idx_t i = 0; i < n; ++i) {
    const idx_t* nbi = g.graph.data() + (size_t)i * g.R;
    for (int s = 0; s < g.R && nbi[s] >= 0; ++s) {
      idx_t des = nbi[s];
      idx_t* nbd = g.graph.data() + (size_t)des * g.R;
      bool dup = false;
      int used = 0;
      for (; used < g.R && nbd[used] >= 0; ++used) dup |= (nbd[used] == i);
      if (dup) continue;
      float d_qi = g.dist(g.vec(des), g.vec(i));
      if (used < g.R) {
        nbd[used] = i;
        continue;
      }
      // overfull: occlusion-prune {existing ∪ i} back down to R
      std::vector<PairDI> tmp;
      tmp.reserve(used + 1);
      for (int j = 0; j < used; ++j)
        tmp.emplace_back(g.dist(g.vec(des), g.vec(nbd[j])), nbd[j]);
      tmp.emplace_back(d_qi, i);
      std::sort(tmp.begin(), tmp.end());
      std::vector<idx_t> result{tmp[0].second};
      for (size_t t = 1; t < tmp.size() && (int)result.size() < g.R; ++t) {
        bool occlude = false;
        for (idx_t u : result) {
          if (u == tmp[t].second ||
              g.dist(g.vec(u), g.vec(tmp[t].second)) < tmp[t].first) {
            occlude = true;
            break;
          }
        }
        if (!occlude) result.push_back(tmp[t].second);
      }
      for (int j = 0; j < g.R; ++j)
        nbd[j] = j < (int)result.size() ? result[j] : -1;
    }
  }

  // connectivity pass: BFS from medoid, attach unreachable nodes to their
  // nearest reachable neighbor (the reference's tree-spanning step)
  std::vector<uint8_t> reach(n, 0);
  std::vector<idx_t> stack{medoid};
  reach[medoid] = 1;
  while (!stack.empty()) {
    idx_t c = stack.back();
    stack.pop_back();
    const idx_t* nb = g.graph.data() + (size_t)c * g.R;
    for (int i = 0; i < g.R && nb[i] >= 0; ++i)
      if (!reach[nb[i]]) {
        reach[nb[i]] = 1;
        stack.push_back(nb[i]);
      }
  }
  if (g_stop.load()) return -1;
  for (idx_t i = 0; i < n; ++i) {
    if (reach[i]) continue;
    // link from its nearest knn neighbor that is reachable (or medoid)
    idx_t host = medoid;
    for (auto& [dv, v] : knn[i])
      if (reach[v]) {
        host = v;
        break;
      }
    idx_t* nb = g.graph.data() + (size_t)host * g.R;
    int slot = g.R - 1;
    for (int j = 0; j < g.R; ++j)
      if (nb[j] < 0) {
        slot = j;
        break;
      }
    nb[slot] = i;
    reach[i] = 1;
  }
  return 0;
}

void nsg_stats_get(long long* out1) { out1[0] = g_ndis.load(); }
void nsg_stats_reset() { g_ndis = 0; }
void nsg_set_interrupt(int v) { g_stop.store(v); }

void nsg_search(void* p, const float* xq, int64_t nq, int64_t k, int L,
                float* D, int64_t* I) {
  auto& g = *static_cast<NSG*>(p);
  int LL = std::max<int64_t>(L, k);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<uint8_t> visited(g.ntotal, 0);
    std::vector<idx_t> vlist;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t qi = 0; qi < nq; ++qi) {
      const float* q = xq + (size_t)qi * g.d;
      auto res = search_pool(g, q, g.enterpoint, LL, visited, vlist);
      for (idx_t v : vlist) visited[v] = 0;
      vlist.clear();
      for (int64_t j = 0; j < k; ++j) {
        if (j < (int64_t)res.size()) {
          D[qi * k + j] = res[j].first;
          I[qi * k + j] = res[j].second;
        } else {
          D[qi * k + j] = INFINITY;
          I[qi * k + j] = -1;
        }
      }
    }
  }
}

// serialization support
void nsg_get_graph(void* p, idx_t* out) {
  auto& g = *static_cast<NSG*>(p);
  std::copy(g.graph.begin(), g.graph.end(), out);
}
void nsg_get_vecs(void* p, float* out) {
  auto& g = *static_cast<NSG*>(p);
  std::copy(g.vecs.begin(), g.vecs.end(), out);
}
void nsg_import(void* p, const float* vecs, int64_t n, const idx_t* graph,
                int64_t enterpoint) {
  auto& g = *static_cast<NSG*>(p);
  g.ntotal = n;
  g.vecs.assign(vecs, vecs + (size_t)n * g.d);
  g.graph.assign(graph, graph + (size_t)n * g.R);
  g.enterpoint = enterpoint;
}

}  // extern "C"
