// graphax_torch native host code: the community partitioner behind the
// windowed layout's node order.
//
// A copy of `gx_partition_grow` from graphax/native/graphbuild.cpp:218-284,
// kept bit-for-bit: the labels decide the node order, the node order decides
// which edges fall in-window, and that decides the numerics of the windowed
// SpMM. Plain C ABI for ctypes; all index arrays are int64, the caller owns
// every buffer.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

// Balanced greedy region-growing partitioner (GGGP-style "graph growing").
// Grows part 0..p-1 sequentially: each step admits the unassigned node with
// the most neighbors already inside the growing part (lazy max-heap with
// (gain desc, node id asc) order, deterministic), capping each part at
// `cap` nodes; disconnected remainders seed from the lowest unassigned id.
// With p*cap >= n every node gets a label. Returns the directed edge cut.
int64_t gx_partition_grow(const int64_t* row, const int64_t* col, int64_t e,
                          int64_t n, int64_t p, int64_t cap,
                          int64_t* out_label) {
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < e; ++i) {
    deg[row[i]]++;
    deg[col[i]]++;
  }
  std::vector<int64_t> ptr(n + 1, 0);
  for (int64_t v = 0; v < n; ++v) ptr[v + 1] = ptr[v] + deg[v];
  std::vector<int64_t> adj(2 * e);
  std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    adj[cur[row[i]]++] = col[i];
    adj[cur[col[i]]++] = row[i];
  }
  std::fill(out_label, out_label + n, int64_t(-1));
  std::vector<int64_t> gain(n, 0);
  // lazy max-heap of (gain, node): top = highest gain, ties -> lowest id
  typedef std::pair<int64_t, int64_t> Entry;  // (gain, node)
  auto cmp = [](const Entry& a, const Entry& b) {
    if (a.first != b.first) return a.first < b.first;
    return a.second > b.second;
  };
  int64_t next_scan = 0;
  for (int64_t s = 0; s < p; ++s) {
    std::fill(gain.begin(), gain.end(), int64_t(0));
    std::vector<Entry> heap;
    auto admit = [&](int64_t v) {
      out_label[v] = s;
      for (int64_t k = ptr[v]; k < ptr[v + 1]; ++k) {
        int64_t u = adj[k];
        if (out_label[u] == -1) {
          gain[u]++;
          heap.push_back(Entry(gain[u], u));
          std::push_heap(heap.begin(), heap.end(), cmp);
        }
      }
    };
    int64_t count = 0;
    while (count < cap) {
      int64_t pick = -1;
      while (!heap.empty()) {
        Entry top = heap.front();
        std::pop_heap(heap.begin(), heap.end(), cmp);
        heap.pop_back();
        if (out_label[top.second] == -1 && gain[top.second] == top.first) {
          pick = top.second;
          break;
        }
      }
      if (pick == -1) {
        while (next_scan < n && out_label[next_scan] != -1) ++next_scan;
        if (next_scan == n) break;
        pick = next_scan;
      }
      admit(pick);
      ++count;
    }
  }
  int64_t cut = 0;
  for (int64_t i = 0; i < e; ++i)
    if (out_label[row[i]] != out_label[col[i]]) ++cut;
  return cut;
}

}  // extern "C"
