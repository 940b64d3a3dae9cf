// Native host-side graph kernels for sphericalsfm_tpu.
//
// The framework keeps its compute path in XLA; the runtime
// bookkeeping around it (track building, view-graph components) is
// pointer-chasing work the reference does with std::map/Boost.Graph
// (examples/spherical_sfm_tools.cpp:736-792, 886-950). Here it is a small
// C++ kernel exposed over a C ABI and loaded via ctypes — no Python-object
// overhead on multi-million-edge match graphs.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC graph.cpp -o libsfmgraph.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int32_t> rank_;

  explicit UnionFind(int64_t n) : parent(n), rank_(n, 0) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (rank_[ra] < rank_[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    if (rank_[ra] == rank_[rb]) ++rank_[ra];
  }
};

}  // namespace

extern "C" {

// Union the given edges over universe [0, n); write the root of every node.
void sfm_union_find(int64_t n, int64_t num_edges, const int64_t* a,
                    const int64_t* b, int64_t* roots_out) {
  UnionFind uf(n);
  for (int64_t e = 0; e < num_edges; ++e) uf.unite(a[e], b[e]);
  for (int64_t i = 0; i < n; ++i) roots_out[i] = uf.find(i);
}

// Connected components: label nodes by component id (0..k-1, by first
// appearance); returns the number of components.
int64_t sfm_connected_components(int64_t n, int64_t num_edges,
                                 const int64_t* a, const int64_t* b,
                                 int64_t* labels_out) {
  UnionFind uf(n);
  for (int64_t e = 0; e < num_edges; ++e) uf.unite(a[e], b[e]);
  std::vector<int64_t> label(n, -1);
  int64_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = uf.find(i);
    if (label[r] < 0) label[r] = next++;
    labels_out[i] = label[r];
  }
  return next;
}

// Triplet rotation cycle-consistency filter (reference
// filter_image_matches, examples/spherical_sfm_tools.cpp:1031-1082):
// an edge in at least one triplet survives only if some triplet containing
// it has cycle error ||log(R_bc R_ab R_ac^T)|| < thresh. R: (E, 9)
// row-major rotation matrices for edges oriented i < j. keep_io: uint8
// in/out mask.
void sfm_triplet_filter(int64_t num_frames, int64_t num_edges,
                        const int64_t* ei, const int64_t* ej, const double* R,
                        double thresh, uint8_t* keep_io) {
  std::unordered_map<int64_t, int64_t> idx;
  idx.reserve(static_cast<size_t>(num_edges) * 2);
  std::vector<std::vector<int64_t>> nbr(num_frames);
  for (int64_t e = 0; e < num_edges; ++e) {
    if (!keep_io[e]) continue;
    idx[ei[e] * num_frames + ej[e]] = e;
    nbr[ei[e]].push_back(ej[e]);
    nbr[ej[e]].push_back(ei[e]);
  }
  for (auto& v : nbr) std::sort(v.begin(), v.end());

  std::vector<uint8_t> in_tri(num_edges, 0), cons(num_edges, 0);
  auto cycle_angle = [&](int64_t p_ab, int64_t p_bc, int64_t p_ac) {
    const double* A = R + 9 * p_bc;   // R_bc
    const double* B = R + 9 * p_ab;   // R_ab
    const double* C = R + 9 * p_ac;   // R_ac
    double M[9];  // M = A * B
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        M[3 * r + c] = A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c] +
                       A[3 * r + 2] * B[6 + c];
    // trace(M * C^T) = sum_{rc} M[rc] * C[rc]
    double tr = 0;
    for (int k = 0; k < 9; ++k) tr += M[k] * C[k];
    double ca = (tr - 1.0) / 2.0;
    ca = std::max(-1.0, std::min(1.0, ca));
    return std::acos(ca);
  };

  for (int64_t e = 0; e < num_edges; ++e) {
    if (!keep_io[e]) continue;
    int64_t i = ei[e], j = ej[e];
    const auto& ni = nbr[i];
    const auto& nj = nbr[j];
    size_t pi = 0, pj = 0;
    while (pi < ni.size() && pj < nj.size()) {
      if (ni[pi] < nj[pj]) {
        ++pi;
      } else if (ni[pi] > nj[pj]) {
        ++pj;
      } else {
        int64_t k = ni[pi];
        ++pi;
        ++pj;
        if (k == i || k == j) continue;
        int64_t a = i, b = j, c = k;
        if (a > b) std::swap(a, b);
        if (b > c) std::swap(b, c);
        if (a > b) std::swap(a, b);
        auto f_ab = idx.find(a * num_frames + b);
        auto f_bc = idx.find(b * num_frames + c);
        auto f_ac = idx.find(a * num_frames + c);
        if (f_ab == idx.end() || f_bc == idx.end() || f_ac == idx.end())
          continue;
        double err = cycle_angle(f_ab->second, f_bc->second, f_ac->second);
        for (int64_t p : {f_ab->second, f_bc->second, f_ac->second}) {
          in_tri[p] = 1;
          if (err < thresh) cons[p] = 1;
        }
      }
    }
  }
  for (int64_t e = 0; e < num_edges; ++e) {
    if (keep_io[e] && in_tri[e] && !cons[e]) keep_io[e] = 0;
  }
}

}  // extern "C"
