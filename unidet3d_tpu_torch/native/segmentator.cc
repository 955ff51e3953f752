// Felzenszwalb-Huttenlocher mesh segmentation ("segmentator").
//
// The port's own copy of the JAX package's native/segmentator.cc, the
// counterpart of the reference's external `segmentator` dependency (used
// offline, e.g. data/scannet/batch_load_scannet_data.py, to produce
// superpoints from scene meshes). Graph-based segmentation over mesh edges
// with normal-difference weights, convex edges down-weighted, followed by a
// small-segment merge pass: the standard ScanNet-style formulation.
//
// Built by native/segmentator.py:
//   g++ -O3 -shared -fPIC -std=c++17 segmentator.cc -o libunidet3d_segmentator.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <unordered_set>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent, rank_, size_;
  std::vector<float> thr;
  explicit UnionFind(int32_t n, float k)
      : parent(n), rank_(n, 0), size_(n, 1), thr(n, k) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  int32_t join(int32_t a, int32_t b) {
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size_[a] += size_[b];
    if (rank_[a] == rank_[b]) ++rank_[a];
    return a;
  }
};

struct Edge {
  int32_t a, b;
  float w;
};

}  // namespace

extern "C" {

// vertices: (n_verts, 3) float32; faces: (n_faces, 3) int32.
// out_segments: (n_verts,) int32 — compacted segment ids.
// Returns the number of segments.
int32_t unidet3d_segment_mesh(const float* vertices, int64_t n_verts,
                              const int32_t* faces, int64_t n_faces,
                              float kthr, int32_t seg_min_verts,
                              int32_t* out_segments) {
  // Vertex normals from area-weighted face normals.
  std::vector<float> normals(n_verts * 3, 0.f);
  for (int64_t f = 0; f < n_faces; ++f) {
    int32_t i = faces[f * 3], j = faces[f * 3 + 1], k = faces[f * 3 + 2];
    const float* p0 = vertices + i * 3;
    const float* p1 = vertices + j * 3;
    const float* p2 = vertices + k * 3;
    float u[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    float v[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    float nx = u[1] * v[2] - u[2] * v[1];
    float ny = u[2] * v[0] - u[0] * v[2];
    float nz = u[0] * v[1] - u[1] * v[0];
    for (int32_t vid : {i, j, k}) {
      normals[vid * 3] += nx;
      normals[vid * 3 + 1] += ny;
      normals[vid * 3 + 2] += nz;
    }
  }
  for (int64_t v = 0; v < n_verts; ++v) {
    float* n = normals.data() + v * 3;
    float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 1e-12f) {
      n[0] /= len;
      n[1] /= len;
      n[2] /= len;
    }
  }

  // Unique undirected edges with FH weights.
  std::vector<Edge> edges;
  edges.reserve(n_faces * 3);
  {
    std::unordered_set<int64_t> seen;
    seen.reserve(n_faces * 3 * 2);
    auto add_edge = [&](int32_t a, int32_t b) {
      if (a > b) std::swap(a, b);
      int64_t key = (static_cast<int64_t>(a) << 32) | b;
      if (!seen.insert(key).second) return;
      const float* na = normals.data() + a * 3;
      const float* nb = normals.data() + b * 3;
      float dot =
          na[0] * nb[0] + na[1] * nb[1] + na[2] * nb[2];
      float w = 1.0f - dot;
      // Convex edges (normal agrees with the step direction) are easier to
      // merge: square the (small) weight.
      const float* pa = vertices + a * 3;
      const float* pb = vertices + b * 3;
      float d[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
      float len = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      if (len > 1e-12f && (na[0] * d[0] + na[1] * d[1] + na[2] * d[2]) / len >
                              0.0f)
        w = w * w;
      edges.push_back({a, b, w});
    };
    for (int64_t f = 0; f < n_faces; ++f) {
      add_edge(faces[f * 3], faces[f * 3 + 1]);
      add_edge(faces[f * 3 + 1], faces[f * 3 + 2]);
      add_edge(faces[f * 3], faces[f * 3 + 2]);
    }
  }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& x, const Edge& y) { return x.w < y.w; });

  UnionFind uf(static_cast<int32_t>(n_verts), kthr);
  for (const Edge& e : edges) {
    int32_t a = uf.find(e.a), b = uf.find(e.b);
    if (a == b) continue;
    if (e.w <= uf.thr[a] && e.w <= uf.thr[b]) {
      int32_t r = uf.join(a, b);
      uf.thr[r] = e.w + kthr / uf.size_[r];
    }
  }
  // Merge small segments.
  for (const Edge& e : edges) {
    int32_t a = uf.find(e.a), b = uf.find(e.b);
    if (a == b) continue;
    if (uf.size_[a] < seg_min_verts || uf.size_[b] < seg_min_verts)
      uf.join(a, b);
  }

  // Compact ids.
  std::vector<int32_t> remap(n_verts, -1);
  int32_t next = 0;
  for (int64_t v = 0; v < n_verts; ++v) {
    int32_t r = uf.find(static_cast<int32_t>(v));
    if (remap[r] < 0) remap[r] = next++;
    out_segments[v] = remap[r];
  }
  return next;
}

}  // extern "C"
