// Native SAH BVH (BLAS) + TLAS builders — the host-side hot path.
//
// The port's copy of voidin_tpu/native/bvh_builder.cpp, unchanged in what
// it computes: the same sources under the same compiler flags give the
// JAX package's nodes bit for bit. Same output contract as the numpy
// builders in voidin_tpu_torch/rt/bvh.py and byte-compatible with the
// reference renderer's node layouts (crates/bvh/src/blas.rs:10-17,
// tlas.rs:8-14):
//   BLAS node (32 B): { float min[3]; uint32 left_first; float max[3];
//                       uint32 count; }  leaf iff count > 0, children
//                       adjacent at (left_first, left_first + 1), node 1
//                       left empty (root = 0, first pair starts at 2).
//   TLAS node (32 B): { float min[3]; uint32 left_right (lo16 | hi16<<16);
//                       float max[3]; uint32 instance; } leaf iff
//                       left_right == 0, root at slot 0.
//
// The builder itself is a depth-first binned SAH (8 bins, leaf <= 3 tris)
// — an O(n log n) design instead of the reference's re-partition-per-
// candidate O(n * bins * levels) loop. Exposed as a plain C ABI for ctypes.
//
// Built at first use by voidin_tpu_torch/native/__init__.py:
//   c++ -O3 -shared -fPIC -std=c++17 bvh_builder.cpp texture_packer.cpp \
//       -o libvoidin_native_<hash>.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>
#include <cmath>

namespace {

struct Vec3 {
  float x, y, z;
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 mn{1e30f, 1e30f, 1e30f};
  Vec3 mx{-1e30f, -1e30f, -1e30f};
  void grow(const Vec3& p) { mn = vmin(mn, p); mx = vmax(mx, p); }
  void grow(const Aabb& b) { mn = vmin(mn, b.mn); mx = vmax(mx, b.mx); }
  float area() const {
    Vec3 d = mx - mn;
    if (d.x < 0 || d.y < 0 || d.z < 0) return 0.f;
    return 2.f * (d.x * d.y + d.x * d.z + d.y * d.z);
  }
};

struct Node {
  float mn[3];
  uint32_t left_first;
  float mx[3];
  uint32_t count;
};

constexpr int kBins = 8;
constexpr uint32_t kLeafSize = 3;

struct Builder {
  const Vec3* verts;
  std::vector<uint32_t> tri_order;  // permutation of triangle ids
  std::vector<Aabb> tri_box;
  std::vector<Vec3> centroid;
  std::vector<Node> nodes;
  uint32_t nodes_used = 2;  // slot 1 left empty (reference parity)

  void set_bounds(uint32_t ni, uint32_t start, uint32_t count) {
    Aabb b;
    for (uint32_t i = start; i < start + count; ++i) b.grow(tri_box[tri_order[i]]);
    std::memcpy(nodes[ni].mn, &b.mn, 12);
    std::memcpy(nodes[ni].mx, &b.mx, 12);
  }

  void subdivide(uint32_t ni, uint32_t start, uint32_t count, int depth) {
    if (count <= kLeafSize || depth > 60) {
      nodes[ni].left_first = start;
      nodes[ni].count = count;
      return;
    }
    // centroid bounds
    Aabb cb;
    for (uint32_t i = start; i < start + count; ++i) cb.grow(centroid[tri_order[i]]);
    Vec3 ext = cb.mx - cb.mn;
    // binned SAH over 3 axes
    float best_cost = 1e30f;
    int best_axis = -1, best_split = -1;
    for (int axis = 0; axis < 3; ++axis) {
      float e = ext[axis];
      if (e <= 0.f) continue;
      float scale = kBins / e;
      Aabb bbox[kBins];
      uint32_t bcount[kBins] = {0};
      for (uint32_t i = start; i < start + count; ++i) {
        uint32_t t = tri_order[i];
        int b = std::min(kBins - 1,
                         (int)((centroid[t][axis] - cb.mn[axis]) * scale));
        bbox[b].grow(tri_box[t]);
        ++bcount[b];
      }
      // prefix/suffix sweeps
      float larea[kBins], rarea[kBins];
      uint32_t lcnt[kBins], rcnt[kBins];
      Aabb acc;
      uint32_t c = 0;
      for (int b = 0; b < kBins; ++b) {
        acc.grow(bbox[b]); c += bcount[b];
        larea[b] = acc.area(); lcnt[b] = c;
      }
      acc = Aabb(); c = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        acc.grow(bbox[b]); c += bcount[b];
        rarea[b] = acc.area(); rcnt[b] = c;
      }
      for (int b = 0; b < kBins - 1; ++b) {
        if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
        float cost = larea[b] * lcnt[b] + rarea[b + 1] * rcnt[b + 1];
        if (cost < best_cost) { best_cost = cost; best_axis = axis; best_split = b; }
      }
    }

    uint32_t mid;
    if (best_axis < 0) {
      mid = start + count / 2;  // degenerate: median split
    } else {
      float scale = kBins / ext[best_axis];
      auto it = std::partition(
          tri_order.begin() + start, tri_order.begin() + start + count,
          [&](uint32_t t) {
            int b = std::min(kBins - 1, (int)((centroid[t][best_axis] -
                                               cb.mn[best_axis]) * scale));
            return b <= best_split;
          });
      mid = (uint32_t)(it - tri_order.begin());
      if (mid == start || mid == start + count) mid = start + count / 2;
    }

    uint32_t li = nodes_used;
    nodes_used += 2;
    nodes[ni].left_first = li;
    nodes[ni].count = 0;
    set_bounds(li, start, mid - start);
    set_bounds(li + 1, mid, start + count - mid);
    subdivide(li, start, mid - start, depth + 1);
    subdivide(li + 1, mid, start + count - mid, depth + 1);
  }
};

}  // namespace

extern "C" {

// Returns number of nodes written. indices (3T) is permuted in place.
// nodes_out must have room for 2*T + 2 nodes.
int32_t voidin_build_blas(const float* vertices, int64_t n_verts,
                          int32_t* indices, int64_t n_tris,
                          Node* nodes_out) {
  (void)n_verts;
  if (n_tris <= 0) return 0;
  Builder b;
  b.verts = reinterpret_cast<const Vec3*>(vertices);
  b.tri_order.resize(n_tris);
  b.tri_box.resize(n_tris);
  b.centroid.resize(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    b.tri_order[t] = (uint32_t)t;
    Vec3 v0 = b.verts[indices[3 * t]];
    Vec3 v1 = b.verts[indices[3 * t + 1]];
    Vec3 v2 = b.verts[indices[3 * t + 2]];
    Aabb box; box.grow(v0); box.grow(v1); box.grow(v2);
    b.tri_box[t] = box;
    b.centroid[t] = (v0 + v1 + v2) * (1.f / 3.f);
  }
  b.nodes.resize(2 * n_tris + 2);
  std::memset(b.nodes.data(), 0, sizeof(Node) * b.nodes.size());
  b.set_bounds(0, 0, (uint32_t)n_tris);
  b.nodes[0].count = (uint32_t)n_tris;
  b.subdivide(0, 0, (uint32_t)n_tris, 0);

  // permute the index buffer so leaves reference contiguous triangles
  std::vector<int32_t> permuted(3 * n_tris);
  for (int64_t i = 0; i < n_tris; ++i) {
    uint32_t src = b.tri_order[i];
    permuted[3 * i] = indices[3 * src];
    permuted[3 * i + 1] = indices[3 * src + 1];
    permuted[3 * i + 2] = indices[3 * src + 2];
  }
  std::memcpy(indices, permuted.data(), sizeof(int32_t) * 3 * n_tris);
  std::memcpy(nodes_out, b.nodes.data(), sizeof(Node) * b.nodes_used);
  return (int32_t)b.nodes_used;
}

struct TlasNode {
  float mn[3];
  uint32_t left_right;
  float mx[3];
  uint32_t instance;
};

// Top-down SAH TLAS over instance AABBs; returns node count (<= 2N).
int32_t voidin_build_tlas(const float* inst_min, const float* inst_max,
                          int64_t n, TlasNode* nodes_out) {
  if (n <= 0) return 0;
  struct Item { Aabb box; Vec3 c; uint32_t id; };
  std::vector<Item> items(n);
  for (int64_t i = 0; i < n; ++i) {
    Item& it = items[i];
    std::memcpy(&it.box.mn, inst_min + 3 * i, 12);
    std::memcpy(&it.box.mx, inst_max + 3 * i, 12);
    it.c = (it.box.mn + it.box.mx) * 0.5f;
    it.id = (uint32_t)i;
  }
  int32_t used = 1;
  struct Range { uint32_t node; int64_t lo, hi; };
  std::vector<Range> stack{{0, 0, (int64_t)n}};
  while (!stack.empty()) {
    Range r = stack.back();
    stack.pop_back();
    Aabb b;
    for (int64_t i = r.lo; i < r.hi; ++i) b.grow(items[i].box);
    TlasNode& node = nodes_out[r.node];
    std::memcpy(node.mn, &b.mn, 12);
    std::memcpy(node.mx, &b.mx, 12);
    if (r.hi - r.lo == 1) {
      node.left_right = 0;
      node.instance = items[r.lo].id;
      continue;
    }
    Aabb cb;
    for (int64_t i = r.lo; i < r.hi; ++i) cb.grow(items[i].c);
    Vec3 ext = cb.mx - cb.mn;
    int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
    int64_t mid = (r.lo + r.hi) / 2;
    if (ext[axis] > 0.f) {
      float scale = kBins / ext[axis];
      float best_cost = 1e30f; int best_split = -1;
      Aabb bbox[kBins]; uint32_t bcount[kBins] = {0};
      for (int64_t i = r.lo; i < r.hi; ++i) {
        int bb = std::min(kBins - 1,
                          (int)((items[i].c[axis] - cb.mn[axis]) * scale));
        bbox[bb].grow(items[i].box); ++bcount[bb];
      }
      float larea[kBins], rarea[kBins];
      uint32_t lcnt[kBins], rcnt[kBins];
      Aabb acc; uint32_t c = 0;
      for (int bb = 0; bb < kBins; ++bb) { acc.grow(bbox[bb]); c += bcount[bb];
        larea[bb] = acc.area(); lcnt[bb] = c; }
      acc = Aabb(); c = 0;
      for (int bb = kBins - 1; bb >= 0; --bb) { acc.grow(bbox[bb]); c += bcount[bb];
        rarea[bb] = acc.area(); rcnt[bb] = c; }
      for (int bb = 0; bb < kBins - 1; ++bb) {
        if (!lcnt[bb] || !rcnt[bb + 1]) continue;
        float cost = larea[bb] * lcnt[bb] + rarea[bb + 1] * rcnt[bb + 1];
        if (cost < best_cost) { best_cost = cost; best_split = bb; }
      }
      if (best_split >= 0) {
        auto it = std::partition(items.begin() + r.lo, items.begin() + r.hi,
                                 [&](const Item& item) {
          int bb = std::min(kBins - 1,
                            (int)((item.c[axis] - cb.mn[axis]) * scale));
          return bb <= best_split;
        });
        mid = it - items.begin();
        if (mid == r.lo || mid == r.hi) mid = (r.lo + r.hi) / 2;
      }
    }
    int32_t li = used; used += 2;
    if (li + 1 > 0xFFFF) return -1;  // 16-bit packing limit
    node.left_right = (uint32_t)li | ((uint32_t)(li + 1) << 16);
    node.instance = 0xFFFFFFFFu;
    stack.push_back({(uint32_t)li, r.lo, mid});
    stack.push_back({(uint32_t)(li + 1), mid, r.hi});
  }
  return used;
}

}  // extern "C"
