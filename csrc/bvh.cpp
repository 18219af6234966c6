// Flat BVH builder (host-side scene compile step).
//
// Host-side equivalent of the reference's two BVH builders
// (bvh_node<T> recursive qsort median split, scene_object.h:283-319, and
// pod_bvh<T> midpoint split, triangle.h:78-152). The build runs once on the
// host in native code; the output is a flat, index-based node array designed
// for vectorized/masked traversal on device:
//
//   nodes[2n-1]: bounds (6 floats) + {left, first, count, order}
//   - interior: left = index of left child, right child = left + 1
//     (pod_bvh layout, triangle.h:46-56), count = 0
//   - leaf: first/count index into prim_order (a permutation of input prims)
//   - order: 8-bit octant code — bit k says whether the LEFT child should be
//     visited first for ray-direction octant k (the reference's
//     precompute_node_order trick, triangle.h:282-322 / scene_object.h:154-205)
//
// Differences from the reference (deliberate, SURVEY.md section 9.1/9.4):
//   - split axis chosen on CENTROID extent with median fallback when the
//     midpoint partition degenerates (the reference can produce size-0
//     partitions and recurse forever on flat distributions)
//   - node boxes initialized with -FLT_MAX (the reference's update_node_box
//     uses float::min(), a tiny POSITIVE number — triangle.h:159-161 bug)
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Node {
  float bmin[3];
  float bmax[3];
  int32_t left;   // interior: left child; leaf: unused (-1)
  int32_t first;  // leaf: first prim in prim_order
  int32_t count;  // leaf: prim count; 0 => interior
  int32_t order;  // 8-bit octant traversal code
};

struct Builder {
  const float* cmin;  // (n,3) prim AABB min
  const float* cmax;  // (n,3) prim AABB max
  std::vector<float> centroid;  // (n,3)
  std::vector<int32_t> order;   // prim permutation
  std::vector<Node> nodes;
  int leaf_size;

  void update_bounds(Node& nd) {
    for (int k = 0; k < 3; ++k) {
      nd.bmin[k] = FLT_MAX;
      nd.bmax[k] = -FLT_MAX;  // reference bug fixed (triangle.h:159-161)
    }
    for (int32_t i = nd.first; i < nd.first + nd.count; ++i) {
      const int32_t p = order[i];
      for (int k = 0; k < 3; ++k) {
        nd.bmin[k] = std::min(nd.bmin[k], cmin[3 * p + k]);
        nd.bmax[k] = std::max(nd.bmax[k], cmax[3 * p + k]);
      }
    }
  }

  // 8-octant order code: for each ray-direction octant, should we visit the
  // left child first? Encoded from the child centroids on the split axis
  // (triangle.h:282-322): left-first when the ray direction's sign on that
  // axis points from left box to right box.
  static int32_t order_code(const Node& l, const Node& r, int axis) {
    const float lc = 0.5f * (l.bmin[axis] + l.bmax[axis]);
    const float rc = 0.5f * (r.bmin[axis] + r.bmax[axis]);
    int32_t code = 0;
    for (int oct = 0; oct < 8; ++oct) {
      const bool dir_neg = (oct >> axis) & 1;  // octant bit = dir[axis] < 0
      const bool left_first = dir_neg ? (lc >= rc) : (lc <= rc);
      if (left_first) code |= (1 << oct);
    }
    return code;
  }

  // Depth past which the split MUST be a median split: midpoint partitions
  // can degenerate to 1:(n-1) on skewed centroid distributions, producing
  // depth O(n) and overflowing the device traversal's fixed short stack
  // (ops/bvh.py MAX_STACK = 48). Median splits halve the count, so total
  // depth <= MEDIAN_DEPTH + ceil(log2(n)) <= 22 + 24 = 46 < 48 for n < 16M.
  static constexpr int kMedianDepth = 22;

  void subdivide(int32_t ni, int depth) {
    Node& nd = nodes[ni];
    if (nd.count <= leaf_size) return;

    // split axis: largest CENTROID extent
    float clo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float chi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int32_t i = nd.first; i < nd.first + nd.count; ++i) {
      const int32_t p = order[i];
      for (int k = 0; k < 3; ++k) {
        clo[k] = std::min(clo[k], centroid[3 * p + k]);
        chi[k] = std::max(chi[k], centroid[3 * p + k]);
      }
    }
    int axis = 0;
    float ext = chi[0] - clo[0];
    for (int k = 1; k < 3; ++k) {
      if (chi[k] - clo[k] > ext) {
        ext = chi[k] - clo[k];
        axis = k;
      }
    }
    if (ext <= 0.0f) {  // all centroids identical: arbitrary halves
      make_children(ni, nd.first + nd.count / 2, axis, depth);
      return;
    }

    int32_t* beg = order.data() + nd.first;
    int32_t* end = beg + nd.count;
    int32_t mid_idx;
    if (depth >= kMedianDepth) {
      mid_idx = nd.first + nd.count / 2;  // depth-bounded: median only
      std::nth_element(beg, order.data() + mid_idx, end,
                       [&](int32_t a, int32_t b) {
                         return centroid[3 * a + axis] < centroid[3 * b + axis];
                       });
    } else {
      // midpoint partition (triangle.h:109-128)
      const float split = 0.5f * (clo[axis] + chi[axis]);
      int32_t* mid = std::partition(beg, end, [&](int32_t p) {
        return centroid[3 * p + axis] < split;
      });
      mid_idx = static_cast<int32_t>(mid - order.data());
      if (mid_idx == nd.first || mid_idx == nd.first + nd.count) {
        // degenerate: median split fallback
        mid_idx = nd.first + nd.count / 2;
        std::nth_element(beg, order.data() + mid_idx, end,
                         [&](int32_t a, int32_t b) {
                           return centroid[3 * a + axis] < centroid[3 * b + axis];
                         });
      }
    }
    make_children(ni, mid_idx, axis, depth);
  }

  void make_children(int32_t ni, int32_t mid, int axis, int depth) {
    const int32_t li = static_cast<int32_t>(nodes.size());
    Node l{}, r{};
    l.first = nodes[ni].first;
    l.count = mid - nodes[ni].first;
    l.left = -1;
    r.first = mid;
    r.count = nodes[ni].first + nodes[ni].count - mid;
    r.left = -1;
    nodes.push_back(l);
    nodes.push_back(r);
    update_bounds(nodes[li]);
    update_bounds(nodes[li + 1]);
    nodes[ni].left = li;
    nodes[ni].order = order_code(nodes[li], nodes[li + 1], axis);
    nodes[ni].count = 0;  // interior
    subdivide(li, depth + 1);
    subdivide(li + 1, depth + 1);
  }
};

}  // namespace

extern "C" {

// Builds a flat BVH. Inputs: prim AABBs (n x 3 each). Outputs (caller
// allocated): node_bounds (2n-1) x 6, node_meta (2n-1) x 4 [left, first,
// count, order], prim_order n. Returns the actual node count (<= 2n-1),
// or -1 on bad input.
int32_t mrt_bvh_build(const float* bmin, const float* bmax, int32_t n,
                      int32_t leaf_size, float* node_bounds,
                      int32_t* node_meta, int32_t* prim_order) {
  if (n <= 0 || leaf_size < 1) return -1;
  Builder b;
  b.cmin = bmin;
  b.cmax = bmax;
  b.leaf_size = leaf_size;
  b.centroid.resize(3 * static_cast<size_t>(n));
  for (int32_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k)
      b.centroid[3 * i + k] = 0.5f * (bmin[3 * i + k] + bmax[3 * i + k]);
  b.order.resize(n);
  for (int32_t i = 0; i < n; ++i) b.order[i] = i;
  b.nodes.reserve(2 * static_cast<size_t>(n) - 1);

  Node root{};
  root.first = 0;
  root.count = n;
  root.left = -1;
  b.nodes.push_back(root);
  b.update_bounds(b.nodes[0]);
  b.subdivide(0, 0);

  const int32_t node_count = static_cast<int32_t>(b.nodes.size());
  for (int32_t i = 0; i < node_count; ++i) {
    const Node& nd = b.nodes[i];
    std::memcpy(node_bounds + 6 * i, nd.bmin, 3 * sizeof(float));
    std::memcpy(node_bounds + 6 * i + 3, nd.bmax, 3 * sizeof(float));
    node_meta[4 * i + 0] = nd.left;
    node_meta[4 * i + 1] = nd.first;
    node_meta[4 * i + 2] = nd.count;
    node_meta[4 * i + 3] = nd.order;
  }
  std::memcpy(prim_order, b.order.data(), n * sizeof(int32_t));
  return node_count;
}

}  // extern "C"
