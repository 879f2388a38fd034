// mesh_sdf: BVH-accelerated signed-distance queries from triangle meshes.
//
// The reference delegates mesh -> SDF ground truth to the external
// `mesh_to_sdf` package (pyrender virtual scans + scipy cKDTree; see
// the reference's prepare_shapenet_dataset.py:32-35). This is the
// in-framework native replacement: a median-split AABB BVH over triangles
// with exact point-to-triangle distances via branch-and-bound traversal,
// and TWO sign oracles:
//
//   * ray parity  — majority of 3 skew-direction crossing parities; exact
//     for closed, non-self-intersecting surfaces (the watertight fast path);
//   * depth scans — N orthographic depth renders from sphere directions; a
//     point is OUTSIDE iff it is visible (unoccluded) in at least one scan.
//     This is the reference's virtual-scan method (USE_DEPTH_BUFFER=True,
//     SCAN_COUNT=50, SCAN_RESOLUTION=1024 in prepare_shapenet_dataset.py:
//     32-35) and is what makes non-watertight / double-walled /
//     self-intersecting ShapeNet meshes usable: cavities that no camera can
//     see are classified inside regardless of winding or crossing parity.
//
// Queries and scan rasterization fan out over hardware threads.
//
// C ABI (ctypes-friendly):
//   void* mesh_sdf_create(const float* vertices, int n_vertices,
//                         const int* faces, int n_faces);
//   void  mesh_sdf_build_scans(void* handle, int n_scans, int resolution);
//   void  mesh_sdf_query(void* handle, const float* points, int n_points,
//                        float* out_sdf);        // parity-signed distance
//   void  mesh_sdf_query_scan(void*, const float*, int, float*);
//                                                // scan-signed distance
//   void  mesh_sdf_query_unsigned(void*, const float*, int, float*);
//   void  mesh_sdf_destroy(void* handle);
//
// Build (shapegan_tpu_torch/host_build.py, at first use):
//   g++ -O3 -std=c++17 -fPIC -pthread -Wall -shared mesh_sdf.cpp -o build/libmesh_sdf_<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
};

inline float dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm2(const Vec3& a) { return dot(a, a); }

// Squared distance from point p to triangle (a, b, c). Ericson, RTCD 5.1.5.
float point_triangle_dist2(const Vec3& p, const Vec3& a, const Vec3& b, const Vec3& c) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return norm2(ap);

  Vec3 bp = p - b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return norm2(bp);

  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float v = d1 / (d1 - d3);
    return norm2(ap - ab * v);
  }

  Vec3 cp = p - c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return norm2(cp);

  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float w = d2 / (d2 - d6);
    return norm2(ap - ac * w);
  }

  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    Vec3 bc = c - b;
    return norm2(bp - bc * w);
  }

  float denom = 1.0f / (va + vb + vc);
  float v = vb * denom, w = vc * denom;
  Vec3 closest = a + ab * v + ac * w;
  return norm2(p - closest);
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::max(), std::numeric_limits<float>::max(),
          std::numeric_limits<float>::max()};
  Vec3 hi{-std::numeric_limits<float>::max(), -std::numeric_limits<float>::max(),
          -std::numeric_limits<float>::max()};
  void grow(const Vec3& p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  float dist2(const Vec3& p) const {
    float dx = std::max({lo.x - p.x, 0.0f, p.x - hi.x});
    float dy = std::max({lo.y - p.y, 0.0f, p.y - hi.y});
    float dz = std::max({lo.z - p.z, 0.0f, p.z - hi.z});
    return dx * dx + dy * dy + dz * dz;
  }
  // General slab test for a ray from p along (unit) direction d, t >= 0.
  bool hit_by_ray(const Vec3& p, const Vec3& inv_d) const {
    float tmin = 0.0f, tmax = std::numeric_limits<float>::max();
    const float* plo = &lo.x;
    const float* phi = &hi.x;
    const float* pp = &p.x;
    const float* pinv = &inv_d.x;
    for (int i = 0; i < 3; ++i) {
      float t0 = (plo[i] - pp[i]) * pinv[i];
      float t1 = (phi[i] - pp[i]) * pinv[i];
      if (t0 > t1) std::swap(t0, t1);
      tmin = std::max(tmin, t0);
      tmax = std::min(tmax, t1);
      if (tmin > tmax) return false;
    }
    return true;
  }
};

struct Node {
  AABB box;
  int left = -1, right = -1;   // children (internal) …
  int first = 0, count = 0;    // … or triangle range (leaf)
  bool is_leaf() const { return count > 0; }
};

struct BVH {
  std::vector<Vec3> v0, e1, e2;  // per-triangle: origin vertex + edge vectors
  std::vector<Vec3> centroids;
  std::vector<int> tri_order;
  std::vector<Node> nodes;

  void build(const float* vertices, const int* faces, int n_faces) {
    v0.resize(n_faces); e1.resize(n_faces); e2.resize(n_faces);
    centroids.resize(n_faces);
    tri_order.resize(n_faces);
    for (int f = 0; f < n_faces; ++f) {
      Vec3 a{vertices[3 * faces[3 * f] + 0], vertices[3 * faces[3 * f] + 1],
             vertices[3 * faces[3 * f] + 2]};
      Vec3 b{vertices[3 * faces[3 * f + 1] + 0], vertices[3 * faces[3 * f + 1] + 1],
             vertices[3 * faces[3 * f + 1] + 2]};
      Vec3 c{vertices[3 * faces[3 * f + 2] + 0], vertices[3 * faces[3 * f + 2] + 1],
             vertices[3 * faces[3 * f + 2] + 2]};
      v0[f] = a; e1[f] = b - a; e2[f] = c - a;
      centroids[f] = (a + b + c) * (1.0f / 3.0f);
      tri_order[f] = f;
    }
    nodes.reserve(2 * n_faces);
    build_node(0, n_faces);
  }

  int build_node(int first, int count) {
    int idx = (int)nodes.size();
    nodes.push_back({});
    AABB box;
    for (int i = first; i < first + count; ++i) {
      int t = tri_order[i];
      box.grow(v0[t]); box.grow(v0[t] + e1[t]); box.grow(v0[t] + e2[t]);
    }
    nodes[idx].box = box;
    if (count <= 4) {
      nodes[idx].first = first;
      nodes[idx].count = count;
      return idx;
    }
    Vec3 extent = box.hi - box.lo;
    int axis = (extent.x > extent.y && extent.x > extent.z) ? 0 : (extent.y > extent.z ? 1 : 2);
    int mid = first + count / 2;
    std::nth_element(
        tri_order.begin() + first, tri_order.begin() + mid, tri_order.begin() + first + count,
        [&](int a, int b) { return (&centroids[a].x)[axis] < (&centroids[b].x)[axis]; });
    int left = build_node(first, count / 2);
    int right = build_node(mid, count - count / 2);
    nodes[idx].left = left;
    nodes[idx].right = right;
    nodes[idx].count = 0;
    return idx;
  }

  float closest_dist2(const Vec3& p) const {
    float best = std::numeric_limits<float>::max();
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const Node& node = nodes[stack[--sp]];
      if (node.box.dist2(p) >= best) continue;
      if (node.is_leaf()) {
        for (int i = node.first; i < node.first + node.count; ++i) {
          int t = tri_order[i];
          best = std::min(best,
                          point_triangle_dist2(p, v0[t], v0[t] + e1[t], v0[t] + e2[t]));
        }
      } else {
        float dl = nodes[node.left].box.dist2(p);
        float dr = nodes[node.right].box.dist2(p);
        // Visit nearer child first for tighter pruning.
        if (dl < dr) {
          if (dr < best) stack[sp++] = node.right;
          if (dl < best) stack[sp++] = node.left;
        } else {
          if (dl < best) stack[sp++] = node.left;
          if (dr < best) stack[sp++] = node.right;
        }
      }
    }
    return best;
  }

  // Count crossings of a ray from p along dir (Möller–Trumbore).
  int ray_crossings(const Vec3& p, const Vec3& dir) const {
    Vec3 inv_d{1.0f / dir.x, 1.0f / dir.y, 1.0f / dir.z};
    int crossings = 0;
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const Node& node = nodes[stack[--sp]];
      if (!node.box.hit_by_ray(p, inv_d)) continue;
      if (node.is_leaf()) {
        for (int i = node.first; i < node.first + node.count; ++i) {
          int t = tri_order[i];
          Vec3 pvec = cross(dir, e2[t]);
          float det = dot(e1[t], pvec);
          if (std::fabs(det) < 1e-12f) continue;
          float inv = 1.0f / det;
          Vec3 tvec = p - v0[t];
          float u = dot(tvec, pvec) * inv;
          if (u < 0 || u > 1) continue;
          Vec3 qvec = cross(tvec, e1[t]);
          float v = dot(dir, qvec) * inv;
          if (v < 0 || u + v > 1) continue;
          float thit = dot(e2[t], qvec) * inv;
          if (thit > 1e-8f) ++crossings;
        }
      } else {
        stack[sp++] = node.left;
        stack[sp++] = node.right;
      }
    }
    return crossings;
  }

  float signed_distance(const Vec3& p) const {
    float d = std::sqrt(closest_dist2(p));
    // Majority vote over three fixed skew-direction parity tests: arbitrary
    // irrational-ish directions avoid the shared-edge double counting that
    // axis rays hit on symmetric/grid-extracted meshes.
    static const Vec3 kDirs[3] = {
        {0.8491679f, 0.3717402f, 0.3756200f},
        {-0.2917509f, 0.9124136f, 0.2877602f},
        {0.3266091f, -0.2465251f, 0.9124458f},
    };
    int votes = 0;
    for (const Vec3& dir : kDirs) {
      votes += (ray_crossings(p, dir) % 2 == 1) ? 1 : 0;
    }
    return votes >= 2 ? -d : d;
  }
};

void parallel_for(int n, const std::function<void(int, int)>& fn,
                  int grain = 256);

// --------------------------------------------------------------- depth scans
//
// Orthographic virtual scans for visibility-based sign determination.
// Directions come from a Fibonacci sphere (even coverage, no pole clustering).
// Each scan projects the mesh onto a (right, up) image plane orthogonal to
// the scan direction and keeps the minimum depth (distance along the scan
// direction) per pixel — a GL depth pre-pass without GL. No backface
// culling: sign must not depend on winding, which ShapeNet gets wrong often.

struct DepthScans {
  int n_scans = 0;
  int res = 0;
  Vec3 center{0, 0, 0};
  float half_extent = 1.0f;  // viewport maps [-he, he]^2 around center
  float bias = 0.0f;         // depth comparison slack (slope/texel error)
  std::vector<Vec3> right, up, fwd;  // per-scan orthonormal basis
  std::vector<float> depth;          // [n_scans, res, res]; +inf = empty
};

inline Vec3 normalized(const Vec3& v) {
  float n = std::sqrt(norm2(v));
  return v * (1.0f / std::max(n, 1e-20f));
}

// Unit directions via the Fibonacci lattice.
inline Vec3 fibonacci_direction(int i, int n) {
  const float golden = 2.3999632297286533f;  // 2*pi*(1 - 1/phi)
  float y = 1.0f - 2.0f * (i + 0.5f) / n;
  float r = std::sqrt(std::max(0.0f, 1.0f - y * y));
  float theta = golden * i;
  return {r * std::cos(theta), y, r * std::sin(theta)};
}

void build_scans(const BVH& bvh, DepthScans& scans, int n_scans, int res) {
  scans.n_scans = n_scans;
  scans.res = res;
  const AABB& root = bvh.nodes[0].box;
  scans.center = (root.lo + root.hi) * 0.5f;
  Vec3 half = (root.hi - root.lo) * 0.5f;
  scans.half_extent = std::sqrt(norm2(half)) * 1.02f + 1e-6f;
  // One texel of world space; the visibility test also maxes over a 3x3
  // neighborhood, so one texel of slack suffices for slope error.
  scans.bias = 2.0f * scans.half_extent / res;
  scans.right.resize(n_scans);
  scans.up.resize(n_scans);
  scans.fwd.resize(n_scans);
  scans.depth.assign((size_t)n_scans * res * res,
                     std::numeric_limits<float>::infinity());

  const int n_tris = (int)bvh.v0.size();
  parallel_for(
      n_scans,
      [&](int lo, int hi) {
    for (int s = lo; s < hi; ++s) {
      Vec3 fwd = fibonacci_direction(s, n_scans);
      Vec3 ref = std::fabs(fwd.y) < 0.99f ? Vec3{0, 1, 0} : Vec3{1, 0, 0};
      Vec3 right = normalized(cross(fwd, ref));
      Vec3 up = cross(right, fwd);  // unit by construction
      scans.right[s] = right;
      scans.up[s] = up;
      scans.fwd[s] = fwd;
      float* zbuf = scans.depth.data() + (size_t)s * res * res;
      float scale = res / (2.0f * scans.half_extent);

      for (int t = 0; t < n_tris; ++t) {
        Vec3 a = bvh.v0[t] - scans.center;
        Vec3 b = a + bvh.e1[t];
        Vec3 c = a + bvh.e2[t];
        // Screen coords: [-he, he] -> [0, res] with pixel centers at +0.5.
        float ax = (dot(a, right) + scans.half_extent) * scale;
        float ay = (dot(a, up) + scans.half_extent) * scale;
        float az = dot(a, fwd);
        float bx = (dot(b, right) + scans.half_extent) * scale;
        float by = (dot(b, up) + scans.half_extent) * scale;
        float bz = dot(b, fwd);
        float cx = (dot(c, right) + scans.half_extent) * scale;
        float cy = (dot(c, up) + scans.half_extent) * scale;
        float cz = dot(c, fwd);
        float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
        if (std::fabs(area) < 1e-12f) continue;  // edge-on: no coverage
        float inv_area = 1.0f / area;
        int x0 = std::max(0, (int)std::floor(std::min({ax, bx, cx})));
        int x1 = std::min(res - 1, (int)std::ceil(std::max({ax, bx, cx})));
        int y0 = std::max(0, (int)std::floor(std::min({ay, by, cy})));
        int y1 = std::min(res - 1, (int)std::ceil(std::max({ay, by, cy})));
        for (int y = y0; y <= y1; ++y) {
          float py = y + 0.5f;
          for (int x = x0; x <= x1; ++x) {
            float px = x + 0.5f;
            float w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv_area;
            float w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv_area;
            float w2 = 1.0f - w0 - w1;
            if (w0 < 0 || w1 < 0 || w2 < 0) continue;
            float z = w0 * az + w1 * bz + w2 * cz;
            float& zb = zbuf[(size_t)y * res + x];
            if (z < zb) zb = z;
          }
        }
      }
    }
      },
      /*grain=*/1);
}

// A point is visible in a scan if nothing renders in front of it near its
// pixel: compare against the MAX depth of the 3x3 neighborhood (conservative
// visibility — absorbs rasterization slope error at silhouettes) plus one
// texel of bias. Points projecting outside the viewport are trivially
// visible (nothing can occlude them: the viewport bounds the whole mesh).
bool visible_in_any_scan(const DepthScans& scans, const Vec3& p) {
  const int res = scans.res;
  float scale = res / (2.0f * scans.half_extent);
  Vec3 q = p - scans.center;
  for (int s = 0; s < scans.n_scans; ++s) {
    float x = (dot(q, scans.right[s]) + scans.half_extent) * scale;
    float y = (dot(q, scans.up[s]) + scans.half_extent) * scale;
    int px = (int)std::floor(x);
    int py = (int)std::floor(y);
    if (px < 0 || py < 0 || px >= res || py >= res) return true;
    float z = dot(q, scans.fwd[s]);
    const float* zbuf = scans.depth.data() + (size_t)s * res * res;
    float zmax = -std::numeric_limits<float>::infinity();
    for (int dy = -1; dy <= 1; ++dy) {
      int yy = py + dy;
      if (yy < 0 || yy >= res) return true;  // silhouette edge of the map
      for (int dx = -1; dx <= 1; ++dx) {
        int xx = px + dx;
        if (xx < 0 || xx >= res) return true;
        zmax = std::max(zmax, zbuf[(size_t)yy * res + xx]);
      }
    }
    if (z <= zmax + scans.bias) return true;  // includes empty (+inf) pixels
  }
  return false;
}

// ------------------------------------------------------------------- engine

struct Engine {
  BVH bvh;
  DepthScans scans;  // empty until mesh_sdf_build_scans
};

// grain: minimum items per thread. The default (256) suits fine-grained
// per-point loops; COARSE work items (e.g. the ~50 whole-image depth scans)
// must pass grain=1 or the n/grain heuristic collapses them to one thread.
void parallel_for(int n, const std::function<void(int, int)>& fn, int grain) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  int n_threads = std::min<int>(hw, std::max(1, n / std::max(1, grain)));
  if (n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void* mesh_sdf_create(const float* vertices, int n_vertices, const int* faces, int n_faces) {
  (void)n_vertices;
  auto* engine = new Engine();
  engine->bvh.build(vertices, faces, n_faces);
  return engine;
}

void mesh_sdf_build_scans(void* handle, int n_scans, int resolution) {
  auto* engine = static_cast<Engine*>(handle);
  build_scans(engine->bvh, engine->scans, n_scans, resolution);
}

void mesh_sdf_query(void* handle, const float* points, int n_points, float* out_sdf) {
  auto* engine = static_cast<Engine*>(handle);
  parallel_for(n_points, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Vec3 p{points[3 * i], points[3 * i + 1], points[3 * i + 2]};
      out_sdf[i] = engine->bvh.signed_distance(p);
    }
  });
}

void mesh_sdf_query_scan(void* handle, const float* points, int n_points, float* out_sdf) {
  auto* engine = static_cast<Engine*>(handle);
  parallel_for(n_points, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Vec3 p{points[3 * i], points[3 * i + 1], points[3 * i + 2]};
      float d = std::sqrt(engine->bvh.closest_dist2(p));
      out_sdf[i] = visible_in_any_scan(engine->scans, p) ? d : -d;
    }
  });
}

void mesh_sdf_query_unsigned(void* handle, const float* points, int n_points, float* out) {
  auto* engine = static_cast<Engine*>(handle);
  parallel_for(n_points, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Vec3 p{points[3 * i], points[3 * i + 1], points[3 * i + 2]};
      out[i] = std::sqrt(engine->bvh.closest_dist2(p));
    }
  });
}

void mesh_sdf_destroy(void* handle) { delete static_cast<Engine*>(handle); }

}  // extern "C"
