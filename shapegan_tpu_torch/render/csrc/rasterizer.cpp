// Software triangle rasterizer with shadow mapping.
//
// Headless-capable replacement for the reference's GL viewer pipeline
// (the reference's rendering/__init__.py:174-196 two-pass render,
//  vertex.glsl / fragment.glsl shading): a light-space depth pre-pass into a
// shadow map, then a camera pass with z-buffering, Blinn-Phong-style shading,
// PCF 3x3 shadow lookup with bilinear shadow lerp, rim light, and a ground
// floor plane darkened by the shadow factor (fragment.glsl:16-73).
//
// The shading math reproduces the reference shaders' conventions exactly,
// including their quirks: normals and the light position are transformed by
// the full view-projection matrix (vertex.glsl:20), the view direction is the
// negated clip-space position (fragment.glsl:59), and out-of-range shadow-map
// samples clamp to the edge texel, matching the GL_CLAMP_TO_EDGE wrap mode
// the reference binds (rendering/__init__.py:44-49).
//
// C ABI only; loaded from Python via ctypes (see render/software.py).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x = 0, y = 0, z = 0;
};
struct Vec4 {
  float x = 0, y = 0, z = 0, w = 0;
};

inline Vec4 mat_mul(const float* m, const Vec4& v) {
  // m: 4x4 row-major
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z + m[3] * v.w,
          m[4] * v.x + m[5] * v.y + m[6] * v.z + m[7] * v.w,
          m[8] * v.x + m[9] * v.y + m[10] * v.z + m[11] * v.w,
          m[12] * v.x + m[13] * v.y + m[14] * v.z + m[15] * v.w};
}

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One transformed triangle ready for rasterization.
struct ScreenTri {
  // Per-vertex: screen x/y, NDC z (depth), 1/w, and perspective-divided
  // varyings (varying / w) for perspective-correct interpolation.
  float sx[3], sy[3], sz[3], inv_w[3];
  Vec3 normal_over_w[3];    // clip-space-transformed normal / w
  Vec3 position_over_w[3];  // clip-space position / w
  Vec4 shadow_over_w[3];    // light-space clip position / w
  float min_x, max_x, min_y, max_y;
  bool valid = false;
};

// A clip-space vertex with all varyings, for near-plane clipping.
struct ClipVert {
  Vec4 clip;    // camera clip position (also the `position` varying, pre-divide)
  Vec4 normal;  // camera-clip-transformed normal (w unused)
  Vec4 shadow;  // light clip position
};

inline ClipVert lerp_vert(const ClipVert& a, const ClipVert& b, float t) {
  auto L4 = [t](const Vec4& p, const Vec4& q) {
    return Vec4{p.x + (q.x - p.x) * t, p.y + (q.y - p.y) * t,
                p.z + (q.z - p.z) * t, p.w + (q.w - p.w) * t};
  };
  return {L4(a.clip, b.clip), L4(a.normal, b.normal), L4(a.shadow, b.shadow)};
}

constexpr float kNearW = 1e-4f;

// Sutherland-Hodgman clip of a polygon against the near plane w >= kNearW.
// In/out via a fixed-size buffer (a triangle clips to at most 4 vertices).
int clip_near(const ClipVert* in, int n_in, ClipVert* out) {
  int n_out = 0;
  for (int i = 0; i < n_in; ++i) {
    const ClipVert& cur = in[i];
    const ClipVert& nxt = in[(i + 1) % n_in];
    bool cur_in = cur.clip.w >= kNearW;
    bool nxt_in = nxt.clip.w >= kNearW;
    if (cur_in) out[n_out++] = cur;
    if (cur_in != nxt_in) {
      float t = (kNearW - cur.clip.w) / (nxt.clip.w - cur.clip.w);
      out[n_out++] = lerp_vert(cur, nxt, t);
    }
  }
  return n_out;
}

// Project a clipped clip-space vertex into one ScreenTri slot.
inline void project_vert(const ClipVert& v, int k, int size, ScreenTri* out) {
  float inv_w = 1.0f / v.clip.w;
  // Viewport transform; GL reads pixels bottom-up, we store row 0 = top,
  // so flip y here (matches the reference's [::-1] readback flip).
  out->sx[k] = (v.clip.x * inv_w * 0.5f + 0.5f) * size;
  out->sy[k] = (1.0f - (v.clip.y * inv_w * 0.5f + 0.5f)) * size;
  out->sz[k] = v.clip.z * inv_w;
  out->inv_w[k] = inv_w;
  out->normal_over_w[k] = {v.normal.x * inv_w, v.normal.y * inv_w, v.normal.z * inv_w};
  out->position_over_w[k] = {v.clip.x * inv_w, v.clip.y * inv_w, v.clip.z * inv_w};
  out->shadow_over_w[k] = {v.shadow.x * inv_w, v.shadow.y * inv_w,
                           v.shadow.z * inv_w, v.shadow.w * inv_w};
}

// Transform one triangle through the camera & light matrices, clip against
// the near plane, and fan-triangulate into up to 2 ScreenTris.
int transform_triangle(const float* vertices, const float* normals, long base,
                       const float* camera_vp, const float* light_vp,
                       float y_offset, int size, ScreenTri* out /* [2] */) {
  ClipVert poly[4], raw[3];
  for (int k = 0; k < 3; ++k) {
    const float* v = vertices + (base + k) * 3;
    const float* n = normals + (base + k) * 3;
    Vec4 world{v[0], v[1] + y_offset, v[2], 1.0f};
    raw[k].clip = mat_mul(camera_vp, world);
    // Varyings (vertex.glsl): position = clip xyz; normal = (VP * (n, 0)).xyz
    raw[k].normal = mat_mul(camera_vp, Vec4{n[0], n[1], n[2], 0.0f});
    raw[k].shadow = mat_mul(light_vp, world);
  }
  int n_poly = clip_near(raw, 3, poly);
  if (n_poly < 3) return 0;
  int n_tris = 0;
  for (int t = 0; t + 2 < n_poly; ++t) {  // fan: (0, t+1, t+2)
    ScreenTri& tri = out[n_tris];
    project_vert(poly[0], 0, size, &tri);
    project_vert(poly[t + 1], 1, size, &tri);
    project_vert(poly[t + 2], 2, size, &tri);
    tri.min_x = std::min({tri.sx[0], tri.sx[1], tri.sx[2]});
    tri.max_x = std::max({tri.sx[0], tri.sx[1], tri.sx[2]});
    tri.min_y = std::min({tri.sy[0], tri.sy[1], tri.sy[2]});
    tri.max_y = std::max({tri.sy[0], tri.sy[1], tri.sy[2]});
    tri.valid = true;
    ++n_tris;
  }
  return n_tris;
}

// --------------------------------------------------------------- depth pass

// Rasterize triangles into a depth buffer (GL_LESS, cleared to 1.0).
// Threads own disjoint horizontal strips so writes never race.
void depth_pass(const float* vertices, long n_vertices, const float* light_vp,
                int shadow_size, float* depth, int n_threads) {
  long n_tris = n_vertices / 3;
  std::fill(depth, depth + (long)shadow_size * shadow_size, 1.0f);

  // Transform once (reusing ScreenTri for its screen coords only).
  std::vector<ScreenTri> tris(n_tris);
  static const float zero_normals[3] = {0, 0, 0};
  for (long t = 0; t < n_tris; ++t) {
    ScreenTri tri;
    bool ok = true;
    for (int k = 0; k < 3 && ok; ++k) {
      const float* v = vertices + (t * 3 + k) * 3;
      Vec4 clip = mat_mul(light_vp, Vec4{v[0], v[1], v[2], 1.0f});
      if (clip.w <= 1e-6f) {
        ok = false;
        break;
      }
      float inv_w = 1.0f / clip.w;
      tri.sx[k] = (clip.x * inv_w * 0.5f + 0.5f) * shadow_size;
      // The shadow map is sampled in GL texture space (v up). Keep rows in
      // texture orientation here; the sampler below uses the same convention.
      tri.sy[k] = (clip.y * inv_w * 0.5f + 0.5f) * shadow_size;
      tri.sz[k] = clip.z * inv_w * 0.5f + 0.5f;  // [0,1] like the GL depth range
      (void)zero_normals;
    }
    if (!ok) continue;
    tri.min_x = std::min({tri.sx[0], tri.sx[1], tri.sx[2]});
    tri.max_x = std::max({tri.sx[0], tri.sx[1], tri.sx[2]});
    tri.min_y = std::min({tri.sy[0], tri.sy[1], tri.sy[2]});
    tri.max_y = std::max({tri.sy[0], tri.sy[1], tri.sy[2]});
    tri.valid = true;
    tris[t] = tri;
  }

  auto worker = [&](int row_begin, int row_end) {
    for (const ScreenTri& tri : tris) {
      if (!tri.valid) continue;
      int y0 = std::max(row_begin, (int)std::floor(tri.min_y));
      int y1 = std::min(row_end - 1, (int)std::ceil(tri.max_y));
      int x0 = std::max(0, (int)std::floor(tri.min_x));
      int x1 = std::min(shadow_size - 1, (int)std::ceil(tri.max_x));
      if (y0 > y1 || x0 > x1) continue;
      float ax = tri.sx[0], ay = tri.sy[0];
      float bx = tri.sx[1], by = tri.sy[1];
      float cx = tri.sx[2], cy = tri.sy[2];
      float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      if (std::fabs(area) < 1e-12f) continue;
      float inv_area = 1.0f / area;
      for (int y = y0; y <= y1; ++y) {
        for (int x = x0; x <= x1; ++x) {
          float px = x + 0.5f, py = y + 0.5f;
          float w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv_area;
          float w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv_area;
          float w2 = 1.0f - w0 - w1;
          if (w0 < 0 || w1 < 0 || w2 < 0) continue;
          float z = w0 * tri.sz[0] + w1 * tri.sz[1] + w2 * tri.sz[2];
          float& d = depth[(long)y * shadow_size + x];
          if (z < d) d = z;
        }
      }
    }
  };

  std::vector<std::thread> pool;
  int rows_per = (shadow_size + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int rb = i * rows_per, re = std::min(shadow_size, rb + rows_per);
    if (rb >= re) break;
    pool.emplace_back(worker, rb, re);
  }
  for (auto& th : pool) th.join();
}

// ------------------------------------------------------------- shadow lookup

// texture() under GL_CLAMP_TO_EDGE (the wrap mode the reference actually
// binds, rendering/__init__.py:44-49 — its white border color is dead state
// because CLAMP_TO_EDGE ignores border color): out-of-range samples read the
// nearest edge texel.
inline float shadow_depth_at(const float* shadow, int shadow_size, int x, int y) {
  x = std::min(std::max(x, 0), shadow_size - 1);
  y = std::min(std::max(y, 0), shadow_size - 1);
  return shadow[(long)y * shadow_size + x];
}

inline float is_in_shadow(const float* shadow, int shadow_size, float u, float v,
                          float reference_depth) {
  // texture(shadow_map, uv) — GL samples the texel containing uv.
  int x = (int)std::floor(u * shadow_size);
  int y = (int)std::floor(v * shadow_size);
  return reference_depth > shadow_depth_at(shadow, shadow_size, x, y) ? 1.0f : 0.0f;
}

// fragment.glsl texture2DShadowLerp: bilinear blend of binary comparisons.
inline float shadow_lerp(const float* shadow, int shadow_size, float u, float v,
                         float reference_depth) {
  float texel = 1.0f / shadow_size;
  float fu = u * shadow_size + 0.5f, fv = v * shadow_size + 0.5f;
  float frac_u = fu - std::floor(fu), frac_v = fv - std::floor(fv);
  float cu = std::floor(fu) / shadow_size, cv = std::floor(fv) / shadow_size;
  float lb = is_in_shadow(shadow, shadow_size, cu, cv, reference_depth);
  float lt = is_in_shadow(shadow, shadow_size, cu, cv + texel, reference_depth);
  float rb = is_in_shadow(shadow, shadow_size, cu + texel, cv, reference_depth);
  float rt = is_in_shadow(shadow, shadow_size, cu + texel, cv + texel, reference_depth);
  float a = lb + (lt - lb) * frac_v;
  float b = rb + (rt - rb) * frac_v;
  return a + (b - a) * frac_u;
}

// fragment.glsl getShadow: PCF 3x3 over the lerped lookup.
float get_shadow(const float* shadow, int shadow_size, const Vec4& shadow_pos,
                 float light_dot_normal) {
  if (std::fabs(shadow_pos.w) < 1e-9f) return 0.0f;
  float sx = shadow_pos.x / shadow_pos.w * 0.5f + 0.5f;
  float sy = shadow_pos.y / shadow_pos.w * 0.5f + 0.5f;
  float sz = shadow_pos.z / shadow_pos.w * 0.5f + 0.5f;
  if (sz > 1.0f) return 0.0f;
  float bias = std::max(0.002f * (1.0f - light_dot_normal), 0.001f) / shadow_pos.w;
  float reference_depth = sz - bias;
  float result = 0.0f;
  for (int dx = -1; dx <= 1; ++dx)
    for (int dy = -1; dy <= 1; ++dy)
      result += shadow_lerp(shadow, shadow_size, sx + dx * (1.0f / shadow_size),
                            sy + dy * (1.0f / shadow_size), reference_depth);
  return clampf(result / 9.0f, 0.0f, 1.0f);
}

// ---------------------------------------------------------------- main pass

struct Shading {
  const float* shadow;
  int shadow_size;
  Vec3 light_position;  // (VP * inverse(lightVP) * (0,0,-1,1)).xyz
  Vec3 albedo;
  bool is_floor;
};

// fragment.glsl main(): ambient 0.5 + diffuse 0.5 + specular 0.3 pow20 + rim.
Vec3 shade_fragment(const Shading& sh, const Vec3& normal_in, const Vec3& position,
                    const Vec4& shadow_pos) {
  float nl = std::sqrt(normal_in.x * normal_in.x + normal_in.y * normal_in.y +
                       normal_in.z * normal_in.z);
  Vec3 n{normal_in.x / std::max(nl, 1e-12f), normal_in.y / std::max(nl, 1e-12f),
         normal_in.z / std::max(nl, 1e-12f)};
  float pl = std::sqrt(position.x * position.x + position.y * position.y +
                       position.z * position.z);
  Vec3 view{-position.x / std::max(pl, 1e-12f), -position.y / std::max(pl, 1e-12f),
            -position.z / std::max(pl, 1e-12f)};
  Vec3 l{sh.light_position.x - position.x, sh.light_position.y - position.y,
         sh.light_position.z - position.z};
  float ll = std::sqrt(l.x * l.x + l.y * l.y + l.z * l.z);
  l = {l.x / std::max(ll, 1e-12f), l.y / std::max(ll, 1e-12f), l.z / std::max(ll, 1e-12f)};
  // reflectDirection = -reflect(l, n) = -(l - 2 (l.n) n)
  float ldn = l.x * n.x + l.y * n.y + l.z * n.z;
  Vec3 refl{-(l.x - 2 * ldn * n.x), -(l.y - 2 * ldn * n.y), -(l.z - 2 * ldn * n.z)};
  float light_dot_normal = clampf(ldn, 0.0f, 1.0f);

  float shadow = get_shadow(sh.shadow, sh.shadow_size, shadow_pos, light_dot_normal);
  if (sh.is_floor) {
    // color = mix(vec3(1.0), vec3(0.8) * ambient, shadow); ambient = 0.5
    float v = 1.0f + (0.8f * 0.5f - 1.0f) * shadow;
    return {v, v, v};
  }
  float rim = std::pow(1.0f - clampf(-n.z, 0.0f, 1.0f), 4.0f) * 0.3f;
  float rdv = clampf(refl.x * view.x + refl.y * view.y + refl.z * view.z, 0.0f, 1.0f);
  float spec = 0.3f * std::pow(rdv, 20.0f) * (1.0f - shadow);
  float diff = 0.5f * light_dot_normal * (1.0f - shadow);
  return {sh.albedo.x * (0.5f + diff) + spec + rim,
          sh.albedo.y * (0.5f + diff) + spec + rim,
          sh.albedo.z * (0.5f + diff) + spec + rim};
}

void main_pass(const std::vector<ScreenTri>& tris, const Shading& sh, int size,
               float* zbuf, float* rgb, int n_threads) {
  auto worker = [&](int row_begin, int row_end) {
    for (const ScreenTri& tri : tris) {
      if (!tri.valid) continue;
      int y0 = std::max(row_begin, (int)std::floor(tri.min_y));
      int y1 = std::min(row_end - 1, (int)std::ceil(tri.max_y));
      int x0 = std::max(0, (int)std::floor(tri.min_x));
      int x1 = std::min(size - 1, (int)std::ceil(tri.max_x));
      if (y0 > y1 || x0 > x1) continue;
      float ax = tri.sx[0], ay = tri.sy[0];
      float bx = tri.sx[1], by = tri.sy[1];
      float cx = tri.sx[2], cy = tri.sy[2];
      float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      if (std::fabs(area) < 1e-12f) continue;
      float inv_area = 1.0f / area;
      for (int y = y0; y <= y1; ++y) {
        for (int x = x0; x <= x1; ++x) {
          float px = x + 0.5f, py = y + 0.5f;
          float w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv_area;
          float w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv_area;
          float w2 = 1.0f - w0 - w1;
          if (w0 < 0 || w1 < 0 || w2 < 0) continue;
          float z = w0 * tri.sz[0] + w1 * tri.sz[1] + w2 * tri.sz[2];
          long idx = (long)y * size + x;
          if (z >= zbuf[idx]) continue;
          zbuf[idx] = z;
          // Perspective-correct varyings.
          float iw = w0 * tri.inv_w[0] + w1 * tri.inv_w[1] + w2 * tri.inv_w[2];
          float corr = 1.0f / iw;
          auto interp3 = [&](const Vec3* v) {
            return Vec3{(w0 * v[0].x + w1 * v[1].x + w2 * v[2].x) * corr,
                        (w0 * v[0].y + w1 * v[1].y + w2 * v[2].y) * corr,
                        (w0 * v[0].z + w1 * v[1].z + w2 * v[2].z) * corr};
          };
          Vec3 normal = interp3(tri.normal_over_w);
          Vec3 position = interp3(tri.position_over_w);
          Vec4 shadow_pos{
              (w0 * tri.shadow_over_w[0].x + w1 * tri.shadow_over_w[1].x +
               w2 * tri.shadow_over_w[2].x) * corr,
              (w0 * tri.shadow_over_w[0].y + w1 * tri.shadow_over_w[1].y +
               w2 * tri.shadow_over_w[2].y) * corr,
              (w0 * tri.shadow_over_w[0].z + w1 * tri.shadow_over_w[1].z +
               w2 * tri.shadow_over_w[2].z) * corr,
              (w0 * tri.shadow_over_w[0].w + w1 * tri.shadow_over_w[1].w +
               w2 * tri.shadow_over_w[2].w) * corr};
          Vec3 color = shade_fragment(sh, normal, position, shadow_pos);
          rgb[idx * 3 + 0] = color.x;
          rgb[idx * 3 + 1] = color.y;
          rgb[idx * 3 + 2] = color.z;
        }
      }
    }
  };
  std::vector<std::thread> pool;
  int rows_per = (size + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int rb = i * rows_per, re = std::min(size, rb + rows_per);
    if (rb >= re) break;
    pool.emplace_back(worker, rb, re);
  }
  for (auto& th : pool) th.join();
}

void transform_all(const float* vertices, const float* normals, long n_vertices,
                   const float* camera_vp, const float* light_vp, float y_offset,
                   int size, std::vector<ScreenTri>* out) {
  long n_tris = n_vertices / 3;
  out->clear();
  out->reserve(n_tris);
  ScreenTri buf[2];
  for (long t = 0; t < n_tris; ++t) {
    int produced = transform_triangle(vertices, normals, t * 3, camera_vp,
                                      light_vp, y_offset, size, buf);
    for (int i = 0; i < produced; ++i) out->push_back(buf[i]);
  }
}

inline Vec3 compute_light_position(const float* camera_vp, const float* light_vp_inv) {
  Vec4 p = mat_mul(light_vp_inv, Vec4{0, 0, -1, 1});
  Vec4 q = mat_mul(camera_vp, p);
  return {q.x, q.y, q.z};
}

}  // namespace

extern "C" {

// Render a triangle soup with shadow mapping into an RGB byte image.
//   vertices/normals: [n_vertices, 3] float32 triangle soup (model space)
//   camera_vp/light_vp/light_vp_inv: 4x4 row-major view-projection matrices
//   ground_level: floor plane y (reference yOffset); draw_floor: 0/1
//   albedo/background: RGB in [0,1]
//   out_rgb: [size, size, 3] uint8, row 0 = top
void rasterize_scene(const float* vertices, const float* normals, long n_vertices,
                     const float* camera_vp, const float* light_vp,
                     const float* light_vp_inv, float ground_level, int draw_floor,
                     const float* albedo, const float* background, int size,
                     int shadow_size, unsigned char* out_rgb) {
  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, 16);

  // 1) light-space depth map (mesh only, like the reference's shadow pass).
  std::vector<float> shadow((long)shadow_size * shadow_size);
  depth_pass(vertices, n_vertices, light_vp, shadow_size, shadow.data(), n_threads);

  // 2) camera pass. Depth cleared to 1.0 — fragments beyond the far plane
  // (NDC z > 1) fail the depth test, matching GL's far clip.
  std::vector<float> zbuf((long)size * size, 1.0f);
  std::vector<float> rgb((long)size * size * 3);
  for (long i = 0; i < (long)size * size; ++i) {
    rgb[i * 3 + 0] = background[0];
    rgb[i * 3 + 1] = background[1];
    rgb[i * 3 + 2] = background[2];
  }

  Shading sh;
  sh.shadow = shadow.data();
  sh.shadow_size = shadow_size;
  sh.light_position = compute_light_position(camera_vp, light_vp_inv);
  sh.albedo = {albedo[0], albedo[1], albedo[2]};
  sh.is_floor = false;

  std::vector<ScreenTri> tris;
  transform_all(vertices, normals, n_vertices, camera_vp, light_vp, 0.0f, size, &tris);
  main_pass(tris, sh, size, zbuf.data(), rgb.data(), n_threads);

  if (draw_floor) {
    // The reference floor: a 12x12 quad at y = ground_level
    // (rendering/__init__.py prepare_floor, size 6).
    const float s = 6.0f;
    float floor_vertices[18] = {-s, 0, -s, -s, 0, s, s, 0, s, -s, 0, -s, s, 0, s, s, 0, -s};
    float floor_normals[18] = {0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0};
    sh.is_floor = true;
    std::vector<ScreenTri> floor_tris;
    transform_all(floor_vertices, floor_normals, 6, camera_vp, light_vp,
                  ground_level, size, &floor_tris);
    main_pass(floor_tris, sh, size, zbuf.data(), rgb.data(), n_threads);
  }

  for (long i = 0; i < (long)size * size * 3; ++i) {
    out_rgb[i] = (unsigned char)std::lround(clampf(rgb[i], 0.0f, 1.0f) * 255.0f);
  }
}

}  // extern "C"
