// raytracer_tpu native runtime: scene parser, reference-exact CPU render
// engine, PPM writer, C ABI.
//
// This is the framework's native embedding layer — the analog of the
// reference's Rust core behind its C ABI (/root/reference/raytracer/src/
// lib.rs + cbindgen header).  The renderer re-derives the reference
// algorithm (common.rs:320-361 scanline/sample loops, common.rs:263-285
// bounce loop, materials.rs:30-102 scatter rules, camera.rs, parser.rs
// grammar) in IEEE float32 with the same op order, so in parity mode its
// output is BIT-IDENTICAL to the Python oracle (and therefore to the JAX
// parity renderer) — validated in tests/test_native.py.
//
// Fast mode replaces the sequential xorshift32 stream with the same
// per-(pixel, sample, site) pcg3d counters as the JAX wavefront path and
// parallelizes over rows with std::thread.
//
// Build: see native/Makefile.  MUST be compiled without -ffast-math and
// with -ffp-contract=off (FMA contraction would change parity bits).

#include "raytracer_tpu.h"

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Error reporting
// ---------------------------------------------------------------------------
thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

// ---------------------------------------------------------------------------
// Vec3 (maths.rs:60-95) — float32, exact op order
// ---------------------------------------------------------------------------
struct Vec3 {
  float x, y, z;
};

inline Vec3 v3(float x, float y, float z) { return Vec3{x, y, z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
inline Vec3 operator-(Vec3 a, Vec3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
inline Vec3 operator*(Vec3 a, Vec3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
inline Vec3 operator*(Vec3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
inline Vec3 operator*(float s, Vec3 a) { return v3(a.x * s, a.y * s, a.z * s); }
inline Vec3 operator/(Vec3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
inline Vec3 operator-(Vec3 a) { return v3(-a.x, -a.y, -a.z); }

inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// maths.rs:88-94 — note the negated-subtraction middle component
inline Vec3 cross(Vec3 a, Vec3 b) {
  return v3(a.y * b.z - a.z * b.y, -(a.x * b.z - a.z * b.x),
            a.x * b.y - a.y * b.x);
}

// NVec3::new — divide by sqrt(len^2), no epsilon (maths.rs:111-118)
inline Vec3 normalize(Vec3 a) {
  float len = sqrtf(a.x * a.x + a.y * a.y + a.z * a.z);
  return v3(a.x / len, a.y / len, a.z / len);
}

inline bool near_zero(Vec3 a) {  // maths.rs:46-49
  const float s = 1e-8f;
  return fabsf(a.x) < s && fabsf(a.y) < s && fabsf(a.z) < s;
}

inline Vec3 reflect(Vec3 v, Vec3 n) {  // maths.rs:26-28
  return v - 2.0f * dot(v, n) * n;
}

inline Vec3 refract(Vec3 uv, Vec3 n, float eta) {  // maths.rs:31-36
  float cos_theta = dot(-uv, n);
  Vec3 r_out_perp = eta * (uv + cos_theta * n);
  float para = -sqrtf(fabsf(1.0f - dot(r_out_perp, r_out_perp)));
  Vec3 r_out_parallel = para * n;
  return r_out_perp + r_out_parallel;
}

// ---------------------------------------------------------------------------
// RNG
// ---------------------------------------------------------------------------
struct XorShift32 {  // random.rs:3-31
  uint32_t state;
  explicit XorShift32(uint32_t seed) : state(seed) {}
  uint32_t next() {
    uint32_t x = state;
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    state = x;
    return x;
  }
  float random_f32() {  // [0,1], random.rs:15-17
    return (float)next() / (float)UINT32_MAX;
  }
  float random_bilateral_f32() {  // [-1,1], random.rs:19-21
    return random_f32() * 2.0f - 1.0f;
  }
};

// pcg3d (Jarzynski & Olano) — matches raytracer_tpu/rng.py
inline void pcg3d(uint32_t &x, uint32_t &y, uint32_t &z) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += z * x;
  z += x * y;
}

// top-24-bit mapping — matches rng.random_f32_from_bits24
inline float u01_24(uint32_t bits) {
  return (float)(int32_t)(bits >> 8) * (1.0f / 16777215.0f);
}

// ---------------------------------------------------------------------------
// Scene model
// ---------------------------------------------------------------------------
enum MatKind { DIFFUSE = 0, METAL = 1, DIELECTRIC = 2, EMISSION = 3 };

struct Material {
  int kind = DIFFUSE;
  Vec3 color{0, 0, 0};
  float fuzz = 0.0f;
  float ir = 1.0f;
};

struct Sphere {
  Vec3 center;
  float radius;
  int material;
};

struct Triangle {
  Vec3 v0, v1, v2;
  Vec3 unit_normal;  // Triangle::new (common.rs:116-123)
  int material;
};

struct Camera {  // camera.rs:8-15
  Vec3 origin, lower_left_corner, horizontal, vertical;

  static Camera new_at(Vec3 origin, float aspect_ratio) {  // camera.rs:21-33
    float vh = 2.0f;
    float vw = aspect_ratio * vh;
    float focal = 1.0f;
    Camera c;
    c.origin = origin;
    c.horizontal = v3(vw, 0, 0);
    c.vertical = v3(0, vh, 0);
    c.lower_left_corner = origin - v3(vw / 2.0f, vh / 2.0f, focal);
    return c;
  }

  float aspect_ratio() const {  // camera.rs:70-72
    return horizontal.x / vertical.y;
  }

  void cast_ray(float s, float t, Vec3 &o, Vec3 &d) const {  // camera.rs:84-89
    o = origin;
    d = normalize(lower_left_corner + s * horizontal + t * vertical - origin);
  }
};

struct World {
  Camera camera;
  std::vector<Material> materials;
  std::vector<Sphere> spheres;
  std::vector<Triangle> triangles;
};

// ---------------------------------------------------------------------------
// Parser (parser.rs grammar; port of raytracer_tpu/parser.py)
// ---------------------------------------------------------------------------
struct Cursor {
  const char *p;
  const char *end;
  bool eof() const { return p >= end; }
  size_t remaining() const { return (size_t)(end - p); }
};

void skip_whitespace(Cursor &c) {
  while (!c.eof() && isspace((unsigned char)*c.p)) c.p++;
}

bool starts_with(Cursor &c, const char *kw) {
  size_t n = strlen(kw);
  if (c.remaining() >= n && memcmp(c.p, kw, n) == 0) {
    c.p += n;
    return true;
  }
  return false;
}

std::string get_identifier(Cursor &c) {
  const char *s = c.p;
  while (!c.eof() && (isalnum((unsigned char)*c.p) || *c.p == '_')) c.p++;
  return std::string(s, c.p);
}

bool parse_float(Cursor &c, float &out) {  // parser.rs:107-133 quirks
  if (c.remaining() < 3) return false;     // parser.rs:112-114
  const char *s = c.p;
  const char *q = c.p;
  if (*q == '-') q++;
  bool found_dot = false;
  while (q < c.end) {
    if (*q >= '0' && *q <= '9') {
      q++;
    } else if (*q == '.') {
      if (found_dot) return false;
      found_dot = true;
      q++;
    } else {
      break;
    }
  }
  if (q == s || (q == s + 1 && *s == '-')) return false;
  out = strtof(std::string(s, q).c_str(), nullptr);
  c.p = q;
  return true;
}

bool parse_vec3(Cursor &c, Vec3 &out) {  // parser.rs:135-142
  if (!parse_float(c, out.x)) return false;
  skip_whitespace(c);
  if (!parse_float(c, out.y)) return false;
  skip_whitespace(c);
  if (!parse_float(c, out.z)) return false;
  return true;
}

bool skip_comment(Cursor &c) {  // parser.rs:313-323
  while (c.remaining() >= 2 && c.p[0] == '/' && c.p[1] == '/') {
    const char *nl = (const char *)memchr(c.p, '\n', c.remaining());
    if (!nl) {
      set_error("WrongSyntax: comment without newline");
      return false;
    }
    c.p = nl + 1;
  }
  return true;
}

int find_material(const std::vector<std::string> &names, const std::string &n) {
  for (size_t i = 0; i < names.size(); i++)
    if (names[i] == n) return (int)i;
  return -1;
}

bool parse_input(const char *src, size_t len, World &world) {
  // NUL-terminated sources end at the NUL (lib.rs:38-40)
  const char *nul = (const char *)memchr(src, '\0', len);
  Cursor c{src, nul ? nul : src + len};
  std::vector<std::string> names;

  if (!skip_comment(c)) return false;
  // camera (parser.rs:145-167) — strict first (parser.rs:343-350)
  if (!starts_with(c, "camera")) {
    set_error("MissingCamera");
    return false;
  }
  skip_whitespace(c);
  if (!starts_with(c, "origin")) { set_error("DidntStartWith: origin"); return false; }
  skip_whitespace(c);
  Vec3 cam_origin;
  if (!parse_vec3(c, cam_origin)) { set_error("NotAF32: camera origin"); return false; }
  skip_whitespace(c);
  if (!starts_with(c, "aspect")) { set_error("DidntStartWith: aspect"); return false; }
  skip_whitespace(c);
  float aspect;
  if (!parse_float(c, aspect)) { set_error("NotAF32: aspect"); return false; }
  skip_whitespace(c);
  if (!starts_with(c, ";")) { set_error("DidntStartWith: ;"); return false; }
  world.camera = Camera::new_at(cam_origin, aspect);
  skip_whitespace(c);

  if (!skip_comment(c)) return false;
  // materials (parser.rs:175-234 + Emission extension)
  while (starts_with(c, "material")) {
    skip_whitespace(c);
    std::string name = get_identifier(c);
    skip_whitespace(c);
    if (!starts_with(c, ":")) { set_error("DidntStartWith: :"); return false; }
    skip_whitespace(c);
    Material m;
    if (starts_with(c, "Diffuse") ||
        (c.remaining() >= 8 && memcmp(c.p, "Emission", 8) == 0 &&
         (c.p += 8, m.kind = EMISSION, true))) {
      if (m.kind != EMISSION) m.kind = DIFFUSE;
      skip_whitespace(c);
      if (!starts_with(c, "color")) { set_error("DidntStartWith: color"); return false; }
      skip_whitespace(c);
      if (!parse_vec3(c, m.color)) { set_error("NotAF32: color"); return false; }
      skip_whitespace(c);
      if (!starts_with(c, ";")) { set_error("DidntStartWith: ;"); return false; }
    } else if (starts_with(c, "Metal")) {
      m.kind = METAL;
      skip_whitespace(c);
      if (!starts_with(c, "color")) { set_error("DidntStartWith: color"); return false; }
      skip_whitespace(c);
      if (!parse_vec3(c, m.color)) { set_error("NotAF32: color"); return false; }
      skip_whitespace(c);
      if (!starts_with(c, "fuzz")) { set_error("DidntStartWith: fuzz"); return false; }
      skip_whitespace(c);
      if (!parse_float(c, m.fuzz)) { set_error("NotAF32: fuzz"); return false; }
      skip_whitespace(c);
      if (!starts_with(c, ";")) { set_error("DidntStartWith: ;"); return false; }
    } else if (starts_with(c, "Dielectric")) {
      m.kind = DIELECTRIC;
      skip_whitespace(c);
      if (!starts_with(c, "ir")) { set_error("DidntStartWith: ir"); return false; }
      skip_whitespace(c);
      if (!parse_float(c, m.ir)) { set_error("NotAF32: ir"); return false; }
      skip_whitespace(c);
      if (!starts_with(c, ";")) { set_error("DidntStartWith: ;"); return false; }
    } else {
      set_error("WrongSyntax: unknown material type");
      return false;
    }
    names.push_back(name);
    world.materials.push_back(m);
    skip_whitespace(c);
    if (!skip_comment(c)) return false;
  }

  // spheres (parser.rs:237-269)
  while (starts_with(c, "sphere")) {
    Sphere s;
    skip_whitespace(c);
    if (!starts_with(c, "center")) { set_error("DidntStartWith: center"); return false; }
    skip_whitespace(c);
    if (!parse_vec3(c, s.center)) { set_error("NotAF32: center"); return false; }
    skip_whitespace(c);
    if (!starts_with(c, "radius")) { set_error("DidntStartWith: radius"); return false; }
    skip_whitespace(c);
    if (!parse_float(c, s.radius)) { set_error("NotAF32: radius"); return false; }
    skip_whitespace(c);
    if (!starts_with(c, "material")) { set_error("DidntStartWith: material"); return false; }
    skip_whitespace(c);
    std::string mn = get_identifier(c);
    skip_whitespace(c);
    if (!starts_with(c, ";")) { set_error("DidntStartWith: ;"); return false; }
    s.material = find_material(names, mn);
    if (s.material < 0) { set_error("WrongSyntax: unknown material " + mn); return false; }
    world.spheres.push_back(s);
    skip_whitespace(c);
    if (!skip_comment(c)) return false;
  }

  // triangles (parser.rs:272-310)
  while (starts_with(c, "triangle")) {
    Triangle t;
    const char *labels[3] = {"v0", "v1", "v2"};
    Vec3 *vs[3] = {&t.v0, &t.v1, &t.v2};
    for (int i = 0; i < 3; i++) {
      skip_whitespace(c);
      if (!starts_with(c, labels[i])) { set_error("DidntStartWith: v"); return false; }
      skip_whitespace(c);
      if (!parse_vec3(c, *vs[i])) { set_error("NotAF32: vertex"); return false; }
    }
    skip_whitespace(c);
    if (!starts_with(c, "material")) { set_error("DidntStartWith: material"); return false; }
    skip_whitespace(c);
    std::string mn = get_identifier(c);
    skip_whitespace(c);
    if (!starts_with(c, ";")) { set_error("DidntStartWith: ;"); return false; }
    t.material = find_material(names, mn);
    if (t.material < 0) { set_error("WrongSyntax: unknown material " + mn); return false; }
    t.unit_normal = normalize(cross(t.v1 - t.v0, t.v2 - t.v0));
    world.triangles.push_back(t);
    skip_whitespace(c);
    if (!skip_comment(c)) return false;
  }

  if (!c.eof()) {
    set_error(std::string("WrongSyntax: trailing input near '") +
              std::string(c.p, std::min<size_t>(16, c.remaining())) + "'");
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Intersection (common.rs:60-166, 237-258)
// ---------------------------------------------------------------------------
struct Hit {
  float t;
  Vec3 position;
  Vec3 normal;
  const Material *material;
};

bool sphere_hit(const Sphere &s, const Material *mats, Vec3 o, Vec3 d,
                float t_min, float t_max, Hit &out) {
  // half-b quadratic, a == 1 exactly (NVec3 length_squared hardcoded,
  // maths.rs:127-128)
  Vec3 oc = o - s.center;
  float half_b = dot(oc, d);
  float cc = dot(oc, oc) - s.radius * s.radius;
  float disc = half_b * half_b - cc;
  if (disc < 0.0f) return false;
  float sq = sqrtf(disc);
  float root1 = -half_b - sq;
  float root2 = -half_b + sq;
  float t;
  if (t_min < root1 && root1 < t_max) {
    t = root1;
  } else if (t_min < root2 && root2 < t_max) {
    t = root2;
  } else {
    return false;
  }
  out.t = t;
  out.position = o + d * t;
  out.normal = normalize((out.position - s.center) / s.radius);
  out.material = &mats[s.material];
  return true;
}

bool triangle_hit(const Triangle &tr, const Material *mats, Vec3 o, Vec3 d,
                  float t_min, float t_max, bool parity_sign, Hit &out) {
  Vec3 a = tr.v1 - tr.v0;
  Vec3 b = tr.v2 - tr.v0;
  Vec3 n = cross(a, b);  // NOT normalized (common.rs:131-133)
  float cos_al = dot(n, d);
  if (-1e-8f < cos_al && cos_al < 1e-8f) return false;  // parallel
  float dd = dot(n, tr.v0);
  // the reference's plane-equation sign quirk (common.rs:140-141)
  float t = parity_sign ? (dot(n, o) + dd) / cos_al : (dd - dot(n, o)) / cos_al;
  if (t < t_min || t > t_max) return false;  // non-strict accept at t_max
  Vec3 p = o + d * t;
  if (dot(n, cross(tr.v1 - tr.v0, p - tr.v0)) < 0.0f) return false;
  if (dot(n, cross(tr.v2 - tr.v1, p - tr.v1)) < 0.0f) return false;
  if (dot(n, cross(tr.v0 - tr.v2, p - tr.v2)) < 0.0f) return false;
  out.t = t;
  out.position = p;
  out.normal = tr.unit_normal;
  out.material = &mats[tr.material];
  return true;
}

bool world_hit(const World &w, Vec3 o, Vec3 d, bool parity_sign, Hit &out) {
  // common.rs:237-258: spheres then mesh, running closest, t_min 0.001
  float closest = INFINITY;
  bool found = false;
  Hit h;
  for (const Sphere &s : w.spheres) {
    if (sphere_hit(s, w.materials.data(), o, d, 0.001f, closest, h)) {
      closest = h.t;
      out = h;
      found = true;
    }
  }
  // Mesh::hit: strict < within the mesh, <= vs the sphere bound
  float mesh_closest = INFINITY;
  for (const Triangle &tr : w.triangles) {
    if (triangle_hit(tr, w.materials.data(), o, d, 0.001f, closest,
                     parity_sign, h) &&
        h.t < mesh_closest) {
      mesh_closest = h.t;
      out = h;
      found = true;
    }
  }
  return found;
}

// ---------------------------------------------------------------------------
// Shading (materials.rs:30-102) + ray_color (common.rs:263-285)
// ---------------------------------------------------------------------------
template <typename RandUnitFn>
Vec3 ray_color(const World &w, Vec3 o, Vec3 d, int depth, bool parity_sign,
               RandUnitFn &&rand_unit) {
  Vec3 final_color = v3(1, 1, 1);
  for (int bounce = 0; bounce < depth; bounce++) {
    Hit hit;
    if (world_hit(w, o, d, parity_sign, hit)) {
      const Material &m = *hit.material;
      switch (m.kind) {
        case DIFFUSE: {  // materials.rs:42-52
          Vec3 scatter = hit.normal + rand_unit(bounce);
          Vec3 nd = near_zero(scatter) ? hit.normal : normalize(scatter);
          final_color = final_color * m.color;
          o = hit.position;
          d = nd;
          break;
        }
        case METAL: {  // materials.rs:54-63 (fuzz draw always consumed)
          Vec3 reflected = reflect(d, hit.normal);
          Vec3 dir = reflected + m.fuzz * rand_unit(bounce);
          if (dot(dir, hit.normal) >= 0.0f) {
            final_color = final_color * m.color;
            o = hit.position;
            d = normalize(dir);
          } else {
            return final_color * m.color;  // absorbed -> terminal
          }
          break;
        }
        case DIELECTRIC: {  // materials.rs:65-97: always refracts
          Vec3 n;
          float ratio;
          if (dot(d, hit.normal) >= 0.0f) {
            n = -hit.normal;
            ratio = 1.0f / m.ir;
          } else {
            n = hit.normal;
            ratio = m.ir;
          }
          Vec3 refr = refract(d, n, ratio);
          // color is white: throughput unchanged
          o = hit.position;
          d = normalize(refr);
          break;
        }
        case EMISSION:  // materials.rs:100-102: terminal
        default:
          return final_color * m.color;
      }
    } else {
      // sky lerp (common.rs:277-280)
      float t = 0.5f * (normalize(d).y + 1.0f);
      Vec3 sky = v3(1, 1, 1) * (1.0f - t) + v3(0.5f, 0.7f, 1.0f) * t;
      return final_color * sky;
    }
  }
  return v3(0, 0, 0);  // bounce-exhausted -> black (common.rs:284)
}

// ---------------------------------------------------------------------------
// Render loops
// ---------------------------------------------------------------------------
inline RtColorU8 finalize_pixel(Vec3 acc, int spp) {
  // common.rs:343-356: mean, sqrt gamma, x255.999, truncating u8 cast
  float inv = 1.0f / (float)spp;
  float r = sqrtf(acc.x * inv) * 255.999f;
  float g = sqrtf(acc.y * inv) * 255.999f;
  float b = sqrtf(acc.z * inv) * 255.999f;
  auto clamp = [](float v) -> uint8_t {
    if (!(v > 0.0f)) return 0;
    if (v > 255.0f) return 255;
    return (uint8_t)v;
  };
  return RtColorU8{clamp(r), clamp(g), clamp(b), 255};
}

void render_parity(const World &w, RtFramebuffer &fb, int spp, int depth,
                   uint32_t seed) {
  // exact reference loop: ONE sequential stream in raster order
  // (common.rs:320-361)
  XorShift32 rng(seed);
  size_t width = fb.width, height = fb.height;
  for (size_t row = 0; row < height; row++) {
    for (size_t col = 0; col < width; col++) {
      Vec3 acc = v3(0, 0, 0);
      for (int s = 0; s < spp; s++) {
        float u = ((float)col + rng.random_f32()) / (float)(width - 1);
        float v = ((float)row + rng.random_f32()) / (float)(height - 1);
        Vec3 o, d;
        w.camera.cast_ray(u, v, o, d);
        auto rand_unit = [&rng](int) {
          float x = rng.random_bilateral_f32();
          float y = rng.random_bilateral_f32();
          float z = rng.random_bilateral_f32();
          return normalize(v3(x, y, z));
        };
        acc = acc + ray_color(w, o, d, depth, /*parity_sign=*/true, rand_unit);
      }
      fb.pixels[(height - row - 1) * width + col] = finalize_pixel(acc, spp);
    }
  }
}

void render_fast(const World &w, RtFramebuffer &fb, int spp, int depth,
                 uint32_t seed, int num_threads) {
  // counter-based streams (pcg3d, matching the JAX wavefront path),
  // thread-parallel over rows
  size_t width = fb.width, height = fb.height;
  uint32_t seed_word = seed * 0x85EBCA6Bu;
  if (num_threads <= 0) {
    num_threads = (int)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 1;
  }
  std::atomic<size_t> next_row{0};

  auto worker = [&]() {
    for (;;) {
      size_t row = next_row.fetch_add(1);
      if (row >= height) return;
      for (size_t col = 0; col < width; col++) {
        uint32_t pix = (uint32_t)(row * width + col) + seed_word;
        Vec3 acc = v3(0, 0, 0);
        for (int s = 0; s < spp; s++) {
          uint32_t jx = pix, jy = (uint32_t)s, jz = 0;
          pcg3d(jx, jy, jz);
          float u = ((float)col + u01_24(jx)) / (float)(width - 1);
          float v = ((float)row + u01_24(jy)) / (float)(height - 1);
          Vec3 o, d;
          w.camera.cast_ray(u, v, o, d);
          auto rand_unit = [pix, s](int bounce) {
            uint32_t x = pix, y = (uint32_t)s, z = 1u + (uint32_t)bounce;
            pcg3d(x, y, z);
            float bx = u01_24(x) * 2.0f - 1.0f;
            float by = u01_24(y) * 2.0f - 1.0f;
            float bz = u01_24(z) * 2.0f - 1.0f;
            return normalize(v3(bx, by, bz));
          };
          acc = acc + ray_color(w, o, d, depth, true, rand_unit);
        }
        fb.pixels[(height - row - 1) * width + col] = finalize_pixel(acc, spp);
      }
    }
  };

  std::vector<std::thread> pool;
  for (int i = 1; i < num_threads; i++) pool.emplace_back(worker);
  worker();
  for (auto &t : pool) t.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
struct RtWorldHandle {
  World world;
};

extern "C" {

RtWorldHandle *rt_load_world_n(const char *source, size_t len) {
  g_last_error.clear();
  auto *h = new RtWorldHandle();
  if (!parse_input(source, len, h->world)) {
    delete h;
    return nullptr;
  }
  return h;
}

RtWorldHandle *rt_load_world(const char *source) {
  return rt_load_world_n(source, strlen(source));
}

void rt_destroy_world(RtWorldHandle *world) { delete world; }

int rt_render(RtFramebuffer framebuffer, const RtWorldHandle *world,
              const RtRenderOptions *options) {
  g_last_error.clear();
  if (!world || !framebuffer.pixels || framebuffer.width == 0 ||
      framebuffer.height == 0) {
    set_error("invalid framebuffer or world");
    return 1;
  }
  RtRenderOptions opts;  // reference FFI defaults (lib.rs:51)
  opts.samples_per_pixel = 16;
  opts.max_ray_bounces = 8;
  opts.seed = 0;
  opts.parity = 1;
  opts.num_threads = 0;
  if (options) opts = *options;
  uint32_t seed = opts.seed ? opts.seed : 2547549u;  // random.rs:9
  if (opts.parity) {
    render_parity(world->world, framebuffer, opts.samples_per_pixel,
                  opts.max_ray_bounces, seed);
  } else {
    render_fast(world->world, framebuffer, opts.samples_per_pixel,
                opts.max_ray_bounces, seed, opts.num_threads);
  }
  return 0;
}

void rt_move_camera_position(RtWorldHandle *world, float x, float y, float z) {
  // lib.rs:60-63: new_at camera at offset origin, same aspect ratio
  Camera &c = world->world.camera;
  c = Camera::new_at(c.origin + v3(x, y, z), c.aspect_ratio());
}

void rt_camera_position(const RtWorldHandle *world, float out_xyz[3]) {
  out_xyz[0] = world->world.camera.origin.x;
  out_xyz[1] = world->world.camera.origin.y;
  out_xyz[2] = world->world.camera.origin.z;
}

int rt_write_ppm(const RtFramebuffer *fb, const char *path) {
  g_last_error.clear();
  FILE *f = path ? fopen(path, "w") : stdout;
  if (!f) {
    set_error(std::string("CouldntOpenFile: ") + (path ? path : "stdout"));
    return 1;
  }
  // image.rs:59-81: header + one "r g b" triplet per line
  fprintf(f, "P3\n%zu %zu\n255\n", fb->width, fb->height);
  for (size_t row = 0; row < fb->height; row++) {
    for (size_t col = 0; col < fb->width; col++) {
      RtColorU8 p = fb->pixels[row * fb->width + col];
      fprintf(f, "%u %u %u\n", p.r, p.g, p.b);
    }
  }
  if (path) fclose(f);
  return 0;
}

const char *rt_last_error(void) { return g_last_error.c_str(); }

const char *rt_version(void) { return "raytracer_tpu-native 0.1.0"; }

}  // extern "C"
