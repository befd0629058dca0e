// oracle — standalone CPU ray tracer used as the correctness + speed
// baseline for the JAX framework.
//
// This is a from-scratch implementation of the algorithm of the serial
// reference tracer (see SURVEY.md §3.1): uniform-grid acceleration with
// 3D-DDA traversal, Cramer's-rule ray/triangle intersection with double
// precision determinants, Blinn-Phong shading with one point light and a
// shadow ray, binary PPM output.  It intentionally reproduces the
// reference's quirks so golden-image tests pin them down:
//   * primary hits accept ANY t (including t < 0) — the nearest-hit
//     update has no lower bound when use_eps is off;
//   * "hit something" is true whenever a barycentric test passes, even
//     if the nearest-hit record was not updated;
//   * the shadow ray points AWAY from the light (dir = -(light - poi))
//     and uses use_eps gating with eps = 0.1;
//   * normals are the unnormalized (v0-v1) x (v2-v0); the half-vector
//     is unnormalized v + l; shadow scales (spec+diff) by 0.1 before
//     ambient is added; PPM clamp is min(1, c/255)*255 truncated.
//
// Data layout is struct-of-arrays (not per-triangle heap objects), and
// the grid is CSR, matching the JAX framework's layout so the two
// implementations are structurally comparable.
//
// Usage:
//   oracle --width 512 --height 512 --out img.ppm \
//          [--float-out img.f32] [--repeat N] [--camera px,py,pz] \
//          [--fov 45] [--light lx,ly,lz] \
//          --mesh path[:ox,oy,oz[:scale]] [--mesh ...]

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <limits>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr float kShadowEps = 1e-1f;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct V3 {
  float x = 0, y = 0, z = 0;
};

static inline V3 v3(float x, float y, float z) { return V3{x, y, z}; }
static inline V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
static inline V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
static inline V3 mul(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
static inline V3 had(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
static inline V3 norm(V3 a) {
  float n2 = dot(a, a);
  if (n2 > 0) {
    float inv = 1.0f / std::sqrt(n2);
    return mul(a, inv);
  }
  return a;
}

static inline double det3(double a1, double a2, double a3, double b1, double b2,
                          double b3, double c1, double c2, double c3) {
  double t1 = a1 * (b2 * c3 - b3 * c2);
  double t2 = a2 * (b1 * c3 - b3 * c1);
  double t3 = a3 * (b1 * c2 - b2 * c1);
  return t1 - t2 + t3;
}

// --------------------------------------------------------------------------
// Scene: SoA triangle soup
// --------------------------------------------------------------------------

struct TriSoup {
  std::vector<V3> a, b, c;  // per-triangle vertices
  std::vector<int32_t> mat;  // per-triangle material index (parallel variant)
  size_t size() const { return a.size(); }
};

bool LoadObj(const std::string& path, V3 offset, float scale, int mat_index,
             TriSoup* out) {
  std::ifstream in(path);
  if (!in) return false;
  std::vector<V3> verts;
  std::string line;
  while (std::getline(in, line)) {
    std::istringstream ss(line);
    std::string tag;
    ss >> tag;
    if (tag == "v") {
      double x, y, z;
      ss >> x >> y >> z;
      verts.push_back(v3(float(scale * (x + offset.x)),
                         float(scale * (y + offset.y)),
                         float(scale * (z + offset.z))));
    } else if (tag == "f") {
      int idx[3];
      for (int k = 0; k < 3; ++k) {
        std::string fv;
        ss >> fv;
        idx[k] = std::atoi(fv.c_str());  // stops at '/'
      }
      out->a.push_back(verts[idx[0] - 1]);
      out->b.push_back(verts[idx[1] - 1]);
      out->c.push_back(verts[idx[2] - 1]);
      out->mat.push_back(mat_index);
    }
  }
  return true;
}

// --------------------------------------------------------------------------
// Uniform grid, CSR layout
// --------------------------------------------------------------------------

struct Grid {
  V3 lo, hi;
  int n[3] = {1, 1, 1};
  float width[3] = {0, 0, 0};
  float inv_width[3] = {0, 0, 0};
  std::vector<int64_t> cell_start;  // n[0]*n[1]*n[2] + 1
  std::vector<int32_t> tri_ids;
};

static inline int iclamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

static inline int PosToVoxel(const Grid& g, float p, int axis) {
  float lo = axis == 0 ? g.lo.x : (axis == 1 ? g.lo.y : g.lo.z);
  int v = int((p - lo) * g.inv_width[axis]);
  return iclamp(v, 0, g.n[axis] - 1);
}

void BuildGrid(const TriSoup& tris, Grid* g) {
  g->lo = v3(kInf, kInf, kInf);
  g->hi = v3(-kInf, -kInf, -kInf);
  for (size_t i = 0; i < tris.size(); ++i) {
    for (const V3* p : {&tris.a[i], &tris.b[i], &tris.c[i]}) {
      g->lo.x = std::min(g->lo.x, p->x); g->hi.x = std::max(g->hi.x, p->x);
      g->lo.y = std::min(g->lo.y, p->y); g->hi.y = std::max(g->hi.y, p->y);
      g->lo.z = std::min(g->lo.z, p->z); g->hi.z = std::max(g->hi.z, p->z);
    }
  }
  float delta[3] = {g->hi.x - g->lo.x, g->hi.y - g->lo.y, g->hi.z - g->lo.z};
  int axis = delta[0] > delta[1] ? 0 : 1;
  if (axis == 1) axis = delta[1] > delta[2] ? 1 : 2;
  else axis = delta[0] > delta[2] ? 0 : 2;
  float vpud = 3.0f * std::pow(float(tris.size()), 1.0f / 3.0f) / delta[axis];
  for (int k = 0; k < 3; ++k) {
    g->n[k] = iclamp(int(delta[k] * vpud + 1), 1, 64);
    g->width[k] = delta[k] / g->n[k];
    g->inv_width[k] = g->width[k] == 0.f ? 0.f : 1.f / g->width[k];
  }

  const int64_t total = int64_t(g->n[0]) * g->n[1] * g->n[2];
  std::vector<int64_t> counts(total, 0);
  auto cell_of = [&](int x, int y, int z) {
    return int64_t(z) * g->n[0] * g->n[1] + int64_t(y) * g->n[0] + x;
  };
  auto tri_range = [&](size_t i, int vmin[3], int vmax[3]) {
    V3 lo = v3(std::min({tris.a[i].x, tris.b[i].x, tris.c[i].x}),
               std::min({tris.a[i].y, tris.b[i].y, tris.c[i].y}),
               std::min({tris.a[i].z, tris.b[i].z, tris.c[i].z}));
    V3 hi = v3(std::max({tris.a[i].x, tris.b[i].x, tris.c[i].x}),
               std::max({tris.a[i].y, tris.b[i].y, tris.c[i].y}),
               std::max({tris.a[i].z, tris.b[i].z, tris.c[i].z}));
    float lof[3] = {lo.x, lo.y, lo.z}, hif[3] = {hi.x, hi.y, hi.z};
    for (int k = 0; k < 3; ++k) {
      vmin[k] = PosToVoxel(*g, lof[k], k);
      vmax[k] = PosToVoxel(*g, hif[k], k);
    }
  };
  // pass 1: counts
  for (size_t i = 0; i < tris.size(); ++i) {
    int vmin[3], vmax[3];
    tri_range(i, vmin, vmax);
    for (int x = vmin[0]; x <= vmax[0]; ++x)
      for (int y = vmin[1]; y <= vmax[1]; ++y)
        for (int z = vmin[2]; z <= vmax[2]; ++z) counts[cell_of(x, y, z)]++;
  }
  g->cell_start.assign(total + 1, 0);
  for (int64_t i = 0; i < total; ++i) g->cell_start[i + 1] = g->cell_start[i] + counts[i];
  // pass 2: fill (ascending triangle order within each cell)
  g->tri_ids.resize(g->cell_start[total]);
  std::vector<int64_t> cursor(g->cell_start.begin(), g->cell_start.end() - 1);
  for (size_t i = 0; i < tris.size(); ++i) {
    int vmin[3], vmax[3];
    tri_range(i, vmin, vmax);
    for (int x = vmin[0]; x <= vmax[0]; ++x)
      for (int y = vmin[1]; y <= vmax[1]; ++y)
        for (int z = vmin[2]; z <= vmax[2]; ++z)
          g->tri_ids[cursor[cell_of(x, y, z)]++] = int32_t(i);
  }
}

// --------------------------------------------------------------------------
// Traversal with the reference's faithful hit semantics
// --------------------------------------------------------------------------

struct HitState {
  float t_min = kInf;   // float running min, like the reference's global_t
  int32_t tri = -1;
  bool any_pass = false;
};

// Test one triangle; updates state.  use_gate gates the t-update only
// (serial shadow rays: gate = kShadowEps, geometry.h:166-167; the CUDA
// variant gates t > 1e-4 always, Parallel/geometry.cuh:155-161).
static inline void TestTri(const TriSoup& tris, int32_t i, V3 o, V3 d,
                           bool use_gate, double gate, HitState* st) {
  const V3 A = tris.a[i], B = tris.b[i], C = tris.c[i];
  double det_a = det3(A.x - B.x, A.x - C.x, d.x,
                      A.y - B.y, A.y - C.y, d.y,
                      A.z - B.z, A.z - C.z, d.z);
  double t = det3(A.x - B.x, A.x - C.x, A.x - o.x,
                  A.y - B.y, A.y - C.y, A.y - o.y,
                  A.z - B.z, A.z - C.z, A.z - o.z) / det_a;
  double beta = det3(A.x - o.x, A.x - C.x, d.x,
                     A.y - o.y, A.y - C.y, d.y,
                     A.z - o.z, A.z - C.z, d.z) / det_a;
  double gamma = det3(A.x - B.x, A.x - o.x, d.x,
                      A.y - B.y, A.y - o.y, d.y,
                      A.z - B.z, A.z - o.z, d.z) / det_a;
  if (beta > 0 && gamma > 0 && beta + gamma < 1) {
    st->any_pass = true;
    if (t < double(st->t_min) && (!use_gate || t > gate)) {
      st->t_min = float(t);
      st->tri = i;
    }
  }
}

// Slab test starting from [mint, maxt]; returns entry t in *t0.
static bool SlabIntersect(const Grid& g, V3 o, V3 d, float mint, float maxt,
                          float* t_entry) {
  float t0 = mint, t1 = maxt;
  float lob[3] = {g.lo.x, g.lo.y, g.lo.z};
  float hib[3] = {g.hi.x, g.hi.y, g.hi.z};
  float of[3] = {o.x, o.y, o.z}, df[3] = {d.x, d.y, d.z};
  for (int k = 0; k < 3; ++k) {
    float inv = 1.0f / df[k];
    float tn = (lob[k] - of[k]) * inv;
    float tf = (hib[k] - of[k]) * inv;
    if (tn > tf) std::swap(tn, tf);
    t0 = tn > t0 ? tn : t0;
    t1 = tf < t1 ? tf : t1;
    if (t0 > t1) return false;
  }
  *t_entry = t0;
  return true;
}

HitState Traverse(const TriSoup& tris, const Grid& g, V3 o, V3 d, float mint,
                  float maxt, bool use_gate, double gate = double(kShadowEps)) {
  HitState st;
  V3 at_min = add(o, mul(d, mint));
  bool inside = at_min.x >= g.lo.x && at_min.x <= g.hi.x &&
                at_min.y >= g.lo.y && at_min.y <= g.hi.y &&
                at_min.z >= g.lo.z && at_min.z <= g.hi.z;
  float ray_t;
  if (inside) ray_t = mint;
  else if (!SlabIntersect(g, o, d, mint, maxt, &ray_t)) return st;

  V3 gi = add(o, mul(d, ray_t));
  float gif[3] = {gi.x, gi.y, gi.z};
  float lof[3] = {g.lo.x, g.lo.y, g.lo.z};
  float df[3] = {d.x, d.y, d.z};

  float next_cross[3], delta[3];
  int pos[3], step[3], out[3];
  for (int k = 0; k < 3; ++k) {
    pos[k] = PosToVoxel(g, gif[k], k);
    if (df[k] >= 0) {
      next_cross[k] = ray_t + (lof[k] + (pos[k] + 1) * g.width[k] - gif[k]) / df[k];
      delta[k] = g.width[k] / df[k];
      step[k] = 1;
      out[k] = g.n[k];
    } else {
      next_cross[k] = ray_t + (lof[k] + pos[k] * g.width[k] - gif[k]) / df[k];
      delta[k] = -g.width[k] / df[k];
      step[k] = -1;
      out[k] = -1;
    }
  }

  static const int kCmpToAxis[8] = {2, 1, 2, 1, 2, 2, 0, 0};
  for (;;) {
    int64_t cell = int64_t(pos[2]) * g.n[0] * g.n[1] + int64_t(pos[1]) * g.n[0] + pos[0];
    for (int64_t j = g.cell_start[cell]; j < g.cell_start[cell + 1]; ++j)
      TestTri(tris, g.tri_ids[j], o, d, use_gate, gate, &st);

    int bits = ((next_cross[0] < next_cross[1]) << 2) +
               ((next_cross[0] < next_cross[2]) << 1) +
               (next_cross[1] < next_cross[2]);
    int axis = kCmpToAxis[bits];
    if (maxt < next_cross[axis]) break;
    pos[axis] += step[axis];
    if (pos[axis] == out[axis]) break;
    next_cross[axis] += delta[axis];
  }
  return st;
}

// --------------------------------------------------------------------------
// Serial-reference shading
// --------------------------------------------------------------------------

struct ShadeParams {
  V3 base_color = v3(255, 0, 0);
  float kd = 2.0f;
  float ks = 5.0e11f;
  float ka = 0.2f;
  float spec_alpha = 4.0f;
  V3 light_pos = v3(5, -5, 2);
  float light_intensity = 255.0f;
  float shadow_scale = 0.1f;
};

V3 TracePixel(const TriSoup& tris, const Grid& g, V3 o, V3 d,
              const ShadeParams& sp) {
  HitState hit = Traverse(tris, g, o, d, /*mint=*/0.f, kInf, /*use_eps=*/false);
  if (!hit.any_pass) return v3(0, 0, 0);

  V3 A = tris.a[hit.tri], B = tris.b[hit.tri], C = tris.c[hit.tri];
  V3 poi = add(o, mul(d, hit.t_min));
  V3 view = norm(mul(d, -1.f));
  V3 l = norm(sub(sp.light_pos, poi));
  V3 h = add(view, l);                    // unnormalized half vector
  V3 n = cross(sub(A, B), sub(C, A));     // unnormalized getNormalMod

  float ndl = std::max(0.f, dot(n, l));
  float ndh = std::max(0.f, dot(n, h));
  V3 diffuse = mul(mul(sp.base_color, sp.kd * ndl), sp.light_intensity);
  V3 specular =
      mul(mul(sp.base_color, sp.ks * std::pow(ndh, sp.spec_alpha)), sp.light_intensity);
  V3 ambient = mul(sp.base_color, sp.ka);
  V3 color = add(specular, diffuse);

  V3 shadow_dir = norm(mul(sub(sp.light_pos, poi), -1.f));  // AWAY from light
  HitState sh = Traverse(tris, g, poi, shadow_dir, kShadowEps, kInf, /*use_gate=*/true);
  if (sh.any_pass) color = mul(color, sp.shadow_scale);
  return add(color, ambient);
}

// --------------------------------------------------------------------------
// Parallel-reference (CUDA variant) shading: material table, shadow ray
// toward the light halving the color, recursive mirror reflection
// (Parallel/raytracer.cu:445-524, materials :449-453, reflect :875-878)
// --------------------------------------------------------------------------

constexpr float kParEps = 1e-4f;
constexpr int kReflectDepth = 3;

struct Material {
  V3 base;
  float kd, ks, spec_alpha, ka, km;
  bool reflective;
};

// The 4-entry palette the CUDA kernel rebuilds inside every shading call.
static const Material kParMaterials[4] = {
    {v3(0, 0, 255), 1.f, 1.5f, 1.25f, 0.3f, 0.6f, true},
    {v3(255, 0, 0), 10.f, 10.f, 1.25f, 0.3f, 0.f, false},
    {v3(0, 20, 0), 10.f, 10.f, 1.25f, 0.3f, 0.9999f, true},
    {v3(255, 0, 0), 10.f, 10.f, 1.25f, 0.3f, 0.f, false},
};

V3 ParallelTrace(const TriSoup& tris, const Grid& g, V3 o, V3 d, V3 light,
                 int depth) {
  HitState hit =
      Traverse(tris, g, o, d, /*mint=*/0.f, kInf, /*use_gate=*/true, kParEps);
  if (hit.tri < 0) return v3(0, 0, 0);

  const Material& m = kParMaterials[tris.mat[hit.tri] & 3];
  V3 A = tris.a[hit.tri], B = tris.b[hit.tri], C = tris.c[hit.tri];
  V3 poi = add(o, mul(d, hit.t_min));
  V3 view = norm(mul(d, -1.f));
  V3 l = norm(sub(light, poi));
  V3 h = norm(add(view, l));            // NORMALIZED half vector (cu:478)
  V3 n = cross(sub(C, B), sub(A, B));   // (v2-v1) x (v0-v1), geometry.cuh:160

  float ndl = std::max(0.f, dot(n, l));
  float ndh = std::max(0.f, dot(n, h));
  V3 diffuse = mul(mul(m.base, ndl), m.kd);
  V3 specular = mul(mul(m.base, std::pow(ndh, m.spec_alpha)), m.ks);
  V3 color = add(add(diffuse, specular), mul(m.base, m.ka));

  // shadow ray TOWARD the light, mint = eps + 0.02, in-shadow halves
  HitState sh = Traverse(tris, g, poi, l, kParEps + 0.02f, kInf,
                         /*use_gate=*/true, kParEps);
  if (sh.tri >= 0) color = mul(color, 0.5f);

  if (m.reflective && depth < kReflectDepth) {
    V3 nn = norm(n);
    V3 rdir = norm(sub(d, mul(nn, 2.f * dot(d, nn))));
    V3 rec = ParallelTrace(tris, g, poi, rdir, light, depth + 1);
    color = add(mul(had(color, m.base), 1.f - m.km), mul(rec, m.km));
  }
  return color;
}

}  // namespace

int main(int argc, char** argv) {
  int width = 512, height = 512, repeat = 1;
  std::string out_path = "out.ppm", float_out, variant = "serial";
  V3 cam_pos = v3(3, 5, 3), cam_target = v3(0, 0, 0), cam_up = v3(0, -1, 0);
  float fov = 45.f;
  ShadeParams sp;
  TriSoup tris;

  auto parse3 = [](const char* s, V3* v) {
    std::sscanf(s, "%f,%f,%f", &v->x, &v->y, &v->z);
  };
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() { return argv[++i]; };
    if (a == "--width") width = std::atoi(next());
    else if (a == "--height") height = std::atoi(next());
    else if (a == "--repeat") repeat = std::atoi(next());
    else if (a == "--out") out_path = next();
    else if (a == "--float-out") float_out = next();
    else if (a == "--camera") parse3(next(), &cam_pos);
    else if (a == "--target") parse3(next(), &cam_target);
    else if (a == "--up") parse3(next(), &cam_up);
    else if (a == "--fov") fov = std::atof(next());
    else if (a == "--light") parse3(next(), &sp.light_pos);
    else if (a == "--variant") variant = next();
    else if (a == "--mesh") {
      // path[:ox,oy,oz[:scale[:mat]]]
      std::string spec = next();
      V3 offset = v3(0, 0, 0);
      float scale = 1.0f;
      int mat = 0;
      size_t p1 = spec.find(':');
      std::string path = spec.substr(0, p1);
      if (p1 != std::string::npos) {
        size_t p2 = spec.find(':', p1 + 1);
        parse3(spec.substr(p1 + 1, p2 - p1 - 1).c_str(), &offset);
        if (p2 != std::string::npos) {
          size_t p3 = spec.find(':', p2 + 1);
          scale = std::atof(spec.substr(p2 + 1, p3 - p2 - 1).c_str());
          if (p3 != std::string::npos) mat = std::atoi(spec.substr(p3 + 1).c_str());
        }
      }
      if (!LoadObj(path, offset, scale, mat, &tris)) {
        std::fprintf(stderr, "failed to load %s\n", path.c_str());
        return 1;
      }
    } else {
      std::fprintf(stderr, "unknown arg %s\n", a.c_str());
      return 1;
    }
  }
  if (tris.size() == 0) {
    std::fprintf(stderr, "no meshes\n");
    return 1;
  }
  std::fprintf(stderr, "oracle: %zu triangles, %dx%d\n", tris.size(), width, height);

  auto tg0 = std::chrono::steady_clock::now();
  Grid grid;
  BuildGrid(tris, &grid);
  auto tg1 = std::chrono::steady_clock::now();
  std::fprintf(stderr, "grid: %dx%dx%d, %zu entries, build %.1f ms\n", grid.n[0],
               grid.n[1], grid.n[2], grid.tri_ids.size(),
               std::chrono::duration<double, std::milli>(tg1 - tg0).count());

  // Camera basis (matches the serial reference; see SURVEY.md component 13).
  V3 up_n = norm(cam_up);
  V3 w = norm(mul(sub(cam_target, cam_pos), -1.f));
  V3 u = norm(cross(up_n, w));
  V3 v = norm(cross(w, u));
  float aspect = float(width) / float(height);
  float fd = 1.0f / (2.0f * std::tan(fov * M_PI / 360.0));

  std::vector<V3> image(size_t(width) * height);
  double best_ms = 1e30;
  for (int rep = 0; rep < repeat; ++rep) {
    auto t0 = std::chrono::steady_clock::now();
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        V3 dir = mul(w, -fd);
        dir = add(dir, mul(u, aspect * (x - width / 2.0f + 0.5f) / width));
        dir = add(dir, mul(v, (y - height / 2.0f + 0.5f) / height));
        dir = norm(dir);
        image[size_t(y) * width + x] =
            variant == "parallel"
                ? ParallelTrace(tris, grid, cam_pos, dir, sp.light_pos, 0)
                : TracePixel(tris, grid, cam_pos, dir, sp);
      }
    }
    auto t1 = std::chrono::steady_clock::now();
    double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
    best_ms = std::min(best_ms, ms);
  }
  double rays = 2.0 * width * height;  // primary + shadow
  std::printf("{\"render_ms\": %.3f, \"mrays_per_s\": %.4f, \"width\": %d, \"height\": %d, \"tris\": %zu}\n",
              best_ms, rays / (best_ms * 1e3), width, height, tris.size());

  std::ofstream ofs(out_path, std::ios::binary);
  ofs << "P6\n" << width << " " << height << "\n255\n";
  for (size_t i = 0; i < image.size(); ++i) {
    float cf[3] = {image[i].x, image[i].y, image[i].z};
    for (float c : cf)
      ofs << (unsigned char)(std::min(1.0f, c / 255.0f) * 255);
  }
  ofs.close();

  if (!float_out.empty()) {
    std::ofstream f(float_out, std::ios::binary);
    f.write(reinterpret_cast<const char*>(image.data()), image.size() * sizeof(V3));
  }
  return 0;
}
