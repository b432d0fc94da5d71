// Isosurface extraction via marching tetrahedra.
//
// TPU-native replacement for the reference's PyMCubes dependency
// (reference: app/coarse/model/voxurfc.py:646 `mcubes.marching_cubes`).
// Marching *tetrahedra* is used instead of classic marching cubes: each
// cell splits into 6 tetrahedra sharing the main diagonal, and every tet
// emits 0/1/2 triangles from sign classification — no case tables needed,
// no ambiguous configurations, and the zero level set matches MC's up to
// triangulation. Vertices on shared edges are deduplicated through a hash
// map so the mesh is watertight.
//
// Build: see Makefile (g++ -O3 -fPIC -shared -fopenmp). Loaded via ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MeshAccum {
  std::vector<float> verts;           // xyz triples
  std::vector<int64_t> tris;          // index triples
  std::unordered_map<uint64_t, int64_t> edge_vert;
};

// Unique key for the zero-crossing vertex on the edge between grid nodes
// a and b (node ids are linearized grid indices; order-normalized).
static inline uint64_t edge_key(uint64_t a, uint64_t b) {
  if (a > b) { uint64_t t = a; a = b; b = t; }
  return (a << 32) | b;
}

struct Ctx {
  const float* f;
  int64_t nx, ny, nz;
  float thresh;
};

static inline int64_t nid(const Ctx& c, int64_t x, int64_t y, int64_t z) {
  return (x * c.ny + y) * c.nz + z;
}

static int64_t vert_on_edge(MeshAccum& m, const Ctx& c, int64_t ga, int64_t gb) {
  uint64_t key = edge_key((uint64_t)ga, (uint64_t)gb);
  auto it = m.edge_vert.find(key);
  if (it != m.edge_vert.end()) return it->second;

  float fa = c.f[ga], fb = c.f[gb];
  float t = (c.thresh - fa) / (fb - fa);
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;

  int64_t az = ga % c.nz, ay = (ga / c.nz) % c.ny, ax = ga / (c.nz * c.ny);
  int64_t bz = gb % c.nz, by = (gb / c.nz) % c.ny, bx = gb / (c.nz * c.ny);

  int64_t idx = (int64_t)(m.verts.size() / 3);
  m.verts.push_back(ax + t * (bx - ax));
  m.verts.push_back(ay + t * (by - ay));
  m.verts.push_back(az + t * (bz - az));
  m.edge_vert.emplace(key, idx);
  return idx;
}

// Emit triangles for one tetrahedron given its 4 grid-node ids.
static void do_tet(MeshAccum& m, const Ctx& c, int64_t v0, int64_t v1,
                   int64_t v2, int64_t v3) {
  int inside = 0;
  int64_t vs[4] = {v0, v1, v2, v3};
  bool in[4];
  for (int i = 0; i < 4; ++i) {
    in[i] = c.f[vs[i]] > c.thresh;
    inside += in[i];
  }
  if (inside == 0 || inside == 4) return;

  // gather the single-or-triple vertex first so both cases share code
  if (inside == 1 || inside == 3) {
    // one vertex on one side, three on the other: one triangle
    bool lone_side = (inside == 1);
    int lone = -1;
    for (int i = 0; i < 4; ++i)
      if (in[i] == lone_side) { lone = i; break; }
    int o[3], k = 0;
    for (int i = 0; i < 4; ++i)
      if (i != lone) o[k++] = i;
    int64_t a = vert_on_edge(m, c, vs[lone], vs[o[0]]);
    int64_t b = vert_on_edge(m, c, vs[lone], vs[o[1]]);
    int64_t d = vert_on_edge(m, c, vs[lone], vs[o[2]]);
    m.tris.push_back(a); m.tris.push_back(b); m.tris.push_back(d);
  } else {
    // 2-2 split: quad -> two triangles
    int pi[2], ni2[2], p = 0, n = 0;
    for (int i = 0; i < 4; ++i) (in[i] ? pi[p++] : ni2[n++]) = i;
    int64_t a = vert_on_edge(m, c, vs[pi[0]], vs[ni2[0]]);
    int64_t b = vert_on_edge(m, c, vs[pi[0]], vs[ni2[1]]);
    int64_t d = vert_on_edge(m, c, vs[pi[1]], vs[ni2[1]]);
    int64_t e = vert_on_edge(m, c, vs[pi[1]], vs[ni2[0]]);
    m.tris.push_back(a); m.tris.push_back(b); m.tris.push_back(d);
    m.tris.push_back(a); m.tris.push_back(d); m.tris.push_back(e);
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle holding the extracted mesh; query sizes, copy
// out, then free. field is [nx, ny, nz] row-major float32. Vertices come
// back in index space (caller rescales to world coordinates, matching
// mcubes semantics).
void* mt_extract(const float* field, int64_t nx, int64_t ny, int64_t nz,
                 float thresh) {
  auto* m = new MeshAccum();
  Ctx c{field, nx, ny, nz, thresh};

  // 6-tet decomposition of each cell around the (0,0,0)-(1,1,1) diagonal
  static const int tets[6][4][3] = {
      {{0,0,0},{1,0,0},{1,1,0},{1,1,1}},
      {{0,0,0},{1,1,0},{0,1,0},{1,1,1}},
      {{0,0,0},{0,1,0},{0,1,1},{1,1,1}},
      {{0,0,0},{0,1,1},{0,0,1},{1,1,1}},
      {{0,0,0},{0,0,1},{1,0,1},{1,1,1}},
      {{0,0,0},{1,0,1},{1,0,0},{1,1,1}},
  };

  for (int64_t x = 0; x + 1 < nx; ++x)
    for (int64_t y = 0; y + 1 < ny; ++y)
      for (int64_t z = 0; z + 1 < nz; ++z)
        for (int t = 0; t < 6; ++t) {
          int64_t ids[4];
          for (int i = 0; i < 4; ++i)
            ids[i] = nid(c, x + tets[t][i][0], y + tets[t][i][1],
                         z + tets[t][i][2]);
          do_tet(*m, c, ids[0], ids[1], ids[2], ids[3]);
        }
  return m;
}

int64_t mt_num_verts(void* h) { return ((MeshAccum*)h)->verts.size() / 3; }
int64_t mt_num_tris(void* h) { return ((MeshAccum*)h)->tris.size() / 3; }

void mt_copy(void* h, float* verts_out, int64_t* tris_out) {
  auto* m = (MeshAccum*)h;
  std::memcpy(verts_out, m->verts.data(), m->verts.size() * sizeof(float));
  std::memcpy(tris_out, m->tris.data(), m->tris.size() * sizeof(int64_t));
}

void mt_free(void* h) { delete (MeshAccum*)h; }

}  // extern "C"
