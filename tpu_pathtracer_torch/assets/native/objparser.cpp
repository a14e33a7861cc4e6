// Fast OBJ geometry parser — native counterpart of the reference's
// vendored tiny_obj_loader.h (tiny_obj_loader.h:1395-1730) and of the
// pure-Python fallback in tpu_pathtracer_torch/assets/obj.py (the port's
// copy of the JAX package's objparser.cpp, kept apart so that the port
// builds nothing inside the JAX package).
//
// Scope: the *hot* path only — triangle-soup extraction (v/vn/vt/f with
// fan triangulation, negative indices, usemtl grouping).  MTL parsing
// stays in Python (tiny files).  Output contract matches
// assets/obj.py::triangulate exactly, including the fallback normal
// (0,1,0) for missing/degenerate normals (reference optixSphere.cpp:487)
// and double-precision normal normalisation (to stay bit-identical with
// the numpy oracle).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 objparser.cpp -o libobjparser.so
// (built on demand into build/tpu_pathtracer_torch/native/ by
// tpu_pathtracer_torch/assets/native/__init__.py::_build, loaded via ctypes).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Index3 {
  int32_t v, t, n;
};

struct ParserState {
  std::vector<float> vertices;   // xyz
  std::vector<float> normals;    // xyz
  std::vector<float> texcoords;  // uv
  // outputs (triangle soup)
  std::vector<float> tri_v;   // T*9
  std::vector<float> tri_n;   // T*9
  std::vector<float> tri_uv;  // T*6
  std::vector<int32_t> tri_mat;
  std::vector<std::string> mat_names;   // usemtl order of first use
  std::vector<std::string> mtl_libs;    // mtllib filenames
  std::unordered_map<std::string, int32_t> mat_index;
  int32_t cur_mat = -1;
  std::string error;
  std::string names_out, libs_out;  // '\n'-joined, owned until obj_free
};

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

float parse_float(const char*& p, const char* end) {
  char* out = nullptr;
  float v = strtof(p, &out);
  if (out) p = out > end ? end : out;
  return v;
}

long parse_int(const char*& p) {
  char* out = nullptr;
  long v = strtol(p, &out, 10);
  if (out) p = out;
  return v;
}

int32_t resolve(long idx, size_t count) {
  if (idx > 0) return static_cast<int32_t>(idx - 1);
  if (idx < 0) return static_cast<int32_t>(static_cast<long>(count) + idx);
  return -1;
}

void emit_triangle(ParserState& st, const Index3* tri) {
  const size_t nv = st.vertices.size() / 3;
  const size_t nn = st.normals.size() / 3;
  const size_t nt = st.texcoords.size() / 2;
  for (int c = 0; c < 3; ++c) {
    const Index3& ix = tri[c];
    if (ix.v < 0 || static_cast<size_t>(ix.v) >= nv) {
      st.tri_v.insert(st.tri_v.end(), {0.f, 0.f, 0.f});
    } else {
      const float* v = &st.vertices[3 * ix.v];
      st.tri_v.insert(st.tri_v.end(), {v[0], v[1], v[2]});
    }
    if (ix.n >= 0 && static_cast<size_t>(ix.n) < nn) {
      const float* n = &st.normals[3 * ix.n];
      // double-precision normalise (bit-parity with the numpy fallback)
      const double l = std::sqrt(double(n[0]) * n[0] + double(n[1]) * n[1] +
                                 double(n[2]) * n[2]);
      if (l > 1e-12) {
        st.tri_n.push_back(static_cast<float>(n[0] / l));
        st.tri_n.push_back(static_cast<float>(n[1] / l));
        st.tri_n.push_back(static_cast<float>(n[2] / l));
      } else {
        st.tri_n.insert(st.tri_n.end(), {0.f, 1.f, 0.f});
      }
    } else {
      st.tri_n.insert(st.tri_n.end(), {0.f, 1.f, 0.f});
    }
    if (ix.t >= 0 && static_cast<size_t>(ix.t) < nt) {
      const float* t = &st.texcoords[2 * ix.t];
      st.tri_uv.insert(st.tri_uv.end(), {t[0], t[1]});
    } else {
      st.tri_uv.insert(st.tri_uv.end(), {0.f, 0.f});
    }
  }
  st.tri_mat.push_back(st.cur_mat);
}

}  // namespace

extern "C" {

struct ObjResult {
  float* tri_v;      // [T,3,3]
  float* tri_n;      // [T,3,3]
  float* tri_uv;     // [T,3,2]
  int32_t* tri_mat;  // [T]
  int64_t num_tris;
  char* mat_names;   // '\n'-separated usemtl names (first-use order)
  char* mtl_libs;    // '\n'-separated mtllib names
  char* error;       // nullptr on success
  // internal
  void* state;
};

ObjResult* obj_parse(const char* path, float scale, int skip_non_triangles) {
  auto* res = new ObjResult();
  std::memset(res, 0, sizeof(ObjResult));
  auto* st = new ParserState();
  res->state = st;

  FILE* f = fopen(path, "rb");
  if (!f) {
    st->error = std::string("cannot open ") + path;
    res->error = const_cast<char*>(st->error.c_str());
    return res;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  if (size > 0 && fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    st->error = std::string("short read on ") + path;
    res->error = const_cast<char*>(st->error.c_str());
    return res;
  }
  fclose(f);

  const char* p = buf.data();
  const char* end = buf.data() + buf.size();
  std::vector<Index3> face;

  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    const char c0 = *p;
    if (c0 == 'v' && p + 1 < end) {
      const char c1 = p[1];
      if (c1 == ' ' || c1 == '\t') {
        p += 2;
        float x = parse_float(p, end);
        float y = parse_float(p, end);
        float z = parse_float(p, end);
        st->vertices.insert(st->vertices.end(),
                            {x * scale, y * scale, z * scale});
      } else if (c1 == 'n') {
        p += 3;
        float x = parse_float(p, end);
        float y = parse_float(p, end);
        float z = parse_float(p, end);
        st->normals.insert(st->normals.end(), {x, y, z});
      } else if (c1 == 't') {
        p += 3;
        float u = parse_float(p, end);
        float v = parse_float(p, end);
        st->texcoords.insert(st->texcoords.end(), {u, v});
      }
    } else if (c0 == 'f' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      face.clear();
      while (p < end && *p != '\n' && *p != '#') {
        p = skip_ws(p, end);
        if (p >= end || *p == '\n' || *p == '#' || *p == '\r') break;
        Index3 ix{-1, -1, -1};
        ix.v = resolve(parse_int(p), st->vertices.size() / 3);
        if (p < end && *p == '/') {
          ++p;
          if (p < end && *p != '/')
            ix.t = resolve(parse_int(p), st->texcoords.size() / 2);
          if (p < end && *p == '/') {
            ++p;
            ix.n = resolve(parse_int(p), st->normals.size() / 3);
          }
        }
        face.push_back(ix);
      }
      const size_t fv = face.size();
      if (fv == 3 || (fv > 3 && !skip_non_triangles)) {
        for (size_t k = 1; k + 1 < fv; ++k) {
          Index3 tri[3] = {face[0], face[k], face[k + 1]};
          emit_triangle(*st, tri);
        }
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      p = skip_ws(p + 6, end);
      const char* e = p;
      while (e < end && *e != '\n' && *e != '\r') ++e;
      std::string name(p, e);
      auto it = st->mat_index.find(name);
      if (it == st->mat_index.end()) {
        st->cur_mat = static_cast<int32_t>(st->mat_names.size());
        st->mat_index.emplace(name, st->cur_mat);
        st->mat_names.push_back(name);
      } else {
        st->cur_mat = it->second;
      }
    } else if (!strncmp(p, "mtllib", 6)) {
      p = skip_ws(p + 6, end);
      const char* e = p;
      while (e < end && *e != '\n' && *e != '\r') ++e;
      st->mtl_libs.emplace_back(p, e);
    }
    p = next_line(p, end);
  }

  res->tri_v = st->tri_v.data();
  res->tri_n = st->tri_n.data();
  res->tri_uv = st->tri_uv.data();
  res->tri_mat = st->tri_mat.data();
  res->num_tris = static_cast<int64_t>(st->tri_mat.size());

  for (auto& n : st->mat_names) {
    st->names_out += n;
    st->names_out += '\n';
  }
  for (auto& n : st->mtl_libs) {
    st->libs_out += n;
    st->libs_out += '\n';
  }
  res->mat_names = const_cast<char*>(st->names_out.c_str());
  res->mtl_libs = const_cast<char*>(st->libs_out.c_str());
  res->error = nullptr;
  return res;
}

void obj_free(ObjResult* res) {
  if (!res) return;
  delete static_cast<ParserState*>(res->state);
  delete res;
}

}  // extern "C"
