// Native scene-ingestion runtime: OBJ parsing + BVH build.
//
// The reference's CPU side is interpreted TypeScript (scene.ts, bv.ts);
// for production-scale scenes (the 1M-triangle stress config) the hot
// host-side path — tokenizing a multi-hundred-MB OBJ and building
// per-model BVHs — is implemented natively here and exposed through a
// C ABI consumed via ctypes (models/native.py). Semantics are identical
// to the Python/numpy implementation (models/obj.py, models/bvh.py):
// median split on the mean of the stored point slots, stable ordering,
// preorder layout with implicit left child, <=2-face leaves, 0.01 AABB
// padding per thin axis, and skip-link threading.
//
// Build: g++ -O3 -march=native -shared -fPIC loader.cpp -o libwrtloader.so

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

constexpr float kBvMinDelta = 0.01f;  // bv.ts:13

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

struct ObjModel {
  std::string name;
  std::vector<int32_t> v_idx;   // 3 per face
  std::vector<int32_t> n_idx;   // 3 per face (-1 absent)
  std::vector<int32_t> t_idx;   // 3 per face (-1 absent)
  std::vector<int32_t> mat_id;  // per face, index into material name table
};

struct ObjFile {
  std::vector<float> vertices;   // xyz triples
  std::vector<float> normals;    // xyz triples
  std::vector<float> texcoords;  // uvw triples
  std::vector<ObjModel> models;
  std::vector<std::string> material_names;  // usemtl strings, deduped
};

struct FaceVert {
  int v = -1, t = -1, n = -1;
};

inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline FaceVert parse_face_vert(const char *&p, const char *end) {
  FaceVert fv;
  char *next = nullptr;
  fv.v = static_cast<int>(std::strtol(p, &next, 10)) - 1;
  p = next;
  if (p < end && *p == '/') {
    ++p;
    if (p < end && *p != '/') {
      fv.t = static_cast<int>(std::strtol(p, &next, 10)) - 1;
      p = next;
    }
    if (p < end && *p == '/') {
      ++p;
      fv.n = static_cast<int>(std::strtol(p, &next, 10)) - 1;
      p = next;
    }
  }
  return fv;
}

ObjFile parse_obj_text(const char *data, size_t len) {
  ObjFile out;
  std::unordered_map<std::string, int32_t> mat_ids;
  ObjModel cur;
  bool started = false;
  int32_t cur_mat = -1;

  auto flush = [&]() {
    if (!started) return;
    out.models.push_back(std::move(cur));
    cur = ObjModel{};
  };

  const char *p = data;
  const char *end = data + len;
  std::vector<FaceVert> fvs;
  while (p < end) {
    const char *line_end =
        static_cast<const char *>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char *q = skip_ws(p, line_end);
    // strip comments by bounding the line at '#'
    const char *hash =
        static_cast<const char *>(memchr(q, '#', line_end - q));
    const char *stop = hash ? hash : line_end;

    if (stop - q >= 2 && q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char *nx;
      q += 2;
      for (int k = 0; k < 3; ++k) {
        out.vertices.push_back(std::strtof(q, &nx));
        q = nx;
      }
    } else if (stop - q >= 3 && q[0] == 'v' && q[1] == 'n' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char *nx;
      q += 3;
      for (int k = 0; k < 3; ++k) {
        out.normals.push_back(std::strtof(q, &nx));
        q = nx;
      }
    } else if (stop - q >= 3 && q[0] == 'v' && q[1] == 't' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char *nx;
      q += 3;
      float vals[3] = {0, 0, 0};
      for (int k = 0; k < 3 && q < stop; ++k) {
        const char *before = q;
        vals[k] = std::strtof(q, &nx);
        if (nx == before) break;
        q = nx;
      }
      out.texcoords.insert(out.texcoords.end(), vals, vals + 3);
    } else if (stop - q >= 2 && (q[0] == 'o' || q[0] == 'g') &&
               (q[1] == ' ' || q[1] == '\t')) {
      flush();
      started = true;
      const char *name_start = skip_ws(q + 1, stop);
      const char *name_end = stop;
      while (name_end > name_start &&
             std::isspace(static_cast<unsigned char>(name_end[-1])))
        --name_end;
      cur.name.assign(name_start, name_end);
      if (cur.name.empty()) cur.name = "default";
    } else if (stop - q >= 7 && std::strncmp(q, "usemtl", 6) == 0) {
      const char *name_start = skip_ws(q + 6, stop);
      const char *name_end = stop;
      while (name_end > name_start &&
             std::isspace(static_cast<unsigned char>(name_end[-1])))
        --name_end;
      std::string name(name_start, name_end);
      auto it = mat_ids.find(name);
      if (it == mat_ids.end()) {
        it = mat_ids.emplace(name, (int32_t)out.material_names.size()).first;
        out.material_names.push_back(name);
      }
      cur_mat = it->second;
    } else if (stop - q >= 2 && q[0] == 'f' &&
               (q[1] == ' ' || q[1] == '\t')) {
      started = true;
      fvs.clear();
      const char *r = q + 2;
      while (true) {
        r = skip_ws(r, stop);
        if (r >= stop || (*r != '-' && !std::isdigit(
                                           static_cast<unsigned char>(*r))))
          break;
        fvs.push_back(parse_face_vert(r, stop));
      }
      // fan triangulation (models/obj.py semantics)
      for (size_t k = 1; k + 1 < fvs.size(); ++k) {
        const FaceVert tri[3] = {fvs[0], fvs[k], fvs[k + 1]};
        for (const auto &t : tri) {
          cur.v_idx.push_back(t.v);
          cur.t_idx.push_back(t.t);
          cur.n_idx.push_back(t.n);
        }
        cur.mat_id.push_back(cur_mat);
      }
    }
    p = line_end + 1;
  }
  flush();
  return out;
}

// ---------------------------------------------------------------------------
// BVH build (models/bvh.py semantics)
// ---------------------------------------------------------------------------

struct BvhOut {
  std::vector<float> node_min;    // 3 per node
  std::vector<float> node_max;    // 3 per node
  std::vector<int32_t> right;     // per node, -1 leaf
  std::vector<int32_t> face0;     // per node
  std::vector<int32_t> face1;     // per node
  std::vector<int32_t> skip;      // per node
};

void build_bvh_impl(const float *p0, const float *e1, const float *e2,
                    int64_t f, BvhOut &out) {
  std::vector<Vec3> lo(f), hi(f);
  std::vector<float> key(3 * f);
  for (int64_t i = 0; i < f; ++i) {
    Vec3 a{p0[3 * i], p0[3 * i + 1], p0[3 * i + 2]};
    Vec3 b{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
    Vec3 c{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
    lo[i] = vmin(vmin(a, b), c);
    hi[i] = vmax(vmax(a, b), c);
    // split key: mean of the stored point slots (p0 + e1 + e2) / 3
    key[3 * i + 0] = (p0[3 * i + 0] + e1[3 * i + 0] + e2[3 * i + 0]) / 3.0f;
    key[3 * i + 1] = (p0[3 * i + 1] + e1[3 * i + 1] + e2[3 * i + 1]) / 3.0f;
    key[3 * i + 2] = (p0[3 * i + 2] + e1[3 * i + 2] + e2[3 * i + 2]) / 3.0f;
  }

  struct Task {
    int64_t begin, count;
    int32_t parent;  // node whose right link to set; -1 none
  };
  std::vector<int64_t> order(f);
  std::iota(order.begin(), order.end(), 0);
  std::vector<int64_t> scratch(f);

  std::vector<Task> stack;
  stack.push_back({0, f, -1});
  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    int32_t node = (int32_t)out.right.size();
    if (t.parent >= 0) out.right[t.parent] = node;

    Vec3 bmin{3.4e38f, 3.4e38f, 3.4e38f};
    Vec3 bmax{-3.4e38f, -3.4e38f, -3.4e38f};
    for (int64_t i = t.begin; i < t.begin + t.count; ++i) {
      bmin = vmin(bmin, lo[order[i]]);
      bmax = vmax(bmax, hi[order[i]]);
    }
    // pad degenerate axes (bv.ts:54-61)
    if (bmax.x - bmin.x < kBvMinDelta) bmax.x += kBvMinDelta;
    if (bmax.y - bmin.y < kBvMinDelta) bmax.y += kBvMinDelta;
    if (bmax.z - bmin.z < kBvMinDelta) bmax.z += kBvMinDelta;

    out.node_min.insert(out.node_min.end(), {bmin.x, bmin.y, bmin.z});
    out.node_max.insert(out.node_max.end(), {bmax.x, bmax.y, bmax.z});
    out.right.push_back(-1);

    if (t.count <= 2) {
      out.face0.push_back(t.count >= 1 ? (int32_t)order[t.begin] : -1);
      out.face1.push_back(t.count >= 2 ? (int32_t)order[t.begin + 1] : -1);
      continue;
    }
    out.face0.push_back(-1);
    out.face1.push_back(-1);

    int axis = 0;
    float dx = bmax.x - bmin.x, dy = bmax.y - bmin.y, dz = bmax.z - bmin.z;
    // numpy argmax tie-breaking: first maximum wins
    float best = dx;
    if (dy > best) { best = dy; axis = 1; }
    if (dz > best) { best = dz; axis = 2; }

    int64_t *beg = order.data() + t.begin;
    std::stable_sort(beg, beg + t.count, [&](int64_t a, int64_t b) {
      return key[3 * a + axis] < key[3 * b + axis];
    });
    int64_t mid = t.count / 2;
    // push right first so the left subtree is emitted first (preorder)
    stack.push_back({t.begin + mid, t.count - mid, node});
    stack.push_back({t.begin, mid, -1});
  }

  // thread skip links: preorder parents precede children
  int32_t n = (int32_t)out.right.size();
  out.skip.assign(n, n);
  for (int32_t i = 0; i < n; ++i) {
    int32_t r = out.right[i];
    if (r >= 0) {
      out.skip[i + 1] = r;
      out.skip[r] = out.skip[i];
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

typedef struct {
  ObjFile *obj;
} WrtObjHandle;

// Parse an OBJ file from disk. Returns a handle (NULL on failure).
void *wrt_obj_parse(const char *path) {
  FILE *fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)size);
  if (size > 0 && std::fread(&buf[0], 1, (size_t)size, fp) != (size_t)size) {
    std::fclose(fp);
    return nullptr;
  }
  std::fclose(fp);
  auto *h = new WrtObjHandle{new ObjFile(parse_obj_text(buf.data(), buf.size()))};
  return h;
}

void wrt_obj_free(void *handle) {
  auto *h = static_cast<WrtObjHandle *>(handle);
  if (!h) return;
  delete h->obj;
  delete h;
}

int64_t wrt_obj_num_vertices(void *h) {
  return (int64_t)static_cast<WrtObjHandle *>(h)->obj->vertices.size() / 3;
}
int64_t wrt_obj_num_normals(void *h) {
  return (int64_t)static_cast<WrtObjHandle *>(h)->obj->normals.size() / 3;
}
int64_t wrt_obj_num_texcoords(void *h) {
  return (int64_t)static_cast<WrtObjHandle *>(h)->obj->texcoords.size() / 3;
}
int64_t wrt_obj_num_models(void *h) {
  return (int64_t)static_cast<WrtObjHandle *>(h)->obj->models.size();
}
int64_t wrt_obj_num_materials(void *h) {
  return (int64_t)static_cast<WrtObjHandle *>(h)->obj->material_names.size();
}

void wrt_obj_copy_vertices(void *h, float *dst) {
  auto &v = static_cast<WrtObjHandle *>(h)->obj->vertices;
  std::memcpy(dst, v.data(), v.size() * sizeof(float));
}
void wrt_obj_copy_normals(void *h, float *dst) {
  auto &v = static_cast<WrtObjHandle *>(h)->obj->normals;
  std::memcpy(dst, v.data(), v.size() * sizeof(float));
}
void wrt_obj_copy_texcoords(void *h, float *dst) {
  auto &v = static_cast<WrtObjHandle *>(h)->obj->texcoords;
  std::memcpy(dst, v.data(), v.size() * sizeof(float));
}

const char *wrt_obj_model_name(void *h, int64_t m) {
  return static_cast<WrtObjHandle *>(h)->obj->models[m].name.c_str();
}
const char *wrt_obj_material_name(void *h, int64_t i) {
  return static_cast<WrtObjHandle *>(h)->obj->material_names[i].c_str();
}
int64_t wrt_obj_model_num_faces(void *h, int64_t m) {
  return (int64_t)static_cast<WrtObjHandle *>(h)->obj->models[m].mat_id.size();
}
void wrt_obj_model_copy(void *h, int64_t m, int32_t *v_idx, int32_t *n_idx,
                        int32_t *t_idx, int32_t *mat_id) {
  auto &mod = static_cast<WrtObjHandle *>(h)->obj->models[m];
  std::memcpy(v_idx, mod.v_idx.data(), mod.v_idx.size() * sizeof(int32_t));
  std::memcpy(n_idx, mod.n_idx.data(), mod.n_idx.size() * sizeof(int32_t));
  std::memcpy(t_idx, mod.t_idx.data(), mod.t_idx.size() * sizeof(int32_t));
  std::memcpy(mat_id, mod.mat_id.data(), mod.mat_id.size() * sizeof(int32_t));
}

typedef struct {
  BvhOut *bvh;
} WrtBvhHandle;

// Build a BVH over f faces given SoA arrays (each f*3 floats).
void *wrt_bvh_build(const float *p0, const float *e1, const float *e2,
                    int64_t f) {
  auto *h = new WrtBvhHandle{new BvhOut()};
  if (f > 0) build_bvh_impl(p0, e1, e2, f, *h->bvh);
  return h;
}

void wrt_bvh_free(void *handle) {
  auto *h = static_cast<WrtBvhHandle *>(handle);
  if (!h) return;
  delete h->bvh;
  delete h;
}

int64_t wrt_bvh_num_nodes(void *h) {
  return (int64_t)static_cast<WrtBvhHandle *>(h)->bvh->right.size();
}

void wrt_bvh_copy(void *handle, float *node_min, float *node_max,
                  int32_t *right, int32_t *face0, int32_t *face1,
                  int32_t *skip) {
  auto *b = static_cast<WrtBvhHandle *>(handle)->bvh;
  std::memcpy(node_min, b->node_min.data(),
              b->node_min.size() * sizeof(float));
  std::memcpy(node_max, b->node_max.data(),
              b->node_max.size() * sizeof(float));
  std::memcpy(right, b->right.data(), b->right.size() * sizeof(int32_t));
  std::memcpy(face0, b->face0.data(), b->face0.size() * sizeof(int32_t));
  std::memcpy(face1, b->face1.data(), b->face1.size() * sizeof(int32_t));
  std::memcpy(skip, b->skip.data(), b->skip.size() * sizeof(int32_t));
}

}  // extern "C"
