// Native OBJ parser (runtime asset loader).
//
// Native equivalent of the reference's hand-rolled fscanf parser
// (obj_loader.cpp:14-163): supports `v x y z`, `vn x y z`, and faces
// `f a b c` / `f a//an b//bn c//cn` (1-based indices, triangles only — the
// same subset the reference accepts). Unlike the reference this parser is
// buffer-based (single read + pointer scan) rather than fscanf-per-token,
// and returns raw vertex/normal/face arrays; the scale/rotate/translate
// baking and edge-form conversion happen in the Python scene compiler where
// the transform math already lives (scene/obj_loader.py).
//
// C ABI for ctypes. Two-call protocol: first call with null outputs returns
// counts; second call fills caller-allocated buffers.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> verts;     // 3 per vertex
  std::vector<float> normals;   // 3 per normal
  std::vector<int32_t> faces;   // 6 per face: v0 v1 v2 n0 n1 n2 (0-based, -1 = none)
};

bool parse(const char* path, ObjData& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  buf[size] = '\0';

  char* p = buf.data();
  char* end = p + size;
  while (p < end) {
    // start of line
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      p += 1;
      for (int k = 0; k < 3; ++k) out.verts.push_back(std::strtof(p, &p));
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      p += 2;
      for (int k = 0; k < 3; ++k) out.normals.push_back(std::strtof(p, &p));
    } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      p += 1;
      int32_t vi[3] = {0, 0, 0}, ni[3] = {-1, -1, -1};
      bool ok = true;
      for (int k = 0; k < 3 && ok; ++k) {
        long v = std::strtol(p, &p, 10);
        if (v == 0) { ok = false; break; }
        vi[k] = static_cast<int32_t>(v - 1);  // 1-based -> 0-based
        if (*p == '/') {
          ++p;
          if (*p == '/') {  // v//n form (obj_loader.cpp:96-111)
            ++p;
            long n = std::strtol(p, &p, 10);
            if (n != 0) ni[k] = static_cast<int32_t>(n - 1);
          } else {  // v/t or v/t/n — texcoords unsupported, like the reference
            std::strtol(p, &p, 10);
            if (*p == '/') {
              ++p;
              long n = std::strtol(p, &p, 10);
              if (n != 0) ni[k] = static_cast<int32_t>(n - 1);
            }
          }
        }
      }
      if (ok) {
        for (int k = 0; k < 3; ++k) out.faces.push_back(vi[k]);
        for (int k = 0; k < 3; ++k) out.faces.push_back(ni[k]);
      }
    }
    // skip to next line
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  return true;
}

}  // namespace

extern "C" {

// Pass 1 (verts == nullptr): returns 0 on success and writes counts.
// Pass 2: fills verts (nv*3), normals (nn*3), faces (nf*6). Returns 0 ok.
int32_t mrt_obj_parse(const char* path, int32_t* nv, int32_t* nn, int32_t* nf,
                      float* verts, float* normals, int32_t* faces) {
  ObjData d;
  if (!parse(path, d)) return -1;
  const int32_t cv = static_cast<int32_t>(d.verts.size() / 3);
  const int32_t cn = static_cast<int32_t>(d.normals.size() / 3);
  const int32_t cf = static_cast<int32_t>(d.faces.size() / 6);
  if (verts == nullptr) {
    *nv = cv;
    *nn = cn;
    *nf = cf;
    return 0;
  }
  std::memcpy(verts, d.verts.data(), d.verts.size() * sizeof(float));
  if (normals && cn) std::memcpy(normals, d.normals.data(), d.normals.size() * sizeof(float));
  std::memcpy(faces, d.faces.data(), d.faces.size() * sizeof(int32_t));
  return 0;
}

}  // extern "C"
