// Native mocap clip parser for the retargeted-clip JSON format.
//
// The reference loads its 62 clips (~100 MB of JSON; format documented at
// reference utils/obstacle.py:9 and motion_lib.py:33-35) through Python's
// json module at env construction — acceptable when every actor process
// builds one env, slow when a single host program packs the whole library
// before jit. This parser reads the restricted grammar the clip files use
//   { "FrameDuration": <num>, "LegOrder": [...], "Frames": [[f x 19], ...] }
// in one pass with strtod, ~20x faster than json.loads, exposed to Python
// through a plain C ABI and ctypes (lifelike_tpu_torch/_native/__init__.py).
//
// C ABI:
//   clip_parse_file(path, out, max_floats, frame_duration, n_floats)
//     out == NULL        -> count only (n_floats set, returns 0)
//     out != NULL        -> fill out[0..n_floats), returns 0
//   negative return = error code.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int ERR_IO = -1;
constexpr int ERR_PARSE = -2;
constexpr int ERR_OVERFLOW = -3;

struct Cursor {
  const char* p;
  const char* end;
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' ||
                       *p == ','))
      ++p;
  }
  bool at(char c) {
    skip_ws();
    return p < end && *p == c;
  }
  bool eat(char c) {
    if (!at(c)) return false;
    ++p;
    return true;
  }
};

// Find `"key"` at any depth (keys are unique in this format).
const char* find_key(const char* data, const char* end, const char* key) {
  size_t klen = std::strlen(key);
  for (const char* p = data; p + klen + 2 <= end; ++p) {
    if (*p == '"' && std::memcmp(p + 1, key, klen) == 0 && p[klen + 1] == '"')
      return p + klen + 2;
  }
  return nullptr;
}

int parse_frames(Cursor c, float* out, long max_floats, long* n_floats) {
  if (!c.eat(':')) return ERR_PARSE;
  if (!c.eat('[')) return ERR_PARSE;
  long n = 0;
  while (true) {
    if (c.eat(']')) break;  // end of Frames
    if (!c.eat('[')) return ERR_PARSE;
    while (!c.eat(']')) {
      c.skip_ws();
      char* next = nullptr;
      double v = std::strtod(c.p, &next);
      if (next == c.p) return ERR_PARSE;
      c.p = next;
      if (out) {
        if (n >= max_floats) return ERR_OVERFLOW;
        out[n] = static_cast<float>(v);
      }
      ++n;
    }
  }
  *n_floats = n;
  return 0;
}

}  // namespace

extern "C" {

int clip_parse_file(const char* path, float* out, long max_floats,
                    double* frame_duration, long* n_floats) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_IO;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  if (size > 0 && std::fread(buf.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return ERR_IO;
  }
  std::fclose(f);

  const char* data = buf.data();
  const char* end = data + size;

  const char* fd = find_key(data, end, "FrameDuration");
  if (!fd) return ERR_PARSE;
  Cursor cfd{fd, end};
  if (!cfd.eat(':')) return ERR_PARSE;
  cfd.skip_ws();
  char* next = nullptr;
  *frame_duration = std::strtod(cfd.p, &next);
  if (next == cfd.p) return ERR_PARSE;

  const char* fr = find_key(data, end, "Frames");
  if (!fr) return ERR_PARSE;
  return parse_frames(Cursor{fr, end}, out, max_floats, n_floats);
}

}  // extern "C"
