// Fast OpenPose-JSON keypoint parser (native data plane).
//
// The reference's data loading is Python json.load per image
// (smplifyx/data_parser.py:57-104).  For production-scale batched fitting the
// input pipeline parses thousands of keypoint JSONs per second; this is a
// minimal, dependency-free scanner specialized for the OpenPose schema that
// extracts the four keypoint arrays per person without building a DOM.
//
// Exposed via a C ABI consumed through ctypes (smplifyx_torch/data/native.py).
// Built at first use by smplifyx_torch/ops/nvcc.py with the host compiler
// (g++ -O3 -fPIC -std=c++17 -shared) into build/libkeypoints_torch.so.
//
// Schema handled:
//   {"people": [{"pose_keypoints_2d": [...], "hand_left_keypoints_2d": [...],
//                "hand_right_keypoints_2d": [...], "face_keypoints_2d": [...],
//                ...}, ...]}
// Unknown keys are skipped; numbers are parsed with strtod.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

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
    if (at(c)) {
      ++p;
      return true;
    }
    return false;
  }
};

// Parse a JSON string at the cursor (assumes leading '"'); returns contents.
bool parse_string(Cursor& c, std::string* out) {
  if (!c.eat('"')) return false;
  out->clear();
  while (c.p < c.end && *c.p != '"') {
    if (*c.p == '\\' && c.p + 1 < c.end) ++c.p;  // skip escape marker
    out->push_back(*c.p++);
  }
  return c.eat('"');
}

// Skip any JSON value (object/array/string/number/bool/null).
bool skip_value(Cursor& c) {
  c.skip_ws();
  if (c.p >= c.end) return false;
  char ch = *c.p;
  if (ch == '{' || ch == '[') {
    char open = ch, close = (ch == '{') ? '}' : ']';
    int depth = 0;
    bool in_str = false;
    while (c.p < c.end) {
      char cur = *c.p++;
      if (in_str) {
        if (cur == '\\')
          ++c.p;
        else if (cur == '"')
          in_str = false;
      } else if (cur == '"') {
        in_str = true;
      } else if (cur == open) {
        ++depth;
      } else if (cur == close) {
        if (--depth == 0) return true;
      }
    }
    return false;
  }
  if (ch == '"') {
    std::string tmp;
    return parse_string(c, &tmp);
  }
  while (c.p < c.end && *c.p != ',' && *c.p != '}' && *c.p != ']') ++c.p;
  return true;
}

// Parse a flat numeric array "[1, 2.5, ...]" into out.
bool parse_number_array(Cursor& c, std::vector<double>* out) {
  if (!c.eat('[')) return false;
  out->clear();
  while (!c.at(']')) {
    char* endptr = nullptr;
    double v = strtod(c.p, &endptr);
    if (endptr == c.p) return false;
    out->push_back(v);
    c.p = endptr;
    c.skip_ws();
  }
  return c.eat(']');
}

}  // namespace

extern "C" {

// Parse one OpenPose JSON buffer.
//
// For each person, writes body/lhand/rhand/face floats into `out`
// (caller-allocated, capacity `out_capacity` floats) laid out per person as
// [body(3*body_len) | lhand(63) | rhand(63) | face(3*face_len)], where the
// actual body/face lengths found are reported via out_body_len/out_face_len
// (in keypoints, not floats; constant across people in a file).
// Returns the number of people parsed, or -1 on malformed input / overflow.
int parse_openpose_json(const char* data, long size, float* out,
                        long out_capacity, int* out_body_len,
                        int* out_face_len) {
  Cursor c{data, data + size};
  if (!c.eat('{')) return -1;

  std::string key;
  std::vector<double> body, lh, rh, face;
  long written = 0;
  int people = 0;
  *out_body_len = 0;
  *out_face_len = 0;

  while (!c.at('}')) {
    if (!parse_string(c, &key)) return -1;
    if (!c.eat(':')) return -1;
    if (key != "people") {
      if (!skip_value(c)) return -1;
      continue;
    }
    if (!c.eat('[')) return -1;
    while (!c.at(']')) {
      if (!c.eat('{')) return -1;
      body.clear();
      lh.assign(63, 0.0);
      rh.assign(63, 0.0);
      face.clear();
      bool has_lh = false, has_rh = false;
      while (!c.at('}')) {
        if (!parse_string(c, &key)) return -1;
        if (!c.eat(':')) return -1;
        if (key == "pose_keypoints_2d") {
          if (!parse_number_array(c, &body)) return -1;
        } else if (key == "hand_left_keypoints_2d") {
          if (!parse_number_array(c, &lh)) return -1;
          has_lh = true;
        } else if (key == "hand_right_keypoints_2d") {
          if (!parse_number_array(c, &rh)) return -1;
          has_rh = true;
        } else if (key == "face_keypoints_2d") {
          if (!parse_number_array(c, &face)) return -1;
        } else {
          if (!skip_value(c)) return -1;
        }
      }
      if (!c.eat('}')) return -1;
      (void)has_lh;
      (void)has_rh;

      *out_body_len = static_cast<int>(body.size() / 3);
      *out_face_len = static_cast<int>(face.size() / 3);
      long need = static_cast<long>(body.size() + lh.size() + rh.size() +
                                    face.size());
      if (written + need > out_capacity) return -1;
      for (double v : body) out[written++] = static_cast<float>(v);
      for (double v : lh) out[written++] = static_cast<float>(v);
      for (double v : rh) out[written++] = static_cast<float>(v);
      for (double v : face) out[written++] = static_cast<float>(v);
      ++people;
    }
    if (!c.eat(']')) return -1;
  }
  return people;
}

// Convenience: parse straight from a file path (avoids a Python read).
int parse_openpose_file(const char* path, float* out, long out_capacity,
                        int* out_body_len, int* out_face_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  size_t rd = fread(buf.data(), 1, static_cast<size_t>(size), f);
  fclose(f);
  if (static_cast<long>(rd) != size) return -1;
  return parse_openpose_json(buf.data(), size, out, out_capacity,
                             out_body_len, out_face_len);
}

}  // extern "C"
