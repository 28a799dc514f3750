// json.hpp — minimal JSON value type, parser and serializer for the
// gpu-hostengine wire protocol (newline-delimited JSON; see
// tpumon_torch/backends/agent.py and agent/protocol.md).
//
// Deliberately small: objects, arrays, strings, doubles, bools, null.
// No exceptions across the API boundary — parse() returns nullopt on error.

#pragma once

#include <cctype>
#include <cmath>
#include <cstdint>
#include <map>
#include <memory>
#include <optional>
#include <sstream>
#include <string>
#include <vector>

namespace tpumon {

class Json;
using JsonObject = std::map<std::string, Json>;
using JsonArray = std::vector<Json>;

class Json {
 public:
  enum class Type { Null, Bool, Number, String, Array, Object };

  Json() : type_(Type::Null) {}
  Json(std::nullptr_t) : type_(Type::Null) {}
  Json(bool b) : type_(Type::Bool), bool_(b) {}
  Json(double d) : type_(Type::Number), num_(d) {}
  Json(int i) : type_(Type::Number), num_(i) {}
  Json(long long i) : type_(Type::Number), num_(static_cast<double>(i)) {}
  Json(const char* s) : type_(Type::String), str_(s) {}
  Json(std::string s) : type_(Type::String), str_(std::move(s)) {}
  Json(JsonArray a) : type_(Type::Array), arr_(std::move(a)) {}
  Json(JsonObject o) : type_(Type::Object), obj_(std::move(o)) {}

  Type type() const { return type_; }
  bool is_null() const { return type_ == Type::Null; }

  bool as_bool(bool dflt = false) const {
    return type_ == Type::Bool ? bool_ : dflt;
  }
  double as_num(double dflt = 0) const {
    return type_ == Type::Number ? num_ : dflt;
  }
  long long as_int(long long dflt = 0) const {
    return type_ == Type::Number ? static_cast<long long>(num_) : dflt;
  }
  const std::string& as_str() const { return str_; }
  const JsonArray& as_arr() const { return arr_; }
  const JsonObject& as_obj() const { return obj_; }

  const Json& operator[](const std::string& key) const {
    static const Json kNull;
    if (type_ != Type::Object) return kNull;
    auto it = obj_.find(key);
    return it == obj_.end() ? kNull : it->second;
  }

  void set(const std::string& key, Json v) {
    type_ = Type::Object;
    obj_[key] = std::move(v);
  }

  std::string dump() const {
    std::ostringstream os;
    dump(os);
    return os.str();
  }

  void dump(std::ostringstream& os) const {
    switch (type_) {
      case Type::Null: os << "null"; break;
      case Type::Bool: os << (bool_ ? "true" : "false"); break;
      case Type::Number: {
        if (std::isfinite(num_) && num_ == std::floor(num_) &&
            std::fabs(num_) < 9.0e15) {
          os << static_cast<long long>(num_);
        } else if (std::isfinite(num_)) {
          // full round-trip precision: default streams print 6 significant
          // digits, which collapses epoch timestamps to the same second
          char buf[32];
          snprintf(buf, sizeof(buf), "%.17g", num_);
          os << buf;
        } else {
          os << "null";  // NaN/Inf are not valid JSON
        }
        break;
      }
      case Type::String: dump_string(os, str_); break;
      case Type::Array: {
        os << '[';
        bool first = true;
        for (const auto& v : arr_) {
          if (!first) os << ',';
          first = false;
          v.dump(os);
        }
        os << ']';
        break;
      }
      case Type::Object: {
        os << '{';
        bool first = true;
        for (const auto& [k, v] : obj_) {
          if (!first) os << ',';
          first = false;
          dump_string(os, k);
          os << ':';
          v.dump(os);
        }
        os << '}';
        break;
      }
    }
  }

  // ---- parsing -------------------------------------------------------------

  static std::optional<Json> parse(const std::string& text) {
    size_t pos = 0;
    auto v = parse_value(text, pos);
    if (!v) return std::nullopt;
    skip_ws(text, pos);
    if (pos != text.size()) return std::nullopt;  // trailing garbage
    return v;
  }

 private:
  static void dump_string(std::ostringstream& os, const std::string& s) {
    os << '"';
    for (unsigned char c : s) {
      switch (c) {
        case '"': os << "\\\""; break;
        case '\\': os << "\\\\"; break;
        case '\n': os << "\\n"; break;
        case '\r': os << "\\r"; break;
        case '\t': os << "\\t"; break;
        default:
          if (c < 0x20) {
            char buf[8];
            snprintf(buf, sizeof(buf), "\\u%04x", c);
            os << buf;
          } else {
            os << c;
          }
      }
    }
    os << '"';
  }

  static void skip_ws(const std::string& t, size_t& p) {
    while (p < t.size() && std::isspace(static_cast<unsigned char>(t[p]))) p++;
  }

  static std::optional<Json> parse_value(const std::string& t, size_t& p) {
    skip_ws(t, p);
    if (p >= t.size()) return std::nullopt;
    char c = t[p];
    if (c == '{') return parse_object(t, p);
    if (c == '[') return parse_array(t, p);
    if (c == '"') {
      auto s = parse_string(t, p);
      if (!s) return std::nullopt;
      return Json(*s);
    }
    if (t.compare(p, 4, "true") == 0) { p += 4; return Json(true); }
    if (t.compare(p, 5, "false") == 0) { p += 5; return Json(false); }
    if (t.compare(p, 4, "null") == 0) { p += 4; return Json(nullptr); }
    return parse_number(t, p);
  }

  static std::optional<Json> parse_number(const std::string& t, size_t& p) {
    size_t start = p;
    if (p < t.size() && (t[p] == '-' || t[p] == '+')) p++;
    while (p < t.size() &&
           (std::isdigit(static_cast<unsigned char>(t[p])) || t[p] == '.' ||
            t[p] == 'e' || t[p] == 'E' || t[p] == '-' || t[p] == '+')) {
      p++;
    }
    if (p == start) return std::nullopt;
    try {
      return Json(std::stod(t.substr(start, p - start)));
    } catch (...) {
      return std::nullopt;
    }
  }

  static std::optional<std::string> parse_string(const std::string& t,
                                                 size_t& p) {
    if (t[p] != '"') return std::nullopt;
    p++;
    std::string out;
    while (p < t.size()) {
      char c = t[p];
      if (c == '"') { p++; return out; }
      if (c == '\\') {
        p++;
        if (p >= t.size()) return std::nullopt;
        char e = t[p];
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'u': {
            if (p + 4 >= t.size()) return std::nullopt;
            unsigned code = 0;
            for (int i = 1; i <= 4; i++) {
              char h = t[p + i];
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else return std::nullopt;
            }
            p += 4;
            // encode UTF-8 (BMP only; surrogate pairs land as two chars)
            if (code < 0x80) {
              out += static_cast<char>(code);
            } else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default: return std::nullopt;
        }
        p++;
      } else {
        out += c;
        p++;
      }
    }
    return std::nullopt;  // unterminated
  }

  static std::optional<Json> parse_array(const std::string& t, size_t& p) {
    p++;  // consume '['
    JsonArray arr;
    skip_ws(t, p);
    if (p < t.size() && t[p] == ']') { p++; return Json(std::move(arr)); }
    while (p < t.size()) {
      auto v = parse_value(t, p);
      if (!v) return std::nullopt;
      arr.push_back(std::move(*v));
      skip_ws(t, p);
      if (p >= t.size()) return std::nullopt;
      if (t[p] == ',') { p++; continue; }
      if (t[p] == ']') { p++; return Json(std::move(arr)); }
      return std::nullopt;
    }
    return std::nullopt;
  }

  static std::optional<Json> parse_object(const std::string& t, size_t& p) {
    p++;  // consume '{'
    JsonObject obj;
    skip_ws(t, p);
    if (p < t.size() && t[p] == '}') { p++; return Json(std::move(obj)); }
    while (p < t.size()) {
      skip_ws(t, p);
      auto key = parse_string(t, p);
      if (!key) return std::nullopt;
      skip_ws(t, p);
      if (p >= t.size() || t[p] != ':') return std::nullopt;
      p++;
      auto v = parse_value(t, p);
      if (!v) return std::nullopt;
      obj[*key] = std::move(*v);
      skip_ws(t, p);
      if (p >= t.size()) return std::nullopt;
      if (t[p] == ',') { p++; continue; }
      if (t[p] == '}') { p++; return Json(std::move(obj)); }
      return std::nullopt;
    }
    return std::nullopt;
  }

  Type type_;
  bool bool_ = false;
  double num_ = 0;
  std::string str_;
  JsonArray arr_;
  JsonObject obj_;
};

}  // namespace tpumon
