#include "json.hpp"

#include <cctype>
#include <cmath>
#include <cstdio>

namespace cp {
namespace {

struct Parser {
  const std::string& text;
  size_t pos = 0;

  explicit Parser(const std::string& t) : text(t) {}

  [[noreturn]] void fail(const std::string& what) {
    throw std::runtime_error("json parse error at offset " +
                             std::to_string(pos) + ": " + what);
  }

  void skip_ws() {
    while (pos < text.size() && std::isspace(
               static_cast<unsigned char>(text[pos]))) {
      pos++;
    }
  }

  char peek() {
    if (pos >= text.size()) fail("unexpected end of input");
    return text[pos];
  }

  void expect(char c) {
    if (peek() != c) fail(std::string("expected '") + c + "'");
    pos++;
  }

  bool consume_literal(const char* lit) {
    size_t n = 0;
    while (lit[n]) n++;
    if (text.compare(pos, n, lit) == 0) {
      pos += n;
      return true;
    }
    return false;
  }

  Json parse_value() {
    skip_ws();
    char c = peek();
    switch (c) {
      case '{': return parse_object();
      case '[': return parse_array();
      case '"': return Json(parse_string());
      case 't': if (consume_literal("true")) return Json(true); fail("bad literal");
      case 'f': if (consume_literal("false")) return Json(false); fail("bad literal");
      case 'n': if (consume_literal("null")) return Json(nullptr); fail("bad literal");
      default: return parse_number();
    }
  }

  Json parse_object() {
    expect('{');
    JsonObject obj;
    skip_ws();
    if (peek() == '}') { pos++; return Json(std::move(obj)); }
    while (true) {
      skip_ws();
      std::string key = parse_string();
      skip_ws();
      expect(':');
      obj[std::move(key)] = parse_value();
      skip_ws();
      if (peek() == ',') { pos++; continue; }
      expect('}');
      return Json(std::move(obj));
    }
  }

  Json parse_array() {
    expect('[');
    JsonArray arr;
    skip_ws();
    if (peek() == ']') { pos++; return Json(std::move(arr)); }
    while (true) {
      arr.push_back(parse_value());
      skip_ws();
      if (peek() == ',') { pos++; continue; }
      expect(']');
      return Json(std::move(arr));
    }
  }

  std::string parse_string() {
    expect('"');
    std::string out;
    while (true) {
      if (pos >= text.size()) fail("unterminated string");
      char c = text[pos++];
      if (c == '"') return out;
      if (c != '\\') { out += c; continue; }
      if (pos >= text.size()) fail("bad escape");
      char e = text[pos++];
      switch (e) {
        case '"': out += '"'; break;
        case '\\': out += '\\'; break;
        case '/': out += '/'; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'n': out += '\n'; break;
        case 'r': out += '\r'; break;
        case 't': out += '\t'; break;
        case 'u': {
          if (pos + 4 > text.size()) fail("bad \\u escape");
          unsigned code = 0;
          for (int i = 0; i < 4; i++) {
            char h = text[pos++];
            code <<= 4;
            if (h >= '0' && h <= '9') code |= h - '0';
            else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
            else fail("bad hex digit");
          }
          // UTF-8 encode the BMP code point (surrogate pairs are not
          // produced by k8s object names; encode them as-is).
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
        default: fail("unknown escape");
      }
    }
  }

  Json parse_number() {
    size_t start = pos;
    if (peek() == '-') pos++;
    while (pos < text.size() &&
           (std::isdigit(static_cast<unsigned char>(text[pos])) ||
            text[pos] == '.' || text[pos] == 'e' || text[pos] == 'E' ||
            text[pos] == '+' || text[pos] == '-')) {
      pos++;
    }
    if (pos == start) fail("expected number");
    return Json(std::stod(text.substr(start, pos - start)));
  }
};

void dump_string(const std::string& s, std::string* out) {
  *out += '"';
  for (char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\b': *out += "\\b"; break;
      case '\f': *out += "\\f"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          *out += buf;
        } else {
          *out += c;
        }
    }
  }
  *out += '"';
}

void indent_to(std::string* out, int indent, int depth) {
  if (indent < 0) return;
  *out += '\n';
  out->append(static_cast<size_t>(indent) * depth, ' ');
}

}  // namespace

Json Json::parse(const std::string& text) {
  Parser p(text);
  Json v = p.parse_value();
  p.skip_ws();
  if (p.pos != text.size()) {
    throw std::runtime_error("trailing characters after JSON value");
  }
  return v;
}

void Json::dump_to(std::string* out, int indent, int depth) const {
  switch (type_) {
    case Type::Null: *out += "null"; break;
    case Type::Bool: *out += bool_ ? "true" : "false"; break;
    case Type::Number: {
      // Integers print without a trailing .0 (k8s counts, ports).
      if (std::floor(num_) == num_ && std::abs(num_) < 1e15) {
        *out += std::to_string(static_cast<int64_t>(num_));
      } else {
        char buf[32];
        std::snprintf(buf, sizeof(buf), "%.17g", num_);
        *out += buf;
      }
      break;
    }
    case Type::String: dump_string(str_, out); break;
    case Type::Array: {
      if (arr_.empty()) { *out += "[]"; break; }
      *out += '[';
      for (size_t i = 0; i < arr_.size(); i++) {
        if (i) *out += indent < 0 ? "," : ",";
        indent_to(out, indent, depth + 1);
        arr_[i].dump_to(out, indent, depth + 1);
      }
      indent_to(out, indent, depth);
      *out += ']';
      break;
    }
    case Type::Object: {
      if (obj_.empty()) { *out += "{}"; break; }
      *out += '{';
      bool first = true;
      for (const auto& kv : obj_) {
        if (!first) *out += ",";
        first = false;
        indent_to(out, indent, depth + 1);
        dump_string(kv.first, out);
        *out += indent < 0 ? ":" : ": ";
        kv.second.dump_to(out, indent, depth + 1);
      }
      indent_to(out, indent, depth);
      *out += '}';
      break;
    }
  }
}

std::string Json::dump(int indent) const {
  std::string out;
  dump_to(&out, indent, 0);
  return out;
}

}  // namespace cp
