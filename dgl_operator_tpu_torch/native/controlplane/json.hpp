// Minimal JSON value type, parser, and serializer for the control plane.
//
// The control plane speaks JSON on its process boundary (cluster state
// in, actions out) so the reconciler stays a pure function that any
// store driver — the in-process fake cluster in tests, or a kube
// API-server shim in deployment — can call. No third-party JSON
// dependency is available in this build environment, so this is a
// self-contained ~300-line implementation covering exactly the JSON
// subset k8s objects use.
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace cp {

class Json;
using JsonArray = std::vector<Json>;
// std::map keeps object keys sorted -> deterministic serialization,
// which the tests rely on for change detection (configmap updates).
using JsonObject = std::map<std::string, Json>;

class Json {
 public:
  enum class Type { Null, Bool, Number, String, Array, Object };

  Json() : type_(Type::Null) {}
  Json(std::nullptr_t) : type_(Type::Null) {}
  Json(bool b) : type_(Type::Bool), bool_(b) {}
  Json(int v) : type_(Type::Number), num_(v) {}
  Json(int64_t v) : type_(Type::Number), num_(static_cast<double>(v)) {}
  Json(double v) : type_(Type::Number), num_(v) {}
  Json(const char* s) : type_(Type::String), str_(s) {}
  Json(std::string s) : type_(Type::String), str_(std::move(s)) {}
  Json(JsonArray a) : type_(Type::Array), arr_(std::move(a)) {}
  Json(JsonObject o) : type_(Type::Object), obj_(std::move(o)) {}

  static Json object() { return Json(JsonObject{}); }
  static Json array() { return Json(JsonArray{}); }

  Type type() const { return type_; }
  bool is_null() const { return type_ == Type::Null; }
  bool is_object() const { return type_ == Type::Object; }
  bool is_array() const { return type_ == Type::Array; }
  bool is_string() const { return type_ == Type::String; }
  bool is_number() const { return type_ == Type::Number; }

  bool as_bool(bool dflt = false) const {
    return type_ == Type::Bool ? bool_ : dflt;
  }
  double as_number(double dflt = 0) const {
    return type_ == Type::Number ? num_ : dflt;
  }
  int64_t as_int(int64_t dflt = 0) const {
    return type_ == Type::Number ? static_cast<int64_t>(num_) : dflt;
  }
  const std::string& as_string() const {
    static const std::string empty;
    return type_ == Type::String ? str_ : empty;
  }

  // Object access. get() is total (returns Null for misses) so the
  // reconciler can chase optional k8s fields without branching.
  const Json& get(const std::string& key) const {
    static const Json null_value;
    if (type_ != Type::Object) return null_value;
    auto it = obj_.find(key);
    return it == obj_.end() ? null_value : it->second;
  }
  bool has(const std::string& key) const {
    return type_ == Type::Object && obj_.count(key) > 0;
  }
  Json& operator[](const std::string& key) {
    if (type_ == Type::Null) { type_ = Type::Object; }
    if (type_ != Type::Object) throw std::runtime_error("not an object");
    return obj_[key];
  }
  JsonObject& items() {
    if (type_ != Type::Object) throw std::runtime_error("not an object");
    return obj_;
  }
  const JsonObject& items() const {
    static const JsonObject empty;
    return type_ == Type::Object ? obj_ : empty;
  }

  // Array access.
  JsonArray& elems() {
    if (type_ == Type::Null) { type_ = Type::Array; }
    if (type_ != Type::Array) throw std::runtime_error("not an array");
    return arr_;
  }
  const JsonArray& elems() const {
    static const JsonArray empty;
    return type_ == Type::Array ? arr_ : empty;
  }
  void push_back(Json v) { elems().push_back(std::move(v)); }
  size_t size() const {
    return type_ == Type::Array ? arr_.size()
         : type_ == Type::Object ? obj_.size() : 0;
  }

  std::string dump(int indent = -1) const;
  static Json parse(const std::string& text);

  bool operator==(const Json& other) const {
    if (type_ != other.type_) return false;
    switch (type_) {
      case Type::Null: return true;
      case Type::Bool: return bool_ == other.bool_;
      case Type::Number: return num_ == other.num_;
      case Type::String: return str_ == other.str_;
      case Type::Array: return arr_ == other.arr_;
      case Type::Object: return obj_ == other.obj_;
    }
    return false;
  }
  bool operator!=(const Json& other) const { return !(*this == other); }

 private:
  void dump_to(std::string* out, int indent, int depth) const;

  Type type_;
  bool bool_ = false;
  double num_ = 0;
  std::string str_;
  JsonArray arr_;
  JsonObject obj_;
};

}  // namespace cp
