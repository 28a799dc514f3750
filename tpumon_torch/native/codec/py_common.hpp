// py_common.hpp — CPython binding helpers shared by the codec and
// poll extension modules (`_tpumon_torch_codec`, `_tpumon_torch_poll`).
//
// Textually included inside each module's anonymous namespace (like
// the rest of the binding layer), AFTER <Python.h> and codec/core.hpp:
// every definition here is internal linkage per translation unit, so
// the two extensions never export or collide on these symbols.
//
//   * Guard / enter_handle — the single-owner busy-flag discipline
//     every native handle type enforces (GIL-serialized, so the check
//     is race-free, and concurrent entry is a loud RuntimeError).
//   * drain_released — frees the PyObject cookies a GIL-released
//     region dropped (identity caches, dirty cells), once the GIL is
//     back.
//   * value_to_py / cached_key / cell_obj / chip_template — the
//     decoder-mirror materialization fast path: cached int keys,
//     per-cell cached value objects rebuilt only when dirty, and the
//     per-chip template dict bulk-copied per materialize.  The key
//     and template caches are per-HANDLE (each caller passes its own
//     key_cache dict), so handles stay single-owner end to end.

#pragma once

struct Guard {
  int* busy;
  explicit Guard(int* b) : busy(b) { *busy = 1; }
  ~Guard() { *busy = 0; }
};

int enter_handle(int* busy, int closed, const char* what) {
  if (closed) {
    PyErr_Format(PyExc_ValueError, "native %s handle is closed", what);
    return -1;
  }
  if (*busy) {
    PyErr_Format(PyExc_RuntimeError,
                 "concurrent use of a native %s handle (codec handles "
                 "are single-owner; wrap cross-thread use in your own "
                 "lock or give each thread its own handle)",
                 what);
    return -1;
  }
  return 0;
}

void drain_released(std::vector<void*>* released) {
  for (void* p : *released) Py_DECREF(reinterpret_cast<PyObject*>(p));
  released->clear();
}

// NValue -> fresh Python object (decoder materialize path)
PyObject* value_to_py(const nc::NValue& v) {
  switch (v.kind) {
    case nc::NValue::kBlank:
      Py_RETURN_NONE;
    case nc::NValue::kBool:
      return PyBool_FromLong(v.i ? 1 : 0);
    case nc::NValue::kInt:
      return PyLong_FromLongLong(v.i);
    case nc::NValue::kBigInt:
      // unreachable from the wire (decode yields int64 zigzag only)
      return PyLong_FromUnsignedLongLong(v.zig);
    case nc::NValue::kFloat:
      return PyFloat_FromDouble(v.d);
    case nc::NValue::kStr:
      // "replace" like the reference's decode("utf-8", "replace")
      return PyUnicode_DecodeUTF8(v.s.data(),
                                  static_cast<Py_ssize_t>(v.s.size()),
                                  "replace");
    case nc::NValue::kVec: {
      PyObject* lst = PyList_New(static_cast<Py_ssize_t>(v.vec.size()));
      if (lst == nullptr) return nullptr;
      for (size_t k = 0; k < v.vec.size(); k++) {
        const nc::NValue::Elem& e = v.vec[k];
        PyObject* o;
        if (e.kind == nc::NValue::kBlank) {
          o = Py_None;
          Py_INCREF(o);
        } else if (e.kind == nc::NValue::kFloat) {
          o = PyFloat_FromDouble(e.d);
        } else if (e.kind == nc::NValue::kBool) {
          o = PyBool_FromLong(e.i ? 1 : 0);
        } else {
          o = PyLong_FromLongLong(e.i);
        }
        if (o == nullptr) {
          Py_DECREF(lst);
          return nullptr;
        }
        PyList_SET_ITEM(lst, static_cast<Py_ssize_t>(k), o);
      }
      return lst;
    }
  }
  PyErr_SetString(PyExc_SystemError, "corrupt native value");
  return nullptr;
}

// cached int -> PyLong key (borrowed from the cache dict)
PyObject* cached_key(PyObject* key_cache, unsigned long long v) {
  PyObject* k = PyLong_FromUnsignedLongLong(v);
  if (k == nullptr) return nullptr;
  PyObject* hit = PyDict_GetItemWithError(key_cache, k);
  if (hit != nullptr) {
    Py_DECREF(k);
    return hit;  // borrowed
  }
  if (PyErr_Occurred()) {
    Py_DECREF(k);
    return nullptr;
  }
  if (PyDict_SetItem(key_cache, k, k) < 0) {
    Py_DECREF(k);
    return nullptr;
  }
  Py_DECREF(k);
  return PyDict_GetItem(key_cache, k);  // borrowed; just inserted
}

// cell's cached materialized object (borrowed); rebuilds when dirty
PyObject* cell_obj(nc::MirCell* cell) {
  if (cell->dirty || cell->cookie == nullptr) {
    PyObject* fresh = value_to_py(cell->v);
    if (fresh == nullptr) return nullptr;
    if (cell->cookie != nullptr)
      Py_DECREF(reinterpret_cast<PyObject*>(cell->cookie));
    cell->cookie = reinterpret_cast<void*>(fresh);
    cell->dirty = false;
  }
  return reinterpret_cast<PyObject*>(cell->cookie);
}

// the chip's cached template dict (borrowed): the fully materialized
// {fid: value} refreshed for stale fids only, bulk-copied per call —
// dict(chip_m) speed with O(changes) maintenance
PyObject* chip_template(PyObject* key_cache, nc::MirChip* chip) {
  PyObject* t = reinterpret_cast<PyObject*>(chip->tmpl);
  if (t == nullptr) {
    t = PyDict_New();
    if (t == nullptr) return nullptr;
    chip->tmpl = reinterpret_cast<void*>(t);
    chip->stale.clear();
    for (auto& kv : chip->cells) {
      PyObject* k = cached_key(key_cache, kv.first);
      PyObject* v = k == nullptr ? nullptr : cell_obj(&kv.second);
      if (v == nullptr || PyDict_SetItem(t, k, v) < 0) return nullptr;
    }
    return t;
  }
  if (!chip->stale.empty()) {
    for (unsigned long long fid : chip->stale) {
      nc::MirCell* cell = chip->find(fid);
      if (cell == nullptr) continue;
      PyObject* k = cached_key(key_cache, fid);
      PyObject* v = k == nullptr ? nullptr : cell_obj(cell);
      if (v == nullptr || PyDict_SetItem(t, k, v) < 0) return nullptr;
    }
    chip->stale.clear();
  }
  return t;
}
