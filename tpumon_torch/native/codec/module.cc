// module.cc — CPython bindings of the shared native codec core
// (`_tpumon_torch_codec`).  Three opaque native-owned handle types:
//
//   Encoder — the server-side per-connection delta table
//             (PySweepFrameEncoder twin)
//   Decoder — the client-side mirror (PySweepFrameDecoder twin) plus
//             the fleet aggregate fast path
//   Burst   — the windowed burst accumulator (PyBurstAccumulator twin)
//
// Design contract (docs/incremental_pipeline.md "native codec core"):
//
//   * The delta table / mirror is native-owned.  Python objects cross
//     the boundary once per CHANGE, never per table entry: the encoder
//     caches the last-seen object pointer per cell for an O(1)
//     identity skip, the decoder caches the materialized object per
//     mirror cell and rebuilds only dirty ones.
//   * The GIL is released around every encode / decode / fold of
//     non-trivial size; refcount traffic is deferred to a released
//     list drained after the GIL is reacquired.
//   * Handles are single-owner: concurrent entry from a second thread
//     raises RuntimeError instead of corrupting the table (the `busy`
//     flag is toggled only while the GIL is held, so the check is
//     race-free).  `close()` frees the native table immediately;
//     dropping the last reference does too.
//
// Byte-exactness is pinned by the backend-parametrized differential
// fuzz; the facades check the exposed wire constants against
// tpumon_torch/sweepframe.py / tpumon_torch/fields.py at import.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <time.h>

#include <algorithm>
#include <mutex>
#include <new>
#include <string>
#include <vector>

#include "core.hpp"

namespace nc = tpumon::codec;

namespace {

// ---- shared handle plumbing -------------------------------------------------

#include "py_common.hpp"

// masked zigzag of an arbitrary-precision Python int — exact twin of
// `((v << 1) ^ (v >> 63)) & MASK64` in tpumon_torch/wire.py
int bigint_zig(PyObject* v, unsigned long long* out) {
  unsigned long long u = PyLong_AsUnsignedLongLongMask(v);
  if (u == static_cast<unsigned long long>(-1) && PyErr_Occurred()) return -1;
  PyObject* sixty_three = PyLong_FromLong(63);
  if (sixty_three == nullptr) return -1;
  PyObject* sh = PyNumber_Rshift(v, sixty_three);
  Py_DECREF(sixty_three);
  if (sh == nullptr) return -1;
  unsigned long long u2 = PyLong_AsUnsignedLongLongMask(sh);
  Py_DECREF(sh);
  if (u2 == static_cast<unsigned long long>(-1) && PyErr_Occurred())
    return -1;
  *out = (u << 1) ^ u2;
  return 0;
}

// one Python FieldValue -> NValue; exact core types only (the pure-
// Python reference tolerates odd subclasses — those stay on the
// reference path)
int convert_value(PyObject* v, nc::NValue* out) {
  out->vec.clear();
  out->s.clear();
  if (v == Py_None) {
    out->kind = nc::NValue::kBlank;
    return 0;
  }
  if (PyBool_Check(v)) {
    out->kind = nc::NValue::kBool;
    out->i = (v == Py_True) ? 1 : 0;
    return 0;
  }
  if (PyLong_CheckExact(v)) {
    int overflow = 0;
    long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (x == -1 && PyErr_Occurred()) return -1;
    if (!overflow) {
      out->kind = nc::NValue::kInt;
      out->i = x;
      return 0;
    }
    out->kind = nc::NValue::kBigInt;
    return bigint_zig(v, &out->zig);
  }
  if (PyFloat_CheckExact(v)) {
    out->kind = nc::NValue::kFloat;
    out->d = PyFloat_AS_DOUBLE(v);
    return 0;
  }
  if (PyUnicode_CheckExact(v)) {
    Py_ssize_t sz = 0;
    // raises UnicodeEncodeError on lone surrogates exactly like the
    // reference's value.encode("utf-8")
    const char* p = PyUnicode_AsUTF8AndSize(v, &sz);
    if (p == nullptr) return -1;
    out->kind = nc::NValue::kStr;
    out->s.assign(p, static_cast<size_t>(sz));
    return 0;
  }
  if (PyList_CheckExact(v)) {
    out->kind = nc::NValue::kVec;
    Py_ssize_t n = PyList_GET_SIZE(v);
    out->vec.reserve(static_cast<size_t>(n));
    for (Py_ssize_t k = 0; k < n; k++) {
      PyObject* e = PyList_GET_ITEM(v, k);
      nc::NValue::Elem el;
      if (e == Py_None) {
        el.kind = nc::NValue::kBlank;
      } else if (PyBool_Check(e)) {
        el.kind = nc::NValue::kBool;
        el.i = (e == Py_True) ? 1 : 0;
      } else if (PyLong_CheckExact(e)) {
        int overflow = 0;
        long long x = PyLong_AsLongLongAndOverflow(e, &overflow);
        if (x == -1 && PyErr_Occurred()) return -1;
        if (!overflow) {
          el.kind = nc::NValue::kInt;
          el.i = x;
        } else {
          el.kind = nc::NValue::kBigInt;
          if (bigint_zig(e, &el.zig) < 0) return -1;
        }
      } else if (PyFloat_CheckExact(e)) {
        el.kind = nc::NValue::kFloat;
        el.d = PyFloat_AS_DOUBLE(e);
      } else {
        PyErr_Format(PyExc_TypeError,
                     "unsupported sweep vector element type %.100s",
                     Py_TYPE(e)->tp_name);
        return -1;
      }
      // element identity cookie: Python list == short-circuits on
      // `x is y` before __eq__, so equality needs the object pointer
      Py_INCREF(e);
      el.cookie = reinterpret_cast<void*>(e);
      out->vec.push_back(el);
    }
    return 0;
  }
  PyErr_Format(PyExc_TypeError,
               "unsupported sweep value type %.100s (the native codec "
               "takes None/bool/int/float/str/list)",
               Py_TYPE(v)->tp_name);
  return -1;
}

// ---- Encoder ----------------------------------------------------------------

struct EncoderObj {
  PyObject_HEAD
  nc::EncoderCore* core;
  std::vector<nc::PendChip>* pending;
  std::vector<nc::PendEntry>* arena;
  std::vector<void*>* released;
  int busy;
  int closed;
};

PyObject* Encoder_new(PyTypeObject* type, PyObject* args, PyObject* kwds) {
  long long start_index = 0;
  static const char* kwlist[] = {"start_index", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "|L",
                                   const_cast<char**>(kwlist),
                                   &start_index))
    return nullptr;
  EncoderObj* self =
      reinterpret_cast<EncoderObj*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->core = new (std::nothrow) nc::EncoderCore(start_index);
  self->pending = new (std::nothrow) std::vector<nc::PendChip>();
  self->arena = new (std::nothrow) std::vector<nc::PendEntry>();
  self->released = new (std::nothrow) std::vector<void*>();
  self->busy = 0;
  self->closed = 0;
  if (self->core == nullptr || self->pending == nullptr ||
      self->arena == nullptr || self->released == nullptr) {
    Py_DECREF(self);
    PyErr_NoMemory();
    return nullptr;
  }
  return reinterpret_cast<PyObject*>(self);
}

void Encoder_close_impl(EncoderObj* self) {
  if (self->core != nullptr) {
    std::vector<void*> rel;
    self->core->release_all(&rel);
    drain_released(&rel);
  }
  delete self->core;
  self->core = nullptr;
  delete self->pending;
  self->pending = nullptr;
  delete self->arena;
  self->arena = nullptr;
  delete self->released;
  self->released = nullptr;
  self->closed = 1;
}

void Encoder_dealloc(EncoderObj* self) {
  Encoder_close_impl(self);
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* Encoder_close(EncoderObj* self, PyObject*) {
  if (self->busy) {
    PyErr_SetString(PyExc_RuntimeError,
                    "concurrent close of a native encoder handle");
    return nullptr;
  }
  Encoder_close_impl(self);
  Py_RETURN_NONE;
}

PyObject* Encoder_encode_frame(EncoderObj* self, PyObject* args) {
  PyObject* chips;
  Py_buffer events_blob = {};
  int partial = 0;
  if (!PyArg_ParseTuple(args, "O!y*p", &PyDict_Type, &chips,
                        &events_blob, &partial))
    return nullptr;
  if (enter_handle(&self->busy, self->closed, "encoder") < 0) {
    PyBuffer_Release(&events_blob);
    return nullptr;
  }
  Guard guard(&self->busy);
  std::vector<nc::PendChip>& pending = *self->pending;
  std::vector<nc::PendEntry>& arena = *self->arena;
  std::vector<void*>& released = *self->released;
  pending.clear();
  arena.clear();

  // phase 1 (GIL held): walk the input dict; identity-skip unchanged
  // objects against the table cookies, convert the rest into the arena
  bool failed = false;
  PyObject *key, *vals;
  Py_ssize_t cpos = 0;
  while (!failed && PyDict_Next(chips, &cpos, &key, &vals)) {
    long long idx;
    if (PyLong_CheckExact(key) || PyLong_Check(key)) {
      idx = PyLong_AsLongLong(key);
      if (idx == -1 && PyErr_Occurred()) {
        failed = true;
        break;
      }
    } else {
      PyErr_SetString(PyExc_TypeError, "chip index must be an int");
      failed = true;
      break;
    }
    if (!PyDict_Check(vals)) {
      PyErr_SetString(PyExc_TypeError, "chip values must be a dict");
      failed = true;
      break;
    }
    nc::PendChip pc;
    pc.idx = idx;
    pc.begin = arena.size();
    nc::EncChip* chip = self->core->find_chip(idx);
    PyObject *fkey, *v;
    Py_ssize_t fpos = 0;
    while (PyDict_Next(vals, &fpos, &fkey, &v)) {
      long long fid = PyLong_AsLongLong(fkey);
      if (fid == -1 && PyErr_Occurred()) {
        failed = true;
        break;
      }
      if (chip != nullptr) {
        auto it = chip->cells.find(fid);
        if (it != chip->cells.end()) {
          nc::EncCell& cell = it->second;
          if (cell.cookie == reinterpret_cast<void*>(v))
            continue;  // the reference's `prev is v` fast path
          if (cell.v.kind == nc::NValue::kBigInt &&
              PyLong_CheckExact(v)) {
            // exact Python == against the cached big-int object (the
            // masked native form is not value-exact beyond 64 bits)
            int eq = PyObject_RichCompareBool(
                reinterpret_cast<PyObject*>(cell.cookie), v, Py_EQ);
            if (eq < 0) {
              failed = true;
              break;
            }
            if (eq) continue;  // unchanged: keep the old object
          }
        }
      }
      arena.emplace_back();
      nc::PendEntry& e = arena.back();
      e.fid = fid;
      if (convert_value(v, &e.v) < 0) {
        // keep the partial entry in the arena: the failure drain below
        // releases any element refs it already took
        failed = true;
        break;
      }
      if (e.v.kind == nc::NValue::kVec) {
        // the reference stores a COPY of list values (never the
        // caller's object), so identity can never match next tick —
        // no cookie
        e.cookie = nullptr;
      } else {
        Py_INCREF(v);
        e.cookie = reinterpret_cast<void*>(v);
      }
    }
    pc.end = arena.size();
    pending.push_back(pc);
  }
  if (failed) {
    // nothing was committed to the table; drop the refs phase 1 took
    for (nc::PendEntry& e : arena) {
      if (e.cookie != nullptr)
        Py_DECREF(reinterpret_cast<PyObject*>(e.cookie));
      for (const nc::NValue::Elem& el : e.v.vec)
        if (el.cookie != nullptr)
          Py_DECREF(reinterpret_cast<PyObject*>(el.cookie));
    }
    PyBuffer_Release(&events_blob);
    return nullptr;
  }

  // phase 2 (GIL released for non-trivial frames): compare, serialize,
  // commit the table
  std::string events(static_cast<const char*>(events_blob.buf),
                     static_cast<size_t>(events_blob.len));
  PyBuffer_Release(&events_blob);
  std::string out;
  // same threshold rationale as apply: only a multi-hundred-entry
  // serialize amortizes the GIL round trip under thread contention
  if (arena.size() + pending.size() > 512) {
    Py_BEGIN_ALLOW_THREADS
    self->core->encode(&pending, &arena, partial != 0, events, &out,
                       &released);
    Py_END_ALLOW_THREADS
  } else {
    self->core->encode(&pending, &arena, partial != 0, events, &out,
                       &released);
  }
  drain_released(&released);
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyObject* Encoder_encode_index_only(EncoderObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "encoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  std::string out;
  self->core->encode_index_only(&out);
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyObject* Encoder_table_entries(EncoderObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "encoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromSize_t(self->core->table_entries());
}

PyObject* Encoder_frame_index(EncoderObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "encoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromLongLong(self->core->frame_index());
}

PyObject* Encoder_hold_for_test(EncoderObj* self, PyObject* args) {
  double seconds = 0;
  if (!PyArg_ParseTuple(args, "d", &seconds)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "encoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  Py_BEGIN_ALLOW_THREADS
  struct timespec ts;
  ts.tv_sec = static_cast<time_t>(seconds);
  ts.tv_nsec = static_cast<long>((seconds - static_cast<double>(
      static_cast<time_t>(seconds))) * 1e9);
  nanosleep(&ts, nullptr);
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

PyMethodDef Encoder_methods[] = {
    {"encode_frame", reinterpret_cast<PyCFunction>(Encoder_encode_frame),
     METH_VARARGS, "encode_frame(chips, events_blob, partial) -> bytes"},
    {"encode_index_only_frame",
     reinterpret_cast<PyCFunction>(Encoder_encode_index_only), METH_NOARGS,
     "index-only frame"},
    {"table_entries",
     reinterpret_cast<PyCFunction>(Encoder_table_entries), METH_NOARGS,
     "table entry count"},
    {"frame_index", reinterpret_cast<PyCFunction>(Encoder_frame_index),
     METH_NOARGS, "next frame index"},
    {"close", reinterpret_cast<PyCFunction>(Encoder_close), METH_NOARGS,
     "free the native table now"},
    {"_hold_for_test",
     reinterpret_cast<PyCFunction>(Encoder_hold_for_test), METH_VARARGS,
     "hold the handle busy with the GIL released (tests only)"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject EncoderType = {PyVarObject_HEAD_INIT(nullptr, 0)};

// ---- Decoder ----------------------------------------------------------------

struct DecoderObj {
  PyObject_HEAD
  nc::DecoderCore* core;
  std::vector<void*>* released;
  // request-list conversion cache, keyed on object identity (fleetpoll
  // reuses one requests list per connection, so this hits every tick)
  PyObject* req_obj;
  std::vector<std::vector<unsigned long long>>* req_fids;
  std::vector<std::pair<unsigned long long,
                        const std::vector<unsigned long long>*>>* req_vec;
  // small-int key cache for materialize (fid/chip -> PyLong)
  PyObject* key_cache;  // dict int -> int (value is the cached object)
  int busy;
  int closed;
};

void Decoder_clear_reqs(DecoderObj* self) {
  Py_CLEAR(self->req_obj);
  if (self->req_fids != nullptr) self->req_fids->clear();
  if (self->req_vec != nullptr) self->req_vec->clear();
}

PyObject* Decoder_new(PyTypeObject* type, PyObject* args, PyObject* kwds) {
  int adopt = 0;
  static const char* kwlist[] = {"adopt_first_index", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "|p",
                                   const_cast<char**>(kwlist), &adopt))
    return nullptr;
  DecoderObj* self =
      reinterpret_cast<DecoderObj*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->core = new (std::nothrow) nc::DecoderCore(adopt != 0);
  self->released = new (std::nothrow) std::vector<void*>();
  self->req_obj = nullptr;
  self->req_fids =
      new (std::nothrow) std::vector<std::vector<unsigned long long>>();
  self->req_vec = new (std::nothrow)
      std::vector<std::pair<unsigned long long,
                            const std::vector<unsigned long long>*>>();
  self->key_cache = PyDict_New();
  self->busy = 0;
  self->closed = 0;
  if (self->core == nullptr || self->released == nullptr ||
      self->req_fids == nullptr || self->req_vec == nullptr ||
      self->key_cache == nullptr) {
    Py_DECREF(self);
    PyErr_NoMemory();
    return nullptr;
  }
  return reinterpret_cast<PyObject*>(self);
}

void Decoder_close_impl(DecoderObj* self) {
  if (self->core != nullptr) {
    std::vector<void*> rel;
    self->core->release_all(&rel);
    drain_released(&rel);
  }
  delete self->core;
  self->core = nullptr;
  delete self->released;
  self->released = nullptr;
  Decoder_clear_reqs(self);
  delete self->req_fids;
  self->req_fids = nullptr;
  delete self->req_vec;
  self->req_vec = nullptr;
  Py_CLEAR(self->key_cache);
  self->closed = 1;
}

void Decoder_dealloc(DecoderObj* self) {
  Decoder_close_impl(self);
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* Decoder_close(DecoderObj* self, PyObject*) {
  if (self->busy) {
    PyErr_SetString(PyExc_RuntimeError,
                    "concurrent close of a native decoder handle");
    return nullptr;
  }
  Decoder_close_impl(self);
  Py_RETURN_NONE;
}

PyObject* Decoder_apply(DecoderObj* self, PyObject* args) {
  Py_buffer buf = {};
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "decoder") < 0) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Guard guard(&self->busy);
  const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
  size_t n = static_cast<size_t>(buf.len);
  nc::ApplyResult res;
  std::vector<void*>& released = *self->released;
  // release the GIL only for genuinely large frames (keyframes, shard
  // aggregates, stream catch-ups): for a per-host churn delta (~1 KB)
  // the release/reacquire round trip costs more than the parse, and
  // in a 16-shard convoy the contended reacquire dominates
  if (n > 4096) {
    Py_BEGIN_ALLOW_THREADS
    res = self->core->apply(data, n, &released);
    Py_END_ALLOW_THREADS
  } else {
    res = self->core->apply(data, n, &released);
  }
  drain_released(&released);
  if (!res.error.empty()) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, res.error.c_str());
    return nullptr;
  }
  PyObject* events = PyList_New(static_cast<Py_ssize_t>(res.events.size()));
  if (events == nullptr) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  for (size_t i = 0; i < res.events.size(); i++) {
    PyObject* b = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(data) + res.events[i].first,
        static_cast<Py_ssize_t>(res.events[i].second));
    if (b == nullptr) {
      Py_DECREF(events);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    PyList_SET_ITEM(events, static_cast<Py_ssize_t>(i), b);
  }
  PyBuffer_Release(&buf);
  return events;
}

// fused try_split_frame + apply: parse one framed message (magic +
// varint length + payload) from the head of a receive buffer, in
// place — no payload slice object, one call per frame on the fleet
// hot path.  Returns None when more bytes are needed, else
// (total_consumed, changes, [event_bytes...]).
PyObject* Decoder_try_apply(DecoderObj* self, PyObject* args) {
  Py_buffer buf = {};
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "decoder") < 0) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Guard guard(&self->busy);
  const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
  size_t n = static_cast<size_t>(buf.len);
  // varint length after the (already-matched) magic byte —
  // try_split_frame's exact semantics, including its error string
  size_t pos = 1;
  unsigned long long length = 0;
  int shift = 0;
  while (true) {
    if (pos >= n) {
      PyBuffer_Release(&buf);
      Py_RETURN_NONE;
    }
    uint8_t b = data[pos];
    pos++;
    length |= static_cast<unsigned long long>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 63) {
      PyBuffer_Release(&buf);
      PyErr_SetString(PyExc_ValueError, "malformed sweep frame length");
      return nullptr;
    }
  }
  if (length > n || pos + static_cast<size_t>(length) > n) {
    PyBuffer_Release(&buf);
    Py_RETURN_NONE;
  }
  const uint8_t* payload = data + pos;
  size_t plen = static_cast<size_t>(length);
  nc::ApplyResult res;
  std::vector<void*>& released = *self->released;
  if (plen > 4096) {
    Py_BEGIN_ALLOW_THREADS
    res = self->core->apply(payload, plen, &released);
    Py_END_ALLOW_THREADS
  } else {
    res = self->core->apply(payload, plen, &released);
  }
  drain_released(&released);
  if (!res.error.empty()) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, res.error.c_str());
    return nullptr;
  }
  PyObject* events =
      PyList_New(static_cast<Py_ssize_t>(res.events.size()));
  if (events == nullptr) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  for (size_t i = 0; i < res.events.size(); i++) {
    PyObject* b = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(payload) + res.events[i].first,
        static_cast<Py_ssize_t>(res.events[i].second));
    if (b == nullptr) {
      Py_DECREF(events);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    PyList_SET_ITEM(events, static_cast<Py_ssize_t>(i), b);
  }
  PyBuffer_Release(&buf);
  return Py_BuildValue("nLN",
                       static_cast<Py_ssize_t>(pos + plen),
                       self->core->last_changes(), events);
}

int convert_requests(DecoderObj* self, PyObject* requests) {
  if (self->req_obj == requests) return 0;  // identity cache hit
  Decoder_clear_reqs(self);
  PyObject* fast = PySequence_Fast(requests, "requests must be a sequence");
  if (fast == nullptr) return -1;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  self->req_fids->reserve(static_cast<size_t>(n));
  std::vector<unsigned long long> idxs;
  idxs.reserve(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    PyObject* fast2 = PySequence_Fast(
        item, "request entries must be (chip, fids)");
    if (fast2 == nullptr || PySequence_Fast_GET_SIZE(fast2) != 2) {
      Py_XDECREF(fast2);
      Py_DECREF(fast);
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_TypeError,
                        "request entries must be (chip, fids)");
      return -1;
    }
    unsigned long long idx = PyLong_AsUnsignedLongLongMask(
        PySequence_Fast_GET_ITEM(fast2, 0));
    if (idx == static_cast<unsigned long long>(-1) && PyErr_Occurred()) {
      Py_DECREF(fast2);
      Py_DECREF(fast);
      return -1;
    }
    PyObject* fids = PySequence_Fast(
        PySequence_Fast_GET_ITEM(fast2, 1), "fids must be a sequence");
    if (fids == nullptr) {
      Py_DECREF(fast2);
      Py_DECREF(fast);
      return -1;
    }
    std::vector<unsigned long long> fv;
    Py_ssize_t nf = PySequence_Fast_GET_SIZE(fids);
    fv.reserve(static_cast<size_t>(nf));
    for (Py_ssize_t k = 0; k < nf; k++) {
      unsigned long long f = PyLong_AsUnsignedLongLongMask(
          PySequence_Fast_GET_ITEM(fids, k));
      if (f == static_cast<unsigned long long>(-1) && PyErr_Occurred()) {
        Py_DECREF(fids);
        Py_DECREF(fast2);
        Py_DECREF(fast);
        return -1;
      }
      fv.push_back(f);
    }
    Py_DECREF(fids);
    Py_DECREF(fast2);
    self->req_fids->push_back(std::move(fv));
    idxs.push_back(idx);
  }
  Py_DECREF(fast);
  // second pass: the fids vectors are stable now, take their addresses
  self->req_vec->reserve(idxs.size());
  for (size_t i = 0; i < idxs.size(); i++)
    self->req_vec->emplace_back(idxs[i], &(*self->req_fids)[i]);
  Py_INCREF(requests);
  self->req_obj = requests;
  return 0;
}

PyObject* Decoder_materialize(DecoderObj* self, PyObject* args) {
  PyObject* requests;
  if (!PyArg_ParseTuple(args, "O", &requests)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "decoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (convert_requests(self, requests) < 0) return nullptr;
  PyObject* out = PyDict_New();
  if (out == nullptr) return nullptr;
  for (const auto& rq : *self->req_vec) {
    nc::MirChip* chip = self->core->find_chip(rq.first);
    if (chip == nullptr) continue;
    PyObject* vals = PyDict_New();
    if (vals == nullptr) goto fail;
    if (chip->cells.size() == rq.second->size()) {
      // whole-chip fast path: the reference copies the mirror dict
      // as-is (insertion order) — served from the chip template at
      // dict-copy speed
      Py_DECREF(vals);
      PyObject* t = chip_template(self->key_cache, chip);
      vals = t == nullptr ? nullptr : PyDict_Copy(t);
      if (vals == nullptr) goto fail;
    } else {
      for (unsigned long long f : *rq.second) {
        nc::MirCell* cell = chip->find(f);
        if (cell == nullptr) continue;
        PyObject* k = cached_key(self->key_cache, f);
        PyObject* v = k == nullptr ? nullptr : cell_obj(cell);
        if (v == nullptr || PyDict_SetItem(vals, k, v) < 0) {
          Py_DECREF(vals);
          goto fail;
        }
      }
    }
    {
      PyObject* ck = cached_key(self->key_cache, rq.first);
      if (ck == nullptr || PyDict_SetItem(out, ck, vals) < 0) {
        Py_DECREF(vals);
        goto fail;
      }
      Py_DECREF(vals);
    }
  }
  return out;
fail:
  Py_DECREF(out);
  return nullptr;
}

PyObject* Decoder_mirror_snapshot(DecoderObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "decoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  PyObject* out = PyDict_New();
  if (out == nullptr) return nullptr;
  bool failed = false;
  self->core->each_chip([&](nc::MirChip* chip) {
    if (failed) return;
    PyObject* t = chip_template(self->key_cache, chip);
    PyObject* vals = t == nullptr ? nullptr : PyDict_Copy(t);
    if (vals == nullptr) {
      failed = true;
      return;
    }
    PyObject* ck = cached_key(self->key_cache, chip->idx);
    if (ck == nullptr || PyDict_SetItem(out, ck, vals) < 0) failed = true;
    Py_DECREF(vals);
  });
  if (failed) {
    Py_DECREF(out);
    return nullptr;
  }
  return out;
}

PyObject* Decoder_aggregate(DecoderObj* self, PyObject* args) {
  PyObject* requests;
  long long chip_count;
  long long f_power, f_temp, f_tc, f_hbm_bw, f_used, f_total, f_links;
  if (!PyArg_ParseTuple(args, "OL(LLLLLLL)", &requests, &chip_count,
                        &f_power, &f_temp, &f_tc, &f_hbm_bw, &f_used,
                        &f_total, &f_links))
    return nullptr;
  if (enter_handle(&self->busy, self->closed, "decoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (convert_requests(self, requests) < 0) return nullptr;
  nc::AggResult r;
  if (self->core->mirror_entries() > 64) {
    Py_BEGIN_ALLOW_THREADS
    r = self->core->aggregate(*self->req_vec, chip_count, f_power,
                              f_temp, f_tc, f_hbm_bw, f_used, f_total,
                              f_links);
    Py_END_ALLOW_THREADS
  } else {
    r = self->core->aggregate(*self->req_vec, chip_count, f_power,
                              f_temp, f_tc, f_hbm_bw, f_used, f_total,
                              f_links);
  }
  if (r.nan_error) {
    PyErr_SetString(PyExc_ValueError,
                    "cannot convert float NaN to integer");
    return nullptr;
  }
  if (r.inf_error) {
    PyErr_SetString(PyExc_OverflowError,
                    "cannot convert float infinity to integer");
    return nullptr;
  }
  if (r.overflow) {
    // a value the native number model cannot hold exactly: the facade
    // falls back to the Python aggregate
    PyErr_SetString(PyExc_OverflowError, "native aggregate overflow");
    return nullptr;
  }
  PyObject* max_temp =
      r.has_temp ? PyLong_FromLongLong(r.max_temp) : Py_NewRef(Py_None);
  PyObject* mean_tc =
      r.tc_n ? PyFloat_FromDouble(r.tc_sum / static_cast<double>(r.tc_n))
             : Py_NewRef(Py_None);
  PyObject* mean_hbm =
      r.hbm_n
          ? PyFloat_FromDouble(r.hbm_sum / static_cast<double>(r.hbm_n))
          : Py_NewRef(Py_None);
  if (max_temp == nullptr || mean_tc == nullptr || mean_hbm == nullptr) {
    Py_XDECREF(max_temp);
    Py_XDECREF(mean_tc);
    Py_XDECREF(mean_hbm);
    return nullptr;
  }
  return Py_BuildValue("LLdNNNLLL", r.live_fields, r.dead_chips,
                       r.power_w, max_temp, mean_tc, mean_hbm,
                       r.hbm_used, r.hbm_total, r.links_up);
}

PyObject* Decoder_last_changes(DecoderObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "decoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromLongLong(self->core->last_changes());
}

PyObject* Decoder_next_frame_index(DecoderObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "decoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromLongLong(self->core->next_frame_index());
}

PyObject* Decoder_mirror_entries(DecoderObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "decoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromSize_t(self->core->mirror_entries());
}

PyObject* Decoder_hold_for_test(DecoderObj* self, PyObject* args) {
  double seconds = 0;
  if (!PyArg_ParseTuple(args, "d", &seconds)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "decoder") < 0)
    return nullptr;
  Guard guard(&self->busy);
  Py_BEGIN_ALLOW_THREADS
  struct timespec ts;
  ts.tv_sec = static_cast<time_t>(seconds);
  ts.tv_nsec = static_cast<long>((seconds - static_cast<double>(
      static_cast<time_t>(seconds))) * 1e9);
  nanosleep(&ts, nullptr);
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

PyMethodDef Decoder_methods[] = {
    {"apply", reinterpret_cast<PyCFunction>(Decoder_apply), METH_VARARGS,
     "apply(payload) -> [event_bytes, ...]"},
    {"try_apply", reinterpret_cast<PyCFunction>(Decoder_try_apply),
     METH_VARARGS,
     "try_apply(buffer) -> None | (used, changes, [event_bytes...])"},
    {"materialize", reinterpret_cast<PyCFunction>(Decoder_materialize),
     METH_VARARGS, "materialize(requests) -> {chip: {fid: value}}"},
    {"mirror_snapshot",
     reinterpret_cast<PyCFunction>(Decoder_mirror_snapshot), METH_NOARGS,
     "full mirror snapshot"},
    {"aggregate", reinterpret_cast<PyCFunction>(Decoder_aggregate),
     METH_VARARGS,
     "aggregate(requests, chip_count, fid7) -> host aggregate tuple"},
    {"last_changes", reinterpret_cast<PyCFunction>(Decoder_last_changes),
     METH_NOARGS, "mutations of the last applied frame"},
    {"next_frame_index",
     reinterpret_cast<PyCFunction>(Decoder_next_frame_index), METH_NOARGS,
     "expected next frame index"},
    {"mirror_entries",
     reinterpret_cast<PyCFunction>(Decoder_mirror_entries), METH_NOARGS,
     "mirror entry count"},
    {"close", reinterpret_cast<PyCFunction>(Decoder_close), METH_NOARGS,
     "free the native mirror now"},
    {"_hold_for_test",
     reinterpret_cast<PyCFunction>(Decoder_hold_for_test), METH_VARARGS,
     "hold the handle busy with the GIL released (tests only)"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject DecoderType = {PyVarObject_HEAD_INIT(nullptr, 0)};

// ---- Burst ------------------------------------------------------------------

struct BurstObj {
  PyObject_HEAD
  nc::BurstCore* core;
  std::mutex* mu;
  std::vector<nc::BurstSample>* scratch;
  int closed;
};

PyObject* Burst_new(PyTypeObject* type, PyObject* args, PyObject* kwds) {
  if (!PyArg_ParseTuple(args, "")) return nullptr;
  (void)kwds;
  BurstObj* self = reinterpret_cast<BurstObj*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->core = new (std::nothrow) nc::BurstCore();
  self->mu = new (std::nothrow) std::mutex();
  self->scratch = new (std::nothrow) std::vector<nc::BurstSample>();
  self->closed = 0;
  if (self->core == nullptr || self->mu == nullptr ||
      self->scratch == nullptr) {
    Py_DECREF(self);
    PyErr_NoMemory();
    return nullptr;
  }
  return reinterpret_cast<PyObject*>(self);
}

void Burst_dealloc(BurstObj* self) {
  delete self->core;
  delete self->mu;
  delete self->scratch;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

int burst_check(BurstObj* self) {
  if (self->closed || self->core == nullptr) {
    PyErr_SetString(PyExc_ValueError, "native burst handle is closed");
    return -1;
  }
  return 0;
}

// poison-only close (symmetry with Encoder/Decoder.close): entries
// after close raise ValueError; the window table itself is freed at
// dealloc, so a fold mid-flight on another thread can never race a
// deletion
PyObject* Burst_close(BurstObj* self, PyObject*) {
  self->closed = 1;
  Py_RETURN_NONE;
}

PyObject* Burst_fold(BurstObj* self, PyObject* args) {
  long long chip, fid;
  double t, v;
  if (!PyArg_ParseTuple(args, "LLdd", &chip, &fid, &t, &v)) return nullptr;
  if (burst_check(self) < 0) return nullptr;
  {
    std::lock_guard<std::mutex> g(*self->mu);
    self->core->fold(chip, fid, t, v);
  }
  Py_RETURN_NONE;
}

PyObject* Burst_fold_series(BurstObj* self, PyObject* args) {
  long long chip, fid;
  PyObject *ts, *vs;
  if (!PyArg_ParseTuple(args, "LLOO", &chip, &fid, &ts, &vs))
    return nullptr;
  if (burst_check(self) < 0) return nullptr;
  PyObject* fts = PySequence_Fast(ts, "ts must be a sequence");
  if (fts == nullptr) return nullptr;
  PyObject* fvs = PySequence_Fast(vs, "vs must be a sequence");
  if (fvs == nullptr) {
    Py_DECREF(fts);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fts);
  Py_ssize_t nv = PySequence_Fast_GET_SIZE(fvs);
  if (nv < n) n = nv;  // zip() semantics
  std::vector<nc::BurstSample>& scratch = *self->scratch;
  scratch.clear();
  scratch.reserve(static_cast<size_t>(n));
  bool bad_sample = false;
  for (Py_ssize_t i = 0; i < n && !bad_sample; i++) {
    PyObject* to = PySequence_Fast_GET_ITEM(fts, i);
    PyObject* vo = PySequence_Fast_GET_ITEM(fvs, i);
    nc::BurstSample s;
    // the reference discards None / str / list samples (subclasses
    // included) before float coercion
    if (vo == Py_None || PyUnicode_Check(vo) || PyList_Check(vo)) {
      s.skip = true;
      // a skipped sample never reads its timestamp either
      scratch.push_back(s);
      continue;
    }
    s.t = PyFloat_AsDouble(to);
    if (s.t == -1.0 && PyErr_Occurred()) {
      bad_sample = true;  // fold the converted prefix, then raise —
      break;              // the reference folds sample-by-sample
    }
    s.v = PyFloat_AsDouble(vo);
    if (s.v == -1.0 && PyErr_Occurred()) {
      bad_sample = true;
      break;
    }
    scratch.push_back(s);
  }
  Py_DECREF(fts);
  Py_DECREF(fvs);
  if (bad_sample) {
    {
      std::lock_guard<std::mutex> g(*self->mu);
      self->core->fold_series(chip, fid, scratch);
    }
    return nullptr;  // the conversion error is already set
  }
  if (scratch.size() > 64) {
    Py_BEGIN_ALLOW_THREADS
    {
      std::lock_guard<std::mutex> g(*self->mu);
      self->core->fold_series(chip, fid, scratch);
    }
    Py_END_ALLOW_THREADS
  } else {
    std::lock_guard<std::mutex> g(*self->mu);
    self->core->fold_series(chip, fid, scratch);
  }
  Py_RETURN_NONE;
}

PyObject* Burst_harvest(BurstObj* self, PyObject*) {
  if (burst_check(self) < 0) return nullptr;
  std::vector<nc::BurstHarvestEntry> entries;
  Py_BEGIN_ALLOW_THREADS
  {
    std::lock_guard<std::mutex> g(*self->mu);
    self->core->harvest(&entries);
  }
  Py_END_ALLOW_THREADS
  PyObject* out = PyDict_New();
  if (out == nullptr) return nullptr;
  PyObject* cur_chip_key = nullptr;
  PyObject* cur_vals = nullptr;
  long long cur_chip = 0;
  bool have_chip = false;
  for (const nc::BurstHarvestEntry& e : entries) {
    if (!have_chip || e.chip != cur_chip) {
      Py_XDECREF(cur_chip_key);
      cur_chip_key = PyLong_FromLongLong(e.chip);
      if (cur_chip_key == nullptr) goto fail;
      cur_vals = PyDict_GetItemWithError(out, cur_chip_key);  // borrowed
      if (cur_vals == nullptr) {
        if (PyErr_Occurred()) goto fail;
        PyObject* fresh = PyDict_New();
        if (fresh == nullptr ||
            PyDict_SetItem(out, cur_chip_key, fresh) < 0) {
          Py_XDECREF(fresh);
          goto fail;
        }
        Py_DECREF(fresh);
        cur_vals = PyDict_GetItem(out, cur_chip_key);  // borrowed
      }
      cur_chip = e.chip;
      have_chip = true;
    }
    const double aggs[4] = {e.vmin, e.vmax, e.mean, e.integral};
    for (int a = 0; a < 4; a++) {
      long long did = nc::kBurstIdBase + e.fid * 4 + a;
      PyObject* k = PyLong_FromLongLong(did);
      PyObject* v =
          nc::dumps_as_int(aggs[a])
              ? PyLong_FromLongLong(static_cast<long long>(aggs[a]))
              : PyFloat_FromDouble(aggs[a]);
      if (k == nullptr || v == nullptr ||
          PyDict_SetItem(cur_vals, k, v) < 0) {
        Py_XDECREF(k);
        Py_XDECREF(v);
        goto fail;
      }
      Py_DECREF(k);
      Py_DECREF(v);
    }
  }
  Py_XDECREF(cur_chip_key);
  return out;
fail:
  Py_XDECREF(cur_chip_key);
  Py_DECREF(out);
  return nullptr;
}

PyObject* Burst_entries(BurstObj* self, PyObject*) {
  if (burst_check(self) < 0) return nullptr;
  std::lock_guard<std::mutex> g(*self->mu);
  return PyLong_FromSize_t(self->core->entries());
}

PyObject* Burst_adopt_anchors(BurstObj* self, PyObject* args);

PyMethodDef Burst_methods[] = {
    {"fold", reinterpret_cast<PyCFunction>(Burst_fold), METH_VARARGS,
     "fold(chip, fid, t, v)"},
    {"fold_series", reinterpret_cast<PyCFunction>(Burst_fold_series),
     METH_VARARGS, "fold_series(chip, fid, ts, vs)"},
    {"harvest", reinterpret_cast<PyCFunction>(Burst_harvest), METH_NOARGS,
     "harvest() -> {chip: {derived_fid: value}}"},
    {"entries", reinterpret_cast<PyCFunction>(Burst_entries), METH_NOARGS,
     "window count"},
    {"adopt_anchors", reinterpret_cast<PyCFunction>(Burst_adopt_anchors),
     METH_VARARGS, "adopt_anchors(other)"},
    {"close", reinterpret_cast<PyCFunction>(Burst_close), METH_NOARGS,
     "poison the handle (windows freed at dealloc)"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject BurstType = {PyVarObject_HEAD_INIT(nullptr, 0)};

PyObject* Burst_adopt_anchors(BurstObj* self, PyObject* args) {
  PyObject* other;
  if (!PyArg_ParseTuple(args, "O!", &BurstType, &other)) return nullptr;
  if (burst_check(self) < 0) return nullptr;
  BurstObj* o = reinterpret_cast<BurstObj*>(other);
  if (burst_check(o) < 0) return nullptr;
  if (o == self) Py_RETURN_NONE;
  // lock in address order so concurrent cross-adoptions cannot deadlock
  std::mutex* first = self->mu < o->mu ? self->mu : o->mu;
  std::mutex* second = self->mu < o->mu ? o->mu : self->mu;
  Py_BEGIN_ALLOW_THREADS
  {
    std::lock_guard<std::mutex> g1(*first);
    std::lock_guard<std::mutex> g2(*second);
    self->core->adopt_anchors(*o->core);
  }
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

// ---- module -----------------------------------------------------------------

PyMethodDef module_methods[] = {{nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT,
    "_tpumon_torch_codec",
    "Native shared codec core: GIL-released sweep-frame encode/decode "
    "and burst fold (see docs/incremental_pipeline.md).",
    -1,
    module_methods,
    nullptr,
    nullptr,
    nullptr,
    nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__tpumon_torch_codec(void) {
  EncoderType.tp_name = "_tpumon_torch_codec.Encoder";
  EncoderType.tp_basicsize = sizeof(EncoderObj);
  EncoderType.tp_flags = Py_TPFLAGS_DEFAULT;
  EncoderType.tp_doc = "native sweep-frame encoder delta table";
  EncoderType.tp_new = Encoder_new;
  EncoderType.tp_dealloc = reinterpret_cast<destructor>(Encoder_dealloc);
  EncoderType.tp_methods = Encoder_methods;

  DecoderType.tp_name = "_tpumon_torch_codec.Decoder";
  DecoderType.tp_basicsize = sizeof(DecoderObj);
  DecoderType.tp_flags = Py_TPFLAGS_DEFAULT;
  DecoderType.tp_doc = "native sweep-frame decoder mirror";
  DecoderType.tp_new = Decoder_new;
  DecoderType.tp_dealloc = reinterpret_cast<destructor>(Decoder_dealloc);
  DecoderType.tp_methods = Decoder_methods;

  BurstType.tp_name = "_tpumon_torch_codec.Burst";
  BurstType.tp_basicsize = sizeof(BurstObj);
  BurstType.tp_flags = Py_TPFLAGS_DEFAULT;
  BurstType.tp_doc = "native burst accumulator";
  BurstType.tp_new = Burst_new;
  BurstType.tp_dealloc = reinterpret_cast<destructor>(Burst_dealloc);
  BurstType.tp_methods = Burst_methods;

  if (PyType_Ready(&EncoderType) < 0 || PyType_Ready(&DecoderType) < 0 ||
      PyType_Ready(&BurstType) < 0)
    return nullptr;

  PyObject* m = PyModule_Create(&moduledef);
  if (m == nullptr) return nullptr;
  Py_INCREF(&EncoderType);
  Py_INCREF(&DecoderType);
  Py_INCREF(&BurstType);
  if (PyModule_AddObject(m, "Encoder",
                         reinterpret_cast<PyObject*>(&EncoderType)) < 0 ||
      PyModule_AddObject(m, "Decoder",
                         reinterpret_cast<PyObject*>(&DecoderType)) < 0 ||
      PyModule_AddObject(m, "Burst",
                         reinterpret_cast<PyObject*>(&BurstType)) < 0) {
    Py_DECREF(m);
    return nullptr;
  }
  // wire constants, checked by the facades against
  // tpumon_torch/sweepframe.py and tpumon_torch/fields.py
  PyModule_AddIntConstant(m, "SWEEP_FRAME_MAGIC", nc::kSweepFrameMagic);
  PyModule_AddIntConstant(m, "SWEEP_REQ_MAGIC", nc::kSweepReqMagic);
  PyModule_AddIntConstant(m, "BURST_ID_BASE", nc::kBurstIdBase);
  PyModule_AddObject(m, "NUM_INT_LIMIT",
                     PyFloat_FromDouble(nc::kNumIntLimit));
  PyModule_AddIntConstant(m, "FRAME_FIELD_INDEX", nc::kFrameFieldIndex);
  PyModule_AddIntConstant(m, "FRAME_FIELD_CHIP", nc::kFrameFieldChip);
  PyModule_AddIntConstant(m, "FRAME_FIELD_REMOVED",
                          nc::kFrameFieldRemoved);
  PyModule_AddIntConstant(m, "FRAME_FIELD_EVENT", nc::kFrameFieldEvent);
  PyModule_AddIntConstant(m, "VALUE_FIELD_ID", nc::kValueFieldId);
  PyModule_AddIntConstant(m, "VALUE_FIELD_INT", nc::kValueFieldInt);
  PyModule_AddIntConstant(m, "VALUE_FIELD_VEC", nc::kValueFieldVec);
  PyModule_AddIntConstant(m, "VALUE_FIELD_BLANK", nc::kValueFieldBlank);
  PyModule_AddIntConstant(m, "VALUE_FIELD_STR", nc::kValueFieldStr);
  PyModule_AddIntConstant(m, "VALUE_FIELD_DOUBLE", nc::kValueFieldDouble);
  return m;
}
