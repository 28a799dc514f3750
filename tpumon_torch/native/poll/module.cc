// module.cc — CPython binding of the native poll plane
// (`_tpumon_torch_poll`): one opaque handle type, PollEngine, wrapping the
// epoll connection engine in poll/engine.hpp.
//
// Built next to the codec targets (tpumon_torch/_build.py) and loaded
// by tpumon_torch/_poll.py under the same TPUMON_NATIVE convention as the
// codec extension.  The engine holds the per-connection decoder
// mirrors natively (codec/core.hpp DecoderCore), so a steady
// index-only tick crosses the GIL boundary as ONE tick() call whose
// result carries no per-host records at all.
//
// Contract with tpumon_torch/fleetpoll.py (NativeFleetPoller):
//   eng = PollEngine(hello_bytes, fields_frag, fields, agg_fids, lazy)
//   eng.add_unix(path) / eng.add_tcp(ip, port)   # construction, in order
//   eng.set_request(i, req_bytes); eng.set_events_since(i, es)  # pre-tick
//   sent, recvd, hellos, records = eng.tick(timeout_s, skip_bytes)
//   eng.materialize(i)  # raw_snapshots: {chip: {fid: value}} or None
// A host with no record in `records` completed a steady sweep
// (index-only frame, no events): Python reuses its cached sample.
// Record tuples are
//   (host, stage, err, changes, agg|None, detail|None, hello|None,
//    events, chip_count)
// with stage one of the POLL_* module constants.
//
// The GIL is released for the WHOLE tick (the engine never touches
// Python); PyObject cookies dropped by in-tick frame applies are
// drained once the GIL is back, like every other native handle.  On
// non-Linux builds (the engine is epoll-only) the module still
// imports, but exposes ENGINE_AVAILABLE=0 and no PollEngine — the
// facade degrades to the pure-Python spec poller.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <new>
#include <string>
#include <vector>

#include "core.hpp"
#include "engine.hpp"

namespace nc = tpumon::codec;

namespace {

#include "py_common.hpp"

#ifdef __linux__

namespace pe = tpumon::poll;

struct EngineObj {
  PyObject_HEAD
  pe::Engine* eng;
  PyObject* key_cache;  // chip/fid -> PyLong, shared across materialize
  int busy;
  int closed;
};

void Engine_drain(EngineObj* self) {
  if (self->eng != nullptr) drain_released(&self->eng->released());
}

PyObject* Engine_new(PyTypeObject* type, PyObject* args, PyObject*) {
  const char* hello = nullptr;
  Py_ssize_t hello_n = 0;
  const char* frag = nullptr;
  Py_ssize_t frag_n = 0;
  PyObject* fields_obj = nullptr;
  long long agg[7];
  int lazy = 0;
  if (!PyArg_ParseTuple(args, "y#s#O(LLLLLLL)p", &hello, &hello_n, &frag,
                        &frag_n, &fields_obj, &agg[0], &agg[1], &agg[2],
                        &agg[3], &agg[4], &agg[5], &agg[6], &lazy))
    return nullptr;
  std::vector<unsigned long long> fields;
  PyObject* fast = PySequence_Fast(fields_obj, "fields must be a sequence");
  if (fast == nullptr) return nullptr;
  Py_ssize_t nf = PySequence_Fast_GET_SIZE(fast);
  fields.reserve(static_cast<size_t>(nf));
  for (Py_ssize_t i = 0; i < nf; i++) {
    unsigned long long f = PyLong_AsUnsignedLongLongMask(
        PySequence_Fast_GET_ITEM(fast, i));
    if (f == static_cast<unsigned long long>(-1) && PyErr_Occurred()) {
      Py_DECREF(fast);
      return nullptr;
    }
    fields.push_back(f);
  }
  Py_DECREF(fast);
  EngineObj* self = reinterpret_cast<EngineObj*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->eng = new (std::nothrow) pe::Engine(
      std::string(hello, static_cast<size_t>(hello_n)),
      std::string(frag, static_cast<size_t>(frag_n)), std::move(fields),
      agg, lazy != 0);
  self->key_cache = PyDict_New();
  self->busy = 0;
  self->closed = 0;
  if (self->eng == nullptr || self->key_cache == nullptr) {
    Py_DECREF(self);
    PyErr_NoMemory();
    return nullptr;
  }
  if (!self->eng->ok()) {
    Py_DECREF(self);
    PyErr_SetString(PyExc_OSError, "epoll_create1 failed");
    return nullptr;
  }
  return reinterpret_cast<PyObject*>(self);
}

void Engine_close_impl(EngineObj* self) {
  if (self->eng != nullptr) {
    self->eng->close_all();
    Engine_drain(self);
    delete self->eng;
    self->eng = nullptr;
  }
  Py_CLEAR(self->key_cache);
  self->closed = 1;
}

void Engine_dealloc(EngineObj* self) {
  Engine_close_impl(self);
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

int engine_host_index(EngineObj* self, Py_ssize_t i) {
  if (i < 0 || static_cast<size_t>(i) >= self->eng->host_count()) {
    PyErr_SetString(PyExc_IndexError, "fleet engine host index");
    return -1;
  }
  return 0;
}

PyObject* Engine_add_unix(EngineObj* self, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromLong(self->eng->add_unix(path));
}

PyObject* Engine_add_tcp(EngineObj* self, PyObject* args) {
  const char* ip;
  int port;
  if (!PyArg_ParseTuple(args, "si", &ip, &port)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromLong(self->eng->add_tcp(ip, port));
}

PyObject* Engine_set_request(EngineObj* self, PyObject* args) {
  Py_ssize_t i;
  const char* data;
  Py_ssize_t n;
  if (!PyArg_ParseTuple(args, "ny#", &i, &data, &n)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (engine_host_index(self, i) < 0) return nullptr;
  self->eng->set_request(static_cast<size_t>(i), data,
                         static_cast<size_t>(n));
  Py_RETURN_NONE;
}

PyObject* Engine_set_events_since(EngineObj* self, PyObject* args) {
  Py_ssize_t i;
  long long es;
  if (!PyArg_ParseTuple(args, "nL", &i, &es)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (engine_host_index(self, i) < 0) return nullptr;
  self->eng->set_events_since(static_cast<size_t>(i), es);
  Py_RETURN_NONE;
}

PyObject* Engine_connected(EngineObj* self, PyObject* args) {
  Py_ssize_t i;
  if (!PyArg_ParseTuple(args, "n", &i)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (engine_host_index(self, i) < 0) return nullptr;
  return PyBool_FromLong(
      self->eng->host_connected(static_cast<size_t>(i)) ? 1 : 0);
}

PyObject* Engine_tick_bytes(EngineObj* self, PyObject* args) {
  Py_ssize_t i;
  if (!PyArg_ParseTuple(args, "n", &i)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (engine_host_index(self, i) < 0) return nullptr;
  return PyLong_FromLongLong(
      self->eng->host_tick_bytes(static_cast<size_t>(i)));
}

PyObject* Engine_host_count(EngineObj* self, PyObject*) {
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  return PyLong_FromSize_t(self->eng->host_count());
}

// the aggregate tuple in Decoder.host_aggregate's exact shape, so
// NativeFleetPoller builds the HostSample through one code path
PyObject* engine_agg_tuple(const nc::AggResult& r) {
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

PyObject* engine_result_tuple(const pe::Result& r) {
  PyObject* agg = nullptr;
  if (r.have_agg) {
    agg = engine_agg_tuple(r.agg);
  } else {
    agg = Py_NewRef(Py_None);
  }
  if (agg == nullptr) return nullptr;
  PyObject* detail =
      r.detail.empty()
          ? Py_NewRef(Py_None)
          : PyBytes_FromStringAndSize(r.detail.data(),
                                      static_cast<Py_ssize_t>(
                                          r.detail.size()));
  PyObject* hello =
      r.hello.empty()
          ? Py_NewRef(Py_None)
          : PyBytes_FromStringAndSize(r.hello.data(),
                                      static_cast<Py_ssize_t>(
                                          r.hello.size()));
  PyObject* events =
      PyList_New(static_cast<Py_ssize_t>(r.events.size()));
  if (detail == nullptr || hello == nullptr || events == nullptr) {
    Py_XDECREF(agg);
    Py_XDECREF(detail);
    Py_XDECREF(hello);
    Py_XDECREF(events);
    return nullptr;
  }
  for (size_t e = 0; e < r.events.size(); e++) {
    PyObject* b = PyBytes_FromStringAndSize(
        r.events[e].data(), static_cast<Py_ssize_t>(r.events[e].size()));
    if (b == nullptr) {
      Py_DECREF(agg);
      Py_DECREF(detail);
      Py_DECREF(hello);
      Py_DECREF(events);
      return nullptr;
    }
    PyList_SET_ITEM(events, static_cast<Py_ssize_t>(e), b);
  }
  return Py_BuildValue("iiiLNNNNL", r.host, r.stage, r.err, r.changes,
                       agg, detail, hello, events, r.chip_count);
}

PyObject* Engine_tick(EngineObj* self, PyObject* args) {
  double timeout_s;
  const char* skip;
  Py_ssize_t skip_n;
  if (!PyArg_ParseTuple(args, "dy#", &timeout_s, &skip, &skip_n))
    return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (static_cast<size_t>(skip_n) != self->eng->host_count()) {
    PyErr_SetString(PyExc_ValueError,
                    "skip mask length != registered host count");
    return nullptr;
  }
  std::vector<uint8_t> skipv(skip, skip + skip_n);
  pe::Engine* eng = self->eng;
  Py_BEGIN_ALLOW_THREADS
  eng->tick(timeout_s, skipv);
  Py_END_ALLOW_THREADS
  // PyObject cookies dropped by in-tick frame applies (changed cells,
  // removed chips, reconnect resets) are freed here, with the GIL
  Engine_drain(self);
  const std::vector<pe::Result>& rs = self->eng->results();
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(rs.size()));
  if (out == nullptr) return nullptr;
  for (size_t i = 0; i < rs.size(); i++) {
    PyObject* t = engine_result_tuple(rs[i]);
    if (t == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), t);
  }
  return Py_BuildValue("LLLN", self->eng->bytes_sent(),
                       self->eng->bytes_recv(), self->eng->hello_count(),
                       out);
}

// raw_snapshots / tee materialization: the engine-owned mirror through
// the same template/fast-path machinery as Decoder.materialize
PyObject* Engine_materialize(EngineObj* self, PyObject* args) {
  Py_ssize_t i;
  if (!PyArg_ParseTuple(args, "n", &i)) return nullptr;
  if (enter_handle(&self->busy, self->closed, "poll engine") < 0)
    return nullptr;
  Guard guard(&self->busy);
  if (engine_host_index(self, i) < 0) return nullptr;
  nc::DecoderCore* core = self->eng->host_decoder(static_cast<size_t>(i));
  if (core == nullptr) Py_RETURN_NONE;
  const std::vector<unsigned long long>& fields = self->eng->fields();
  long long cc = self->eng->host_chip_count(static_cast<size_t>(i));
  PyObject* out = PyDict_New();
  if (out == nullptr) return nullptr;
  for (long long ch = 0; ch < cc; ch++) {
    nc::MirChip* chip = core->find_chip(static_cast<unsigned long long>(ch));
    if (chip == nullptr) continue;
    PyObject* vals = nullptr;
    if (chip->cells.size() == fields.size()) {
      PyObject* t = chip_template(self->key_cache, chip);
      vals = t == nullptr ? nullptr : PyDict_Copy(t);
      if (vals == nullptr) goto fail;
    } else {
      vals = PyDict_New();
      if (vals == nullptr) goto fail;
      for (unsigned long long f : fields) {
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
      PyObject* ck =
          cached_key(self->key_cache, static_cast<unsigned long long>(ch));
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

PyObject* Engine_close(EngineObj* self, PyObject*) {
  if (self->busy) {
    PyErr_SetString(PyExc_RuntimeError,
                    "concurrent use of a native poll engine handle");
    return nullptr;
  }
  Engine_close_impl(self);
  Py_RETURN_NONE;
}

PyMethodDef Engine_methods[] = {
    {"add_unix", reinterpret_cast<PyCFunction>(Engine_add_unix),
     METH_VARARGS, "add_unix(path) -> host index"},
    {"add_tcp", reinterpret_cast<PyCFunction>(Engine_add_tcp),
     METH_VARARGS, "add_tcp(ip, port) -> host index"},
    {"set_request", reinterpret_cast<PyCFunction>(Engine_set_request),
     METH_VARARGS, "set_request(i, req_bytes)"},
    {"set_events_since",
     reinterpret_cast<PyCFunction>(Engine_set_events_since), METH_VARARGS,
     "set_events_since(i, seq)"},
    {"connected", reinterpret_cast<PyCFunction>(Engine_connected),
     METH_VARARGS, "connected(i) -> bool"},
    {"tick_bytes", reinterpret_cast<PyCFunction>(Engine_tick_bytes),
     METH_VARARGS, "tick_bytes(i) -> bytes moved for host i last tick"},
    {"host_count", reinterpret_cast<PyCFunction>(Engine_host_count),
     METH_NOARGS, "registered host count"},
    {"tick", reinterpret_cast<PyCFunction>(Engine_tick), METH_VARARGS,
     "tick(timeout_s, skip) -> (sent, recvd, hellos, records)"},
    {"materialize", reinterpret_cast<PyCFunction>(Engine_materialize),
     METH_VARARGS, "materialize(i) -> {chip: {fid: value}} or None"},
    {"close", reinterpret_cast<PyCFunction>(Engine_close), METH_NOARGS,
     "tear down every connection and poison the handle"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject EngineType = {PyVarObject_HEAD_INIT(nullptr, 0)};

int engine_register(PyObject* m) {
  EngineType.tp_name = "_tpumon_torch_poll.PollEngine";
  EngineType.tp_basicsize = sizeof(EngineObj);
  EngineType.tp_flags = Py_TPFLAGS_DEFAULT;
  EngineType.tp_doc =
      "epoll-driven fleet connection engine (the native poll plane)";
  EngineType.tp_new = Engine_new;
  EngineType.tp_dealloc = reinterpret_cast<destructor>(Engine_dealloc);
  EngineType.tp_methods = Engine_methods;
  if (PyType_Ready(&EngineType) < 0) return -1;
  Py_INCREF(&EngineType);
  if (PyModule_AddObject(m, "PollEngine",
                         reinterpret_cast<PyObject*>(&EngineType)) < 0) {
    Py_DECREF(&EngineType);
    return -1;
  }
  PyModule_AddIntConstant(m, "POLL_OK_FRAME", pe::OK_FRAME);
  PyModule_AddIntConstant(m, "POLL_OK_JSON", pe::OK_JSON);
  PyModule_AddIntConstant(m, "POLL_IDLE_EOF", pe::IDLE_EOF);
  PyModule_AddIntConstant(m, "POLL_ERR_CONNECT", pe::ERR_CONNECT);
  PyModule_AddIntConstant(m, "POLL_ERR_SETUP", pe::ERR_SETUP);
  PyModule_AddIntConstant(m, "POLL_ERR_SEND", pe::ERR_SEND);
  PyModule_AddIntConstant(m, "POLL_ERR_RECV", pe::ERR_RECV);
  PyModule_AddIntConstant(m, "POLL_ERR_EOF", pe::ERR_EOF);
  PyModule_AddIntConstant(m, "POLL_ERR_FRAME_DECODE",
                          pe::ERR_FRAME_DECODE);
  PyModule_AddIntConstant(m, "POLL_ERR_BAD_JSON", pe::ERR_BAD_JSON);
  PyModule_AddIntConstant(m, "POLL_ERR_NON_OBJECT", pe::ERR_NON_OBJECT);
  PyModule_AddIntConstant(m, "POLL_ERR_DESYNC", pe::ERR_DESYNC);
  PyModule_AddIntConstant(m, "POLL_ERR_HELLO", pe::ERR_HELLO);
  PyModule_AddIntConstant(m, "POLL_ERR_HELLO_CHIPS",
                          pe::ERR_HELLO_CHIPS);
  PyModule_AddIntConstant(m, "POLL_ERR_PROBE", pe::ERR_PROBE);
  PyModule_AddIntConstant(m, "POLL_ERR_JSON_APP", pe::ERR_JSON_APP);
  PyModule_AddIntConstant(m, "POLL_ERR_BINARY_WHERE_JSON",
                          pe::ERR_BINARY_WHERE_JSON);
  PyModule_AddIntConstant(m, "POLL_ERR_IDLE_JSON", pe::ERR_IDLE_JSON);
  PyModule_AddIntConstant(m, "POLL_ERR_DEADLINE", pe::ERR_DEADLINE);
  return 0;
}

#endif  // __linux__

// ---- module -----------------------------------------------------------------

PyMethodDef module_methods[] = {{nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT,
    "_tpumon_torch_poll",
    "Native poll plane: the epoll-driven fleet connection engine "
    "(see docs/incremental_pipeline.md).",
    -1,
    module_methods,
    nullptr,
    nullptr,
    nullptr,
    nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__tpumon_torch_poll(void) {
  PyObject* m = PyModule_Create(&moduledef);
  if (m == nullptr) return nullptr;
#ifdef __linux__
  if (engine_register(m) < 0) {
    Py_DECREF(m);
    return nullptr;
  }
  PyModule_AddIntConstant(m, "ENGINE_AVAILABLE", 1);
#else
  PyModule_AddIntConstant(m, "ENGINE_AVAILABLE", 0);
#endif
  // wire constant: a stale build whose framing drifted must be rejectable by the
  // loader before it ever owns a socket
  PyModule_AddIntConstant(m, "SWEEP_FRAME_MAGIC", nc::kSweepFrameMagic);
  return m;
}
