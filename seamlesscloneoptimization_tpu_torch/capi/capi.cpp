// libseamlessclone_tpu_torch: C ABI of the PyTorch/CUDA seamless-clone engine.
//
// The port's own copy of the JAX package's native/src/capi.cpp: the
// counterpart of the reference's extern-C shared library
// (seamlessClone-CUDA/seamlessclone_cuda.h:6-62, built into
// seamlessclone_cuda.so). The library embeds CPython and calls
// seamlesscloneoptimization_tpu_torch.capi_host, which wraps the caller's
// buffers and runs the engine on the card (or, with {"platform": "cpu"},
// its plain PyTorch path). This layer owns the interpreter's lifecycle, the
// GIL, the buffers' marshalling (memoryviews over the caller's memory, no
// copy) and error reporting (a thread-local last error).
//
// ABI (seamlessclone_tpu_torch.h): sc_tpu_create_instance, sc_tpu_run,
// sc_tpu_sync, sc_tpu_destroy, sc_tpu_last_error.
//
// Thread-safety: every entry point takes the GIL (PyGILState_Ensure), so
// the library may be called from any thread; calls serialize.
//
// Search path: SC_TPU_PYTHONPATH (colon separated) is put at the front of
// the embedded interpreter's sys.path, in its order, before the first
// import; PYTHONPATH is honoured as by python itself.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <mutex>
#include <string>

#include "seamlessclone_tpu_torch.h"

namespace {

std::mutex g_init_mutex;
PyObject* g_host_mod = nullptr;  // seamlesscloneoptimization_tpu_torch.capi_host
thread_local std::string g_last_error;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// SC_TPU_PYTHONPATH's entries at the front of sys.path, in their order.
void extend_path() {
  const char* extra = getenv("SC_TPU_PYTHONPATH");
  if (!extra || !*extra) return;
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  if (!sys_path) return;
  std::string paths(extra);
  Py_ssize_t at = 0;
  size_t start = 0;
  while (start <= paths.size()) {
    size_t colon = paths.find(':', start);
    std::string one = paths.substr(
        start, colon == std::string::npos ? std::string::npos : colon - start);
    if (!one.empty()) {
      PyObject* s = PyUnicode_FromString(one.c_str());
      if (s) {
        PyList_Insert(sys_path, at++, s);
        Py_DECREF(s);
      }
    }
    if (colon == std::string::npos) break;
    start = colon + 1;
  }
}

bool ensure_interpreter() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_host_mod) return true;
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    PyStatus status = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      g_last_error = status.err_msg ? status.err_msg : "Python initialization failed";
      return false;
    }
    we_initialized = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  extend_path();
  g_host_mod = PyImport_ImportModule("seamlesscloneoptimization_tpu_torch.capi_host");
  if (!g_host_mod) set_error_from_python();
  PyGILState_Release(gil);
  if (we_initialized) {
    // Py_InitializeFromConfig leaves THIS thread holding the GIL outside of
    // any PyGILState pairing: release it, or another thread's
    // PyGILState_Ensure waits forever.
    PyEval_SaveThread();
  }
  return g_host_mod != nullptr;
}

PyObject* ro_view(const unsigned char* buf, Py_ssize_t len) {
  return PyMemoryView_FromMemory(reinterpret_cast<char*>(const_cast<unsigned char*>(buf)),
                                 len, PyBUF_READ);
}

}  // namespace

extern "C" {

const char* sc_tpu_last_error(void) { return g_last_error.c_str(); }

void* sc_tpu_create_instance(int device_id, const char* config_json) {
  if (!ensure_interpreter()) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* inst = PyObject_CallMethod(g_host_mod, "create_instance", "is",
                                       device_id, config_json ? config_json : "");
  if (!inst) set_error_from_python();
  PyGILState_Release(gil);
  return inst;  // a new reference, owned by the caller's handle
}

int sc_tpu_run(void* inst, const unsigned char* face, int fh, int fw,
               const unsigned char* body, int bh, int bw,
               const unsigned char* mask, int mh, int mw,
               int cx, int cy, unsigned char* out, int sync) {
  if (!inst || !face || !body || !out) {
    g_last_error = "null instance or buffer";
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* face_mv = ro_view(face, (Py_ssize_t)fh * fw * 3);
  PyObject* body_mv = ro_view(body, (Py_ssize_t)bh * bw * 3);
  PyObject* mask_mv = mask ? ro_view(mask, (Py_ssize_t)mh * mw) : (Py_INCREF(Py_None), Py_None);
  PyObject* out_mv = PyMemoryView_FromMemory(reinterpret_cast<char*>(out),
                                             (Py_ssize_t)bh * bw * 3, PyBUF_WRITE);
  int rc = -1;
  if (face_mv && body_mv && mask_mv && out_mv) {
    PyObject* r = PyObject_CallMethod(g_host_mod, "run", "OOiiOiiOiiiiOi",
                                      (PyObject*)inst, face_mv, fh, fw, body_mv, bh, bw,
                                      mask_mv, mh, mw, cx, cy, out_mv, sync);
    if (r) {
      rc = (int)PyLong_AsLong(r);
      Py_DECREF(r);
    } else {
      set_error_from_python();
    }
  } else {
    set_error_from_python();
  }
  Py_XDECREF(face_mv);
  Py_XDECREF(body_mv);
  Py_XDECREF(mask_mv);
  Py_XDECREF(out_mv);
  PyGILState_Release(gil);
  return rc;
}

int sc_tpu_sync(void* inst) {
  if (!inst) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_host_mod, "sync", "O", (PyObject*)inst);
  int rc = r ? 0 : -1;
  if (!r) set_error_from_python();
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

void sc_tpu_destroy(void* inst) {
  if (!inst) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_host_mod, "destroy", "O", (PyObject*)inst);
  if (!r) PyErr_Clear();
  Py_XDECREF(r);
  Py_DECREF((PyObject*)inst);
  PyGILState_Release(gil);
}

}  // extern "C"
