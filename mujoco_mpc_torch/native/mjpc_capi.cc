// C ABI for embedding the port's agent in native hosts.
//
// Counterpart of mujoco_mpc_tpu/native/mjpc_capi.cc (reference
// mjpc/interface.{h,cc}: create_policy / step_policy / set_weights, so that
// foreign programs drive the planner without GUI or gRPC). The library
// embeds the Python interpreter and forwards to
// mujoco_mpc_torch.agent.interface; the planning runs on the card (or the
// CPU, where the caller asks) either way, so this layer is thin.
//
// Where this library starts the interpreter itself, it releases the GIL
// after the import: the agent's plan thread then runs between the host's
// calls, not only while a call is inside Python. Every failure returns -1
// and keeps the Python error's text for mjpc_last_error().
//
// Build: python mujoco_mpc_torch/native/build.py [--test [--device cpu]]

#include <Python.h>

#include <mutex>
#include <string>

namespace {

std::once_flag g_init_once;
PyObject* g_interface = nullptr;  // mujoco_mpc_torch.agent.interface
std::string g_init_error;
thread_local std::string g_last_error;

// The pending Python error's type and message (and clears it); call with
// the GIL held.
std::string FetchError() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  if (!type) return "unknown error (no Python exception set)";
  PyErr_NormalizeException(&type, &value, &tb);
  std::string text;
  PyObject* name = PyObject_GetAttrString(type, "__name__");
  if (name) {
    const char* s = PyUnicode_AsUTF8(name);
    if (s) text = s;
    Py_DECREF(name);
  }
  if (value) {
    PyObject* str = PyObject_Str(value);
    if (str) {
      const char* s = PyUnicode_AsUTF8(str);
      if (s) text += std::string(": ") + s;
      Py_DECREF(str);
    }
    // the chained cause (a plan thread's error comes as its __cause__)
    PyObject* cause = PyException_GetCause(value);
    if (cause) {
      PyObject* str2 = PyObject_Str(cause);
      PyObject* cname = PyObject_GetAttrString(
          reinterpret_cast<PyObject*>(Py_TYPE(cause)), "__name__");
      if (str2 && cname) {
        const char* a = PyUnicode_AsUTF8(cname);
        const char* b = PyUnicode_AsUTF8(str2);
        if (a && b) text += std::string(" (caused by ") + a + ": " + b + ")";
      }
      Py_XDECREF(str2);
      Py_XDECREF(cname);
      Py_DECREF(cause);
    }
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return text;
}

void EnsureInterpreter() {
  std::call_once(g_init_once, [] {
    bool started_here = false;
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      started_here = true;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    g_interface = PyImport_ImportModule("mujoco_mpc_torch.agent.interface");
    if (!g_interface) {
      g_init_error = "import mujoco_mpc_torch.agent.interface: " +
                     FetchError();
    }
    PyGILState_Release(gil);
    if (started_here) {
      // the initialising thread holds the GIL from Py_InitializeEx on:
      // release it, so that Python threads run between calls
      PyEval_SaveThread();
    }
  });
}

// interface.<name>(*args); nullptr on failure, with g_last_error set. Call
// with the GIL held.
PyObject* CallInterface(const char* name, PyObject* args) {
  if (!g_interface) {
    g_last_error = g_init_error;
    return nullptr;
  }
  if (!args) {
    g_last_error = "building the arguments: " + FetchError();
    return nullptr;
  }
  PyObject* fn = PyObject_GetAttrString(g_interface, name);
  if (!fn) {
    g_last_error = FetchError();
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  if (!out) g_last_error = std::string(name) + ": " + FetchError();
  return out;
}

PyObject* DoubleList(const double* data, int n) {
  PyObject* list = PyList_New(n);
  if (!list) return nullptr;
  for (int i = 0; i < n; ++i) {
    PyList_SET_ITEM(list, i, PyFloat_FromDouble(data[i]));
  }
  return list;
}

}  // namespace

extern "C" {

// Create an asynchronously planning agent for a registered task. planner
// NULL means "sampling", device NULL the card ("cuda"); "cpu" asks for the
// CPU. Returns a handle > 0, or -1 on failure (mjpc_last_error says why).
int mjpc_create_policy(const char* task, const char* planner,
                       const char* device) {
  EnsureInterpreter();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args =
      device ? Py_BuildValue("(sss)", task, planner ? planner : "sampling",
                             device)
             : Py_BuildValue("(ss)", task, planner ? planner : "sampling");
  PyObject* out = CallInterface("create_policy", args);
  Py_XDECREF(args);
  int handle = -1;
  if (out) {
    handle = static_cast<int>(PyLong_AsLong(out));
    if (handle == -1 && PyErr_Occurred()) {
      g_last_error = "create_policy's handle: " + FetchError();
    }
    Py_DECREF(out);
  }
  PyGILState_Release(gil);
  return handle;
}

// Publish (qpos, qvel, time) and read the current policy's action into
// `action` (caller-allocated, nu_cap entries). Returns nu, or -1 on
// failure, a buffer shorter than nu included.
int mjpc_step_policy(int handle, const double* qpos, int nq,
                     const double* qvel, int nv, double time,
                     double* action, int nu_cap) {
  EnsureInterpreter();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* qp = DoubleList(qpos, nq);
  PyObject* qv = DoubleList(qvel, nv);
  PyObject* args = (qp && qv) ? Py_BuildValue("(iOOd)", handle, qp, qv, time)
                              : nullptr;
  Py_XDECREF(qp);
  Py_XDECREF(qv);
  PyObject* out = CallInterface("step_policy", args);
  Py_XDECREF(args);
  int nu = -1;
  if (out) {
    PyObject* seq = PySequence_Fast(out, "the action is not a sequence");
    if (!seq) {
      g_last_error = FetchError();
    } else {
      int n = static_cast<int>(PySequence_Fast_GET_SIZE(seq));
      if (n > nu_cap) {
        g_last_error = "the action has " + std::to_string(n) +
                       " entries, the buffer " + std::to_string(nu_cap);
      } else {
        nu = n;
        for (int i = 0; i < n; ++i) {
          action[i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(seq, i));
        }
        if (PyErr_Occurred()) {
          g_last_error = "reading the action: " + FetchError();
          nu = -1;
        }
      }
      Py_DECREF(seq);
    }
    Py_DECREF(out);
  }
  PyGILState_Release(gil);
  return nu;
}

// Set one cost weight by term name. Returns 0 on success, -1 on failure.
int mjpc_set_weight(int handle, const char* term, double weight) {
  EnsureInterpreter();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args = Py_BuildValue("(i{s:d})", handle, term, weight);
  PyObject* out = CallInterface("set_weights", args);
  Py_XDECREF(args);
  int rc = out ? 0 : -1;
  Py_XDECREF(out);
  PyGILState_Release(gil);
  return rc;
}

// Stop planning (joining the plan thread) and free the agent. Returns 0,
// or -1 where the plan thread had failed (mjpc_last_error says how).
int mjpc_destroy_policy(int handle) {
  EnsureInterpreter();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args = Py_BuildValue("(i)", handle);
  PyObject* out = CallInterface("destroy_policy", args);
  Py_XDECREF(args);
  int rc = out ? 0 : -1;
  Py_XDECREF(out);
  PyGILState_Release(gil);
  return rc;
}

// The text of the calling thread's last failure ("" if none).
const char* mjpc_last_error() { return g_last_error.c_str(); }

}  // extern "C"
