// The model C API over the PyTorch/CUDA port: build, compile, train
// and run a model from pure C, the ABI of native/include/ffcore.h's
// ffc_model_* entry points.
//
// As the JAX package's native/src/model_capi.cc, it embeds a CPython
// interpreter (the reference's python/main.cc embeds CPython inside a
// Legion task) and drives the framework through it: here
// flexflow_tpu_torch's FFConfig and FFModel. A host links libffcore.so
// and libpython and finds the package through PYTHONPATH alone. Models
// run on the card unless ffc_model_create_json's config holds
// "device": "cpu" (every other key goes to FFConfig). The driver
// beside this file (c_model_driver.c) runs the loop end to end.
//
// Every entry point is GIL-correct: callable both from a pure-C host
// (which may never have initialized Python) and from inside a Python
// process that loaded libffcore via ctypes (ctypes drops the GIL around
// foreign calls; PyGILState_Ensure re-acquires it).
#include "ffcore.h"

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Model {
  PyObject *model = nullptr;    // flexflow_tpu_torch.model.FFModel
  PyObject *tensors = nullptr;  // list of Tensor handles (index = id)
  PyObject *rng = nullptr;      // the step key (None: key(0)), set at compile
  bool compiled = false;
};

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

bool ensure_python() {
  if (Py_IsInitialized()) return true;
  Py_InitializeEx(0);
  if (!Py_IsInitialized()) return false;
  // the embedding host (a plain C program) finds flexflow_tpu_torch via
  // PYTHONPATH, matching how the reference's embedded interpreter found
  // the flexflow package.
  // Release the GIL the initializer left held by THIS thread, so a
  // different host thread's PyGILState_Ensure doesn't deadlock; every
  // entry point re-acquires via Gil{}.
  PyEval_SaveThread();
  return true;
}

PyObject *import_attr(const char *mod, const char *attr) {
  PyObject *m = PyImport_ImportModule(mod);
  if (!m) return nullptr;
  PyObject *a = PyObject_GetAttrString(m, attr);
  Py_DECREF(m);
  return a;
}

void report_and_clear() {
  if (PyErr_Occurred()) PyErr_Print();
}

int64_t push_tensor(Model *m, PyObject *t /* stolen */) {
  if (!t) return -1;
  PyList_Append(m->tensors, t);
  Py_DECREF(t);
  return PyList_Size(m->tensors) - 1;
}

PyObject *get_tensor(Model *m, int64_t id) {  // borrowed
  if (id < 0 || id >= PyList_Size(m->tensors)) return nullptr;
  return PyList_GetItem(m->tensors, id);
}

// host buffer (C double, row-major) -> numpy float32/int32 array
PyObject *array_from(const double *data, const int64_t *shape, int32_t ndims,
                     bool as_int) {
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) return nullptr;
  int64_t n = 1;
  for (int32_t i = 0; i < ndims; ++i) n *= shape[i];
  PyObject *bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data), n * (int64_t)sizeof(double));
  PyObject *arr = PyObject_CallMethod(np, "frombuffer", "Os", bytes, "float64");
  Py_XDECREF(bytes);
  if (!arr) {
    Py_DECREF(np);
    return nullptr;
  }
  PyObject *shp = PyTuple_New(ndims);
  for (int32_t i = 0; i < ndims; ++i)
    PyTuple_SetItem(shp, i, PyLong_FromLongLong(shape[i]));
  PyObject *reshaped = PyObject_CallMethod(arr, "reshape", "O", shp);
  Py_DECREF(arr);
  Py_DECREF(shp);
  if (!reshaped) {
    Py_DECREF(np);
    return nullptr;
  }
  PyObject *cast =
      PyObject_CallMethod(reshaped, "astype", "s", as_int ? "int32" : "float32");
  Py_DECREF(reshaped);
  Py_DECREF(np);
  return cast;
}

// obj.meth(*args, name=name) — the builder methods take `name` as a
// keyword (positional slots hold dtype/axis/use_bias defaults)
PyObject *call_named(PyObject *obj, const char *meth, PyObject *args /*stolen*/,
                     const char *name) {
  PyObject *fn = PyObject_GetAttrString(obj, meth);
  if (!fn) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *kw = Py_BuildValue("{s:s}", "name", name ? name : "");
  PyObject *r = PyObject_Call(fn, args, kw);
  Py_DECREF(fn);
  Py_DECREF(kw);
  Py_DECREF(args);
  return r;
}

}  // namespace

extern "C" {

ffc_model_t *ffc_model_create(int32_t batch_size, int32_t workers_per_node,
                              int32_t num_nodes, int32_t search_budget) {
  if (!ensure_python()) return nullptr;
  Gil gil;
  PyObject *cfg_cls = import_attr("flexflow_tpu_torch.config", "FFConfig");
  PyObject *model_cls = import_attr("flexflow_tpu_torch.model", "FFModel");
  if (!cfg_cls || !model_cls) {
    report_and_clear();
    Py_XDECREF(cfg_cls);
    Py_XDECREF(model_cls);
    return nullptr;
  }
  PyObject *kwargs = Py_BuildValue(
      "{s:i,s:i,s:i,s:i}", "batch_size", batch_size, "workers_per_node",
      workers_per_node, "num_nodes", num_nodes, "search_budget", search_budget);
  PyObject *empty = PyTuple_New(0);
  PyObject *cfg = PyObject_Call(cfg_cls, empty, kwargs);
  Py_DECREF(kwargs);
  Py_DECREF(cfg_cls);
  PyObject *model =
      cfg ? PyObject_CallFunctionObjArgs(model_cls, cfg, nullptr) : nullptr;
  Py_XDECREF(cfg);
  Py_DECREF(model_cls);
  Py_DECREF(empty);
  if (!model) {
    report_and_clear();
    return nullptr;
  }
  Model *m = new Model();
  m->model = model;
  m->tensors = PyList_New(0);
  return reinterpret_cast<ffc_model_t *>(m);
}

ffc_model_t *ffc_model_create_json(const char *config_json) {
  // Full-config create: any FFConfig field by name. The dataclass is the
  // single schema; new flags (zero_optimizer, grad_accum_steps,
  // trace_window, pipeline_stages, ...) need no new C glue.
  if (!ensure_python()) return nullptr;
  Gil gil;
  PyObject *cfg_cls = import_attr("flexflow_tpu_torch.config", "FFConfig");
  PyObject *model_cls = import_attr("flexflow_tpu_torch.model", "FFModel");
  PyObject *jsonmod = PyImport_ImportModule("json");
  if (!cfg_cls || !model_cls || !jsonmod) {
    report_and_clear();
    Py_XDECREF(cfg_cls);
    Py_XDECREF(model_cls);
    Py_XDECREF(jsonmod);
    return nullptr;
  }
  PyObject *kwargs = PyObject_CallMethod(jsonmod, "loads", "s",
                                         config_json ? config_json : "{}");
  Py_DECREF(jsonmod);
  PyObject *model = nullptr;
  if (kwargs && PyDict_Check(kwargs)) {
    // "device" (default "cuda") goes to FFModel, every other key to FFConfig
    PyObject *device = PyDict_GetItemString(kwargs, "device");  // borrowed
    if (device) {
      Py_INCREF(device);
      PyDict_DelItemString(kwargs, "device");
    } else {
      device = PyUnicode_FromString("cuda");
    }
    PyObject *empty = PyTuple_New(0);
    PyObject *cfg = PyObject_Call(cfg_cls, empty, kwargs);
    if (cfg) {
      PyObject *args = PyTuple_Pack(1, cfg);
      PyObject *mkw = Py_BuildValue("{s:O}", "device", device);
      model = PyObject_Call(model_cls, args, mkw);
      Py_DECREF(args);
      Py_DECREF(mkw);
    }
    Py_XDECREF(cfg);
    Py_DECREF(empty);
    Py_DECREF(device);
  } else if (kwargs) {
    PyErr_SetString(PyExc_TypeError, "config_json must be a JSON object");
  }
  Py_XDECREF(kwargs);
  Py_DECREF(cfg_cls);
  Py_DECREF(model_cls);
  if (!model) {
    report_and_clear();
    return nullptr;
  }
  Model *m = new Model();
  m->model = model;
  m->tensors = PyList_New(0);
  return reinterpret_cast<ffc_model_t *>(m);
}

void ffc_model_destroy(ffc_model_t *handle) {
  if (!handle) return;
  Model *m = reinterpret_cast<Model *>(handle);
  {
    Gil gil;
    Py_XDECREF(m->model);
    Py_XDECREF(m->tensors);
    Py_XDECREF(m->rng);
  }
  delete m;
}

int64_t ffc_model_input(ffc_model_t *handle, const int64_t *dims,
                        int32_t ndims, const char *name) {
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  PyObject *shape = PyTuple_New(ndims);
  for (int32_t i = 0; i < ndims; ++i)
    PyTuple_SetItem(shape, i, PyLong_FromLongLong(dims[i]));
  PyObject *t = call_named(m->model, "create_tensor",
                           Py_BuildValue("(O)", shape), name);
  Py_DECREF(shape);
  if (!t) report_and_clear();
  return push_tensor(m, t);
}

int64_t ffc_model_dense(ffc_model_t *handle, int64_t input, int32_t out_dim,
                        const char *activation, const char *name) {
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  PyObject *in = get_tensor(m, input);
  if (!in) return -1;
  PyObject *acti_cls = import_attr("flexflow_tpu_torch.core.types", "ActiMode");
  if (!acti_cls) {
    report_and_clear();
    return -1;
  }
  PyObject *acti = PyObject_CallFunction(
      acti_cls, "s", activation && *activation ? activation : "none");
  Py_DECREF(acti_cls);
  if (!acti) {
    report_and_clear();
    return -1;
  }
  PyObject *t = call_named(m->model, "dense",
                           Py_BuildValue("(OiO)", in, out_dim, acti), name);
  Py_DECREF(acti);
  if (!t) report_and_clear();
  return push_tensor(m, t);
}

int64_t ffc_model_mha(ffc_model_t *handle, int64_t query, int64_t key,
                      int64_t value, int32_t embed_dim, int32_t num_heads,
                      const char *name) {
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  PyObject *q = get_tensor(m, query);
  PyObject *k = get_tensor(m, key);
  PyObject *v = get_tensor(m, value);
  if (!q || !k || !v) return -1;
  PyObject *t = call_named(
      m->model, "multihead_attention",
      Py_BuildValue("(OOOii)", q, k, v, embed_dim, num_heads), name);
  if (!t) report_and_clear();
  return push_tensor(m, t);
}

int64_t ffc_model_softmax(ffc_model_t *handle, int64_t input,
                          const char *name) {
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  PyObject *in = get_tensor(m, input);
  if (!in) return -1;
  PyObject *t = call_named(m->model, "softmax", Py_BuildValue("(O)", in), name);
  if (!t) report_and_clear();
  return push_tensor(m, t);
}

int64_t ffc_model_call(ffc_model_t *handle, const char *method,
                       const char *json_args) {
  // Generic builder: any FFModel layer method, args JSON-encoded, tensor
  // handles as {"__tensor__": id}. One C entry covers the ~60-builder
  // surface the reference's flexflow_c.cc wrapped function-by-function
  // (1937 LoC of hand glue) — the embedded interpreter gives it to us
  // reflectively. Multi-output builders (top_k, split, ...) push every
  // output; the returned id is the FIRST, the rest follow consecutively.
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  PyObject *jsonmod = PyImport_ImportModule("json");
  if (!jsonmod) {
    report_and_clear();
    return -1;
  }
  PyObject *parsed = PyObject_CallMethod(jsonmod, "loads", "s",
                                         json_args ? json_args : "{}");
  Py_DECREF(jsonmod);
  if (!parsed) {
    report_and_clear();
    return -1;
  }
  PyObject *args_list = PyDict_GetItemString(parsed, "args");      // borrowed
  PyObject *kwargs_in = PyDict_GetItemString(parsed, "kwargs");    // borrowed

  // resolve {"__tensor__": id} placeholders (recursively for lists)
  struct Resolver {
    Model *m;
    PyObject *resolve(PyObject *v) {  // returns NEW reference
      if (PyDict_Check(v)) {
        PyObject *tid = PyDict_GetItemString(v, "__tensor__");
        if (tid) {
          int64_t id = PyLong_AsLongLong(tid);
          PyObject *t = get_tensor(m, id);
          if (t) {
            Py_INCREF(t);
          } else {
            // every other failure mode prints a traceback; a stale
            // tensor id must be diagnosable too
            PyErr_Format(PyExc_IndexError,
                         "ffc_model_call: invalid tensor id %lld",
                         (long long)id);
          }
          return t;
        }
      }
      if (PyList_Check(v)) {
        PyObject *out = PyList_New(PyList_Size(v));
        for (Py_ssize_t i = 0; i < PyList_Size(v); ++i) {
          PyObject *r = resolve(PyList_GetItem(v, i));
          if (!r) {
            Py_DECREF(out);
            return nullptr;
          }
          PyList_SetItem(out, i, r);
        }
        return out;
      }
      Py_INCREF(v);
      return v;
    }
  } R{m};

  Py_ssize_t nargs = args_list && PyList_Check(args_list) ? PyList_Size(args_list) : 0;
  PyObject *args = PyTuple_New(nargs);
  bool ok = true;
  for (Py_ssize_t i = 0; i < nargs; ++i) {
    PyObject *r = R.resolve(PyList_GetItem(args_list, i));
    if (!r) {
      ok = false;
      break;
    }
    PyTuple_SetItem(args, i, r);
  }
  PyObject *kwargs = PyDict_New();
  if (ok && kwargs_in && PyDict_Check(kwargs_in)) {
    PyObject *k, *v;
    Py_ssize_t pos = 0;
    while (PyDict_Next(kwargs_in, &pos, &k, &v)) {
      PyObject *r = R.resolve(v);
      if (!r) {
        ok = false;
        break;
      }
      PyDict_SetItem(kwargs, k, r);
      Py_DECREF(r);
    }
  }
  int64_t result = -1;
  if (ok) {
    PyObject *fn = PyObject_GetAttrString(m->model, method);
    PyObject *out = fn ? PyObject_Call(fn, args, kwargs) : nullptr;
    Py_XDECREF(fn);
    if (out) {
      if (PyTuple_Check(out) || PyList_Check(out)) {
        PyObject *seq = PySequence_Fast(out, "builder output");
        Py_ssize_t nout = PySequence_Fast_GET_SIZE(seq);
        for (Py_ssize_t i = 0; i < nout; ++i) {
          PyObject *t = PySequence_Fast_GET_ITEM(seq, i);
          Py_INCREF(t);
          int64_t id = push_tensor(m, t);
          if (i == 0) result = id;
        }
        Py_DECREF(seq);
        Py_DECREF(out);
      } else {
        result = push_tensor(m, out);
      }
    }
  }
  if (result < 0) report_and_clear();
  Py_DECREF(args);
  Py_DECREF(kwargs);
  Py_DECREF(parsed);
  return result;
}

int32_t ffc_model_compile(ffc_model_t *handle, double learning_rate,
                          const char *loss_type) {
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  PyObject *opt_cls = import_attr("flexflow_tpu_torch.runtime.optimizers", "SGDOptimizer");
  PyObject *loss_cls = import_attr("flexflow_tpu_torch.core.types", "LossType");
  if (!opt_cls || !loss_cls) {
    report_and_clear();
    Py_XDECREF(opt_cls);
    Py_XDECREF(loss_cls);
    return -1;
  }
  PyObject *empty = PyTuple_New(0);
  PyObject *okw = Py_BuildValue("{s:d}", "lr", learning_rate);
  PyObject *opt = PyObject_Call(opt_cls, empty, okw);
  PyObject *loss = PyObject_CallFunction(loss_cls, "s", loss_type);
  int32_t rc = -1;
  if (opt && loss) {
    PyObject *compile_fn = PyObject_GetAttrString(m->model, "compile");
    if (compile_fn) {
      PyObject *kw =
          Py_BuildValue("{s:O,s:O}", "optimizer", opt, "loss_type", loss);
      PyObject *r = PyObject_Call(compile_fn, empty, kw);
      Py_XDECREF(kw);
      Py_DECREF(compile_fn);
      if (r) {
        Py_DECREF(r);
        // every step takes key(0), as the JAX package's C API does
        Py_INCREF(Py_None);
        m->rng = Py_None;
        m->compiled = true;
        rc = 0;
      }
    }
  }
  if (rc != 0) report_and_clear();
  Py_XDECREF(opt);
  Py_XDECREF(loss);
  Py_DECREF(okw);
  Py_DECREF(empty);
  Py_DECREF(opt_cls);
  Py_DECREF(loss_cls);
  return rc;
}

double ffc_model_fit_step(ffc_model_t *handle, const double *x,
                          const int64_t *x_shape, int32_t x_ndims,
                          const double *y, const int64_t *y_shape,
                          int32_t y_ndims, int32_t y_is_labels) {
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  if (!m->compiled) return -1.0;
  PyObject *xa = array_from(x, x_shape, x_ndims, false);
  PyObject *ya = array_from(y, y_shape, y_ndims, y_is_labels != 0);
  if (!xa || !ya) {
    report_and_clear();
    Py_XDECREF(xa);
    Py_XDECREF(ya);
    return -1.0;
  }
  PyObject *executor = PyObject_GetAttrString(m->model, "executor");
  PyObject *inputs = PyList_New(1);
  Py_INCREF(xa);
  PyList_SetItem(inputs, 0, xa);
  PyObject *mets = executor ? PyObject_CallMethod(executor, "train_batch",
                                                  "OOO", inputs, ya, m->rng)
                            : nullptr;
  double loss = -1.0;
  if (mets) {
    PyObject *key = PyUnicode_FromString("loss");
    PyObject *l = key ? PyObject_GetItem(mets, key) : nullptr;
    Py_XDECREF(key);
    if (l) {
      PyObject *f = PyNumber_Float(l);
      if (f) {
        loss = PyFloat_AsDouble(f);
        Py_DECREF(f);
      }
      Py_DECREF(l);
    }
    Py_DECREF(mets);
  }
  if (loss < 0 && PyErr_Occurred()) report_and_clear();
  Py_XDECREF(executor);
  Py_DECREF(inputs);
  Py_DECREF(xa);
  Py_DECREF(ya);
  return loss;
}

int64_t ffc_model_predict(ffc_model_t *handle, const double *x,
                          const int64_t *x_shape, int32_t x_ndims,
                          double *out, int64_t out_capacity,
                          int64_t *out_shape, int32_t *out_ndims) {
  // Forward pass on one input batch; flattens the first model output
  // into the caller's float64 buffer. Returns the element count written,
  // or -1 on error / insufficient capacity.
  Model *m = reinterpret_cast<Model *>(handle);
  Gil gil;
  if (!m->compiled) return -1;
  PyObject *xa = array_from(x, x_shape, x_ndims, false);
  if (!xa) {
    report_and_clear();
    return -1;
  }
  PyObject *executor = PyObject_GetAttrString(m->model, "executor");
  PyObject *inputs = PyList_New(1);
  Py_INCREF(xa);
  PyList_SetItem(inputs, 0, xa);
  PyObject *outs = executor
                       ? PyObject_CallMethod(executor, "predict", "O", inputs)
                       : nullptr;
  int64_t written = -1;
  if (outs && PySequence_Check(outs) && PySequence_Size(outs) > 0) {
    PyObject *first = PySequence_GetItem(outs, 0);
    // the output tensor on the host (it lies on the card unless the
    // model runs on the CPU)
    PyObject *host = first ? PyObject_CallMethod(first, "cpu", nullptr) : nullptr;
    PyObject *np = PyImport_ImportModule("numpy");
    // bulk copy through tobytes() — no per-element Python objects on the
    // inference hot path (mirror of array_from's frombuffer direction)
    PyObject *arr = np && host ? PyObject_CallMethod(np, "ascontiguousarray", "Os", host, "float64") : nullptr;
    PyObject *bytes = arr ? PyObject_CallMethod(arr, "tobytes", nullptr) : nullptr;
    char *buf = nullptr;
    Py_ssize_t blen = 0;
    if (bytes && PyBytes_AsStringAndSize(bytes, &buf, &blen) == 0) {
      int64_t n = blen / (Py_ssize_t)sizeof(double);
      if (n <= out_capacity) {
        std::memcpy(out, buf, (size_t)blen);
        written = n;
        if (out_shape && out_ndims) {
          PyObject *shp = PyObject_GetAttrString(arr, "shape");
          int32_t nd = static_cast<int32_t>(PyTuple_Size(shp));
          for (int32_t i = 0; i < nd && i < *out_ndims; ++i)
            out_shape[i] = PyLong_AsLongLong(PyTuple_GetItem(shp, i));
          *out_ndims = nd;
          Py_DECREF(shp);
        }
      }
    }
    Py_XDECREF(bytes);
    Py_XDECREF(arr);
    Py_XDECREF(np);
    Py_XDECREF(host);
    Py_XDECREF(first);
  }
  if (written < 0) report_and_clear();
  Py_XDECREF(outs);
  Py_XDECREF(executor);
  Py_DECREF(inputs);
  Py_DECREF(xa);
  return written;
}

}  // extern "C"
