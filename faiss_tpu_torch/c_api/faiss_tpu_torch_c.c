/* faiss_tpu_torch C API implementation: embeds Python and the
 * faiss_tpu_torch package through the CPython API (the reference's c_api/
 * wraps its C++ classes the same opaque-pointer way).
 *
 * Built by faiss_tpu_torch.c_api.build() with gcc, against python3's own
 * headers and libpython.
 */

#include "faiss_tpu_torch_c.h"

#include <Python.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

struct FaissTpuTorchIndex {
    PyObject* obj; /* faiss_tpu_torch Index instance */
};

static char g_err[4096];
static PyObject* g_mod = NULL;    /* faiss_tpu_torch module */
static PyObject* g_np = NULL;     /* numpy module */
static PyObject* g_kwargs = NULL; /* {"device": <init's device>} */

static void set_err_from_python(void) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    if (value) {
        PyObject* s = PyObject_Str(value);
        if (s) {
            snprintf(g_err, sizeof(g_err), "%s", PyUnicode_AsUTF8(s));
            Py_DECREF(s);
        }
    } else {
        snprintf(g_err, sizeof(g_err), "unknown error");
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

const char* faiss_tpu_torch_get_last_error(void) {
    return g_err;
}

int faiss_tpu_torch_init(const char* repo_path, const char* device) {
    if (g_mod) {
        return 0;
    }
    if (!device || !device[0]) {
        snprintf(g_err, sizeof(g_err), "init: no device given");
        return -1;
    }
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    PyGILState_STATE st = PyGILState_Ensure();
    if (repo_path) {
        PyObject* sys_path = PySys_GetObject("path"); /* borrowed */
        PyObject* p = PyUnicode_FromString(repo_path);
        PyList_Insert(sys_path, 0, p);
        Py_DECREF(p);
    }
    g_np = PyImport_ImportModule("numpy");
    g_mod = g_np ? PyImport_ImportModule("faiss_tpu_torch") : NULL;
    int rc = -1;
    if (g_mod && g_np) {
        /* the device as the package checks it: with no card, "cuda" fails
         * here and not at the first index */
        PyObject* base = PyImport_ImportModule("faiss_tpu_torch.base");
        PyObject* dev = base ? PyObject_CallMethod(
                                       base, "require_device", "s", device)
                             : NULL;
        if (dev) {
            g_kwargs = Py_BuildValue("{s:O}", "device", dev);
            rc = g_kwargs ? 0 : -1;
        }
        Py_XDECREF(dev);
        Py_XDECREF(base);
    }
    if (rc) {
        set_err_from_python();
        Py_CLEAR(g_mod);
    }
    PyGILState_Release(st);
    return rc;
}

/* getattr(g_mod, name)(*args, device=...) */
static PyObject* call_on_device(const char* name, PyObject* args) {
    PyObject* fn = args ? PyObject_GetAttrString(g_mod, name) : NULL;
    PyObject* r = fn ? PyObject_Call(fn, args, g_kwargs) : NULL;
    Py_XDECREF(fn);
    Py_XDECREF(args);
    return r;
}

void faiss_tpu_torch_shutdown(void) {
    /* the embedded interpreter stays up for the process lifetime (torch
     * does not support re-initialization) */
}

/* wrap a const float buffer as a read-only numpy array [n, d] (no copy) */
static PyObject* wrap_f32(const float* x, long long n, long long d) {
    PyObject* mv = PyMemoryView_FromMemory(
            (char*)x, (Py_ssize_t)(n * d * 4), PyBUF_READ);
    if (!mv) {
        return NULL;
    }
    PyObject* flat = PyObject_CallMethod(
            g_np, "frombuffer", "Os", mv, "float32");
    Py_DECREF(mv);
    if (!flat) {
        return NULL;
    }
    PyObject* arr = PyObject_CallMethod(flat, "reshape", "LL", n, d);
    Py_DECREF(flat);
    return arr;
}

static PyObject* wrap_i64(const int64_t* x, long long n) {
    PyObject* mv = PyMemoryView_FromMemory(
            (char*)x, (Py_ssize_t)(n * 8), PyBUF_READ);
    if (!mv) {
        return NULL;
    }
    PyObject* arr =
            PyObject_CallMethod(g_np, "frombuffer", "Os", mv, "int64");
    Py_DECREF(mv);
    return arr;
}

int faiss_tpu_torch_index_factory(
        FaissTpuTorchIndex** out,
        int d,
        const char* description,
        int metric) {
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject* idx = call_on_device(
            "index_factory", Py_BuildValue("(isi)", d, description, metric));
    if (idx) {
        *out = (FaissTpuTorchIndex*)malloc(sizeof(FaissTpuTorchIndex));
        (*out)->obj = idx;
        rc = 0;
    } else {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

void faiss_tpu_torch_Index_free(FaissTpuTorchIndex* index) {
    if (!index) {
        return;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF(index->obj);
    PyGILState_Release(st);
    free(index);
}

faiss_tpu_torch_idx_t faiss_tpu_torch_Index_ntotal(const FaissTpuTorchIndex* index) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* v = PyObject_GetAttrString(index->obj, "ntotal");
    long long n = v ? PyLong_AsLongLong(v) : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return (faiss_tpu_torch_idx_t)n;
}

int faiss_tpu_torch_Index_d(const FaissTpuTorchIndex* index) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* v = PyObject_GetAttrString(index->obj, "d");
    int d = v ? (int)PyLong_AsLong(v) : -1;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return d;
}

int faiss_tpu_torch_Index_is_trained(const FaissTpuTorchIndex* index) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* v = PyObject_GetAttrString(index->obj, "is_trained");
    int t = v ? PyObject_IsTrue(v) : 0;
    Py_XDECREF(v);
    PyGILState_Release(st);
    return t;
}

static int call_with_matrix(
        PyObject* obj,
        const char* method,
        faiss_tpu_torch_idx_t n,
        const float* x,
        int d) {
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject* arr = wrap_f32(x, n, d);
    if (arr) {
        PyObject* r = PyObject_CallMethod(obj, method, "O", arr);
        Py_DECREF(arr);
        if (r) {
            Py_DECREF(r);
            rc = 0;
        }
    }
    if (rc) {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int faiss_tpu_torch_Index_train(
        FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x) {
    return call_with_matrix(
            index->obj, "train", n, x, faiss_tpu_torch_Index_d(index));
}

int faiss_tpu_torch_Index_add(
        FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x) {
    return call_with_matrix(
            index->obj, "add", n, x, faiss_tpu_torch_Index_d(index));
}

int faiss_tpu_torch_Index_add_with_ids(
        FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x,
        const faiss_tpu_torch_idx_t* ids) {
    int d = faiss_tpu_torch_Index_d(index);
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject* arr = wrap_f32(x, n, d);
    PyObject* ida = wrap_i64((const int64_t*)ids, n);
    if (arr && ida) {
        PyObject* r = PyObject_CallMethod(
                index->obj, "add_with_ids", "OO", arr, ida);
        if (r) {
            Py_DECREF(r);
            rc = 0;
        }
    }
    Py_XDECREF(arr);
    Py_XDECREF(ida);
    if (rc) {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int faiss_tpu_torch_Index_search(
        const FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t n,
        const float* x,
        faiss_tpu_torch_idx_t k,
        float* distances,
        faiss_tpu_torch_idx_t* labels) {
    int d = faiss_tpu_torch_Index_d(index);
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject* arr = wrap_f32(x, n, d);
    PyObject* res = NULL;
    if (arr) {
        res = PyObject_CallMethod(index->obj, "search", "OL", arr, k);
        Py_DECREF(arr);
    }
    if (res) {
        PyObject* D = PyTuple_GetItem(res, 0); /* borrowed */
        PyObject* I = PyTuple_GetItem(res, 1);
        /* copy out via tobytes on contiguous float32/int64 views */
        PyObject* Df = PyObject_CallMethod(
                g_np, "ascontiguousarray", "Os", D, "float32");
        PyObject* If = PyObject_CallMethod(
                g_np, "ascontiguousarray", "Os", I, "int64");
        if (Df && If) {
            PyObject* db = PyObject_CallMethod(Df, "tobytes", NULL);
            PyObject* ib = PyObject_CallMethod(If, "tobytes", NULL);
            if (db && ib) {
                memcpy(distances,
                       PyBytes_AsString(db),
                       (size_t)(n * k * 4));
                memcpy(labels, PyBytes_AsString(ib), (size_t)(n * k * 8));
                rc = 0;
            }
            Py_XDECREF(db);
            Py_XDECREF(ib);
        }
        Py_XDECREF(Df);
        Py_XDECREF(If);
        Py_DECREF(res);
    }
    if (rc) {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int faiss_tpu_torch_Index_reset(FaissTpuTorchIndex* index) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* r = PyObject_CallMethod(index->obj, "reset", NULL);
    int rc = r ? 0 : -1;
    Py_XDECREF(r);
    if (rc) {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int faiss_tpu_torch_Index_reconstruct(
        const FaissTpuTorchIndex* index,
        faiss_tpu_torch_idx_t key,
        float* recons) {
    int d = faiss_tpu_torch_Index_d(index);
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject* r = PyObject_CallMethod(index->obj, "reconstruct", "L", key);
    if (r) {
        PyObject* rf = PyObject_CallMethod(
                g_np, "ascontiguousarray", "Os", r, "float32");
        if (rf) {
            PyObject* b = PyObject_CallMethod(rf, "tobytes", NULL);
            if (b) {
                memcpy(recons, PyBytes_AsString(b), (size_t)d * 4);
                rc = 0;
                Py_DECREF(b);
            }
            Py_DECREF(rf);
        }
        Py_DECREF(r);
    }
    if (rc) {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int faiss_tpu_torch_Index_set_parameter(
        FaissTpuTorchIndex* index,
        const char* name,
        double value) {
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject* ps = PyObject_CallMethod(g_mod, "ParameterSpace", NULL);
    if (ps) {
        PyObject* r = PyObject_CallMethod(
                ps,
                "set_index_parameter",
                "Osd",
                index->obj,
                name,
                value);
        if (r) {
            Py_DECREF(r);
            rc = 0;
        }
        Py_DECREF(ps);
    }
    if (rc) {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int faiss_tpu_torch_write_index(const FaissTpuTorchIndex* index, const char* fname) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* r = PyObject_CallMethod(
            g_mod, "write_index", "Os", index->obj, fname);
    int rc = r ? 0 : -1;
    Py_XDECREF(r);
    if (rc) {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int faiss_tpu_torch_read_index(
        FaissTpuTorchIndex** out,
        const char* fname,
        int io_flags) {
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    PyObject* idx = call_on_device(
            "read_index", Py_BuildValue("(si)", fname, io_flags));
    if (idx) {
        *out = (FaissTpuTorchIndex*)malloc(sizeof(FaissTpuTorchIndex));
        (*out)->obj = idx;
        rc = 0;
    } else {
        set_err_from_python();
    }
    PyGILState_Release(st);
    return rc;
}
