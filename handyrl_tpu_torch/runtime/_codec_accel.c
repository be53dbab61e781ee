/* C accelerator for the pickle-free wire codec (runtime/codec.py).
 *
 * The port's own copy of the JAX package's accelerator: the same wire
 * format byte for byte as the pure-Python encoder (one tag byte per value,
 * big-endian fixed-width lengths, raw C-contiguous array buffers), the same
 * MAX_DEPTH and the same u32 length errors, and the same columnar fill of
 * runtime/batch.py.  The win is the per-small-object overhead (struct.pack,
 * list appends, Python recursion), which dominates episode blocks: arrays
 * were already memcpy-bound.  numpy is driven through cached Python
 * callables (ascontiguousarray / frombuffer / dtype), so this file needs no
 * numpy C-API and is insensitive to its ABI.
 *
 * The module is compiled at first use by runtime/_codec_build.py with
 * plain cc -O2 -shared into build/host/ at the repo root; codec.py falls
 * back to the Python implementation whenever the build or import fails.
 * init(CodecError, numpy) must be called before use (codec.py does).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* shared with the pure-Python encoder (codec.py _MAX_DEPTH): both
 * implementations must accept and reject the same nesting, or a frame
 * encoded on an accelerated host would kill decode on a fallback host */
#define MAX_DEPTH 500

static PyObject *CodecError;       /* class from codec.py */
static PyObject *np_ndarray;       /* numpy.ndarray */
static PyObject *np_scalar_types;  /* (np.bool_, np.integer, np.floating) */
static PyObject *np_ascontiguous;  /* numpy.ascontiguousarray */
static PyObject *np_frombuffer;    /* numpy.frombuffer */
static PyObject *np_dtype;         /* numpy.dtype */

/* ---------------- growing output buffer ---------------- */

typedef struct {
    char *buf;
    Py_ssize_t len, cap;
} Out;

static int out_ensure(Out *o, Py_ssize_t extra) {
    if (o->len + extra <= o->cap) return 0;
    Py_ssize_t cap = o->cap ? o->cap : 256;
    while (cap < o->len + extra) cap *= 2;
    char *nb = PyMem_Realloc(o->buf, cap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    o->buf = nb;
    o->cap = cap;
    return 0;
}

static int out_raw(Out *o, const void *p, Py_ssize_t n) {
    if (out_ensure(o, n) < 0) return -1;
    memcpy(o->buf + o->len, p, n);
    o->len += n;
    return 0;
}

static int out_byte(Out *o, char c) { return out_raw(o, &c, 1); }

static int out_u32(Out *o, uint32_t v) {
    unsigned char b[4] = {(unsigned char)(v >> 24), (unsigned char)(v >> 16),
                          (unsigned char)(v >> 8), (unsigned char)v};
    return out_raw(o, b, 4);
}

static int out_u64be(Out *o, uint64_t v) {
    unsigned char b[8];
    for (int i = 0; i < 8; i++) b[i] = (unsigned char)(v >> (56 - 8 * i));
    return out_raw(o, b, 8);
}

/* ---------------- encode ---------------- */

static int enc(PyObject *obj, Out *o, int depth);

static int enc_len_u32(Out *o, Py_ssize_t n) {
    if (n < 0 || n > 0xFFFFFFFFLL) {
        PyErr_Format(CodecError, "length %zd out of u32 range", n);
        return -1;
    }
    return out_u32(o, (uint32_t)n);
}

static int enc_ndarray(PyObject *obj, Out *o) {
    PyObject *dtype = PyObject_GetAttrString(obj, "dtype");
    if (!dtype) return -1;
    PyObject *hasobj = PyObject_GetAttrString(dtype, "hasobject");
    Py_DECREF(dtype);
    if (!hasobj) return -1;
    int is_obj = PyObject_IsTrue(hasobj);
    Py_DECREF(hasobj);
    if (is_obj < 0) return -1;
    if (is_obj) {
        PyErr_SetString(CodecError, "object-dtype arrays are not wire-encodable");
        return -1;
    }
    /* shape BEFORE ascontiguousarray (which promotes 0-d to 1-d) */
    PyObject *shape = PyObject_GetAttrString(obj, "shape");
    if (!shape) return -1;
    PyObject *arr = PyObject_CallFunctionObjArgs(np_ascontiguous, obj, NULL);
    if (!arr) { Py_DECREF(shape); return -1; }
    PyObject *adt = PyObject_GetAttrString(arr, "dtype");
    PyObject *dts = adt ? PyObject_GetAttrString(adt, "str") : NULL;
    Py_XDECREF(adt);
    PyObject *dtb = dts ? PyUnicode_AsASCIIString(dts) : NULL;
    Py_XDECREF(dts);
    PyObject *raw = dtb ? PyObject_CallMethod(arr, "tobytes", NULL) : NULL;
    Py_DECREF(arr);
    int rc = -1;
    if (raw) {
        Py_ssize_t ndim = PyTuple_GET_SIZE(shape);
        if (out_byte(o, 'a') == 0 &&
            enc_len_u32(o, PyBytes_GET_SIZE(dtb)) == 0 &&
            out_raw(o, PyBytes_AS_STRING(dtb), PyBytes_GET_SIZE(dtb)) == 0 &&
            enc_len_u32(o, ndim) == 0) {
            rc = 0;
            for (Py_ssize_t i = 0; i < ndim && rc == 0; i++) {
                Py_ssize_t d = PyLong_AsSsize_t(PyTuple_GET_ITEM(shape, i));
                if (d == -1 && PyErr_Occurred()) rc = -1;
                else rc = enc_len_u32(o, d);
            }
            if (rc == 0 &&
                (enc_len_u32(o, PyBytes_GET_SIZE(raw)) < 0 ||
                 out_raw(o, PyBytes_AS_STRING(raw), PyBytes_GET_SIZE(raw)) < 0))
                rc = -1;
        }
    }
    Py_DECREF(shape);
    Py_XDECREF(dtb);
    Py_XDECREF(raw);
    return rc;
}

static int enc(PyObject *obj, Out *o, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(CodecError, "nesting too deep");
        return -1;
    }
    if (obj == Py_None) return out_byte(o, 'N');
    if (obj == Py_True) return out_byte(o, 'T');
    if (obj == Py_False) return out_byte(o, 'F');
    if (PyLong_Check(obj)) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
        if (overflow || (v == -1 && PyErr_Occurred())) {
            PyErr_Clear();
            PyErr_Format(CodecError, "int out of i64 range: %R", obj);
            return -1;
        }
        if (out_byte(o, 'i') < 0) return -1;
        return out_u64be(o, (uint64_t)(int64_t)v);
    }
    if (PyFloat_Check(obj)) {
        double d = PyFloat_AS_DOUBLE(obj);
        uint64_t bits;
        memcpy(&bits, &d, 8);
        if (out_byte(o, 'f') < 0) return -1;
        return out_u64be(o, bits);
    }
    if (PyUnicode_Check(obj)) {
        Py_ssize_t n;
        const char *s = PyUnicode_AsUTF8AndSize(obj, &n);
        if (!s) return -1;
        if (out_byte(o, 's') < 0 || enc_len_u32(o, n) < 0) return -1;
        return out_raw(o, s, n);
    }
    if (PyBytes_Check(obj)) {
        if (out_byte(o, 'b') < 0 || enc_len_u32(o, PyBytes_GET_SIZE(obj)) < 0)
            return -1;
        return out_raw(o, PyBytes_AS_STRING(obj), PyBytes_GET_SIZE(obj));
    }
    if (PyByteArray_Check(obj) || PyMemoryView_Check(obj)) {
        PyObject *b = PyBytes_FromObject(obj);
        if (!b) return -1;
        int rc = (out_byte(o, 'b') == 0 &&
                  enc_len_u32(o, PyBytes_GET_SIZE(b)) == 0 &&
                  out_raw(o, PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b)) == 0)
                     ? 0 : -1;
        Py_DECREF(b);
        return rc;
    }
    int is_arr = PyObject_IsInstance(obj, np_ndarray);
    if (is_arr < 0) return -1;
    if (is_arr) return enc_ndarray(obj, o);
    int is_sc = PyObject_IsInstance(obj, np_scalar_types);
    if (is_sc < 0) return -1;
    if (is_sc) {
        PyObject *item = PyObject_CallMethod(obj, "item", NULL);
        if (!item) return -1;
        int rc = enc(item, o, depth + 1);
        Py_DECREF(item);
        return rc;
    }
    if (PyList_Check(obj)) {
        Py_ssize_t n = PyList_GET_SIZE(obj);
        if (out_byte(o, 'l') < 0 || enc_len_u32(o, n) < 0) return -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            /* enc() can call back into Python (numpy, .item()), which can
               release the GIL or run GC; a concurrent mutation of the
               list would leave a borrowed pointer dangling — hold a
               strong ref across the recursive call.  Bounds re-checked:
               a shrink during a callback must not read past the end. */
            if (i >= PyList_GET_SIZE(obj)) {
                PyErr_SetString(CodecError, "list mutated during encode");
                return -1;
            }
            PyObject *item = PyList_GET_ITEM(obj, i);
            Py_INCREF(item);
            int rc = enc(item, o, depth + 1);
            Py_DECREF(item);
            if (rc < 0) return -1;
        }
        return 0;
    }
    if (PyTuple_Check(obj)) {
        Py_ssize_t n = PyTuple_GET_SIZE(obj);
        if (out_byte(o, 't') < 0 || enc_len_u32(o, n) < 0) return -1;
        for (Py_ssize_t i = 0; i < n; i++)
            if (enc(PyTuple_GET_ITEM(obj, i), o, depth + 1) < 0) return -1;
        return 0;
    }
    if (PyDict_Check(obj)) {
        /* snapshot items (strong refs) before encoding: PyDict_Next's
           cursor is invalidated by concurrent mutation during Python
           callbacks — the snapshot turns that into consistent output
           (like Python's items()) instead of undefined behavior */
        PyObject *items = PyDict_Items(obj);
        if (!items) return -1;
        Py_ssize_t n = PyList_GET_SIZE(items);
        if (out_byte(o, 'd') < 0 || enc_len_u32(o, n) < 0) {
            Py_DECREF(items);
            return -1;
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *kv = PyList_GET_ITEM(items, i);
            if (enc(PyTuple_GET_ITEM(kv, 0), o, depth + 1) < 0 ||
                enc(PyTuple_GET_ITEM(kv, 1), o, depth + 1) < 0) {
                Py_DECREF(items);
                return -1;
            }
        }
        Py_DECREF(items);
        return 0;
    }
    PyErr_Format(CodecError, "type %s is not wire-encodable",
                 Py_TYPE(obj)->tp_name);
    return -1;
}

static PyObject *c_dumps(PyObject *self, PyObject *obj) {
    Out o = {NULL, 0, 0};
    if (enc(obj, &o, 0) < 0) {
        PyMem_Free(o.buf);
        return NULL;
    }
    PyObject *res = PyBytes_FromStringAndSize(o.buf, o.len);
    PyMem_Free(o.buf);
    return res;
}

/* ---------------- decode ---------------- */

typedef struct {
    const unsigned char *p;
    Py_ssize_t len, pos;
} In;

static int in_take(In *r, Py_ssize_t n, const unsigned char **out) {
    if (r->pos + n > r->len) {
        PyErr_SetString(CodecError, "truncated message");
        return -1;
    }
    *out = r->p + r->pos;
    r->pos += n;
    return 0;
}

static int in_u32(In *r, uint32_t *v) {
    const unsigned char *b;
    if (in_take(r, 4, &b) < 0) return -1;
    *v = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
         ((uint32_t)b[2] << 8) | (uint32_t)b[3];
    return 0;
}

static uint64_t rd_u64be(const unsigned char *b) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | b[i];
    return v;
}

static PyObject *dec(In *r, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(CodecError, "nesting too deep");
        return NULL;
    }
    const unsigned char *b;
    if (in_take(r, 1, &b) < 0) return NULL;
    switch (*b) {
    case 'N': Py_RETURN_NONE;
    case 'T': Py_RETURN_TRUE;
    case 'F': Py_RETURN_FALSE;
    case 'i': {
        if (in_take(r, 8, &b) < 0) return NULL;
        return PyLong_FromLongLong((long long)(int64_t)rd_u64be(b));
    }
    case 'f': {
        if (in_take(r, 8, &b) < 0) return NULL;
        uint64_t bits = rd_u64be(b);
        double d;
        memcpy(&d, &bits, 8);
        return PyFloat_FromDouble(d);
    }
    case 's': {
        uint32_t n;
        if (in_u32(r, &n) < 0 || in_take(r, n, &b) < 0) return NULL;
        return PyUnicode_DecodeUTF8((const char *)b, n, NULL);
    }
    case 'b': {
        uint32_t n;
        if (in_u32(r, &n) < 0 || in_take(r, n, &b) < 0) return NULL;
        return PyBytes_FromStringAndSize((const char *)b, n);
    }
    case 'a': {
        uint32_t dtn, ndim, rawn;
        const unsigned char *dtb;
        if (in_u32(r, &dtn) < 0 || in_take(r, dtn, &dtb) < 0) return NULL;
        PyObject *dts = PyUnicode_DecodeASCII((const char *)dtb, dtn, NULL);
        if (!dts) return NULL;
        PyObject *dtype = PyObject_CallFunctionObjArgs(np_dtype, dts, NULL);
        Py_DECREF(dts);
        if (!dtype) return NULL;
        if (in_u32(r, &ndim) < 0) { Py_DECREF(dtype); return NULL; }
        if (ndim > 64) {  /* numpy caps at 64 dims; a hostile header must not
                             allocate an absurd tuple */
            Py_DECREF(dtype);
            PyErr_SetString(CodecError, "array rank out of range");
            return NULL;
        }
        PyObject *shape = PyTuple_New(ndim);
        if (!shape) { Py_DECREF(dtype); return NULL; }
        for (uint32_t i = 0; i < ndim; i++) {
            uint32_t d;
            if (in_u32(r, &d) < 0) { Py_DECREF(dtype); Py_DECREF(shape); return NULL; }
            PyObject *di = PyLong_FromUnsignedLong(d);
            if (!di) { Py_DECREF(dtype); Py_DECREF(shape); return NULL; }
            PyTuple_SET_ITEM(shape, i, di);
        }
        if (in_u32(r, &rawn) < 0 || in_take(r, rawn, &b) < 0) {
            Py_DECREF(dtype); Py_DECREF(shape); return NULL;
        }
        PyObject *mem = PyMemoryView_FromMemory((char *)b, rawn, PyBUF_READ);
        PyObject *flat = mem
            ? PyObject_CallFunctionObjArgs(np_frombuffer, mem, dtype, NULL)
            : NULL;
        Py_XDECREF(mem);
        Py_DECREF(dtype);
        /* "(O)" forces a 1-tuple: a bare "O" would SPREAD the shape tuple
           into positional args (reshape() with 0 args for 0-d arrays) */
        PyObject *shaped = flat ? PyObject_CallMethod(flat, "reshape", "(O)", shape) : NULL;
        Py_XDECREF(flat);
        Py_DECREF(shape);
        PyObject *copied = shaped ? PyObject_CallMethod(shaped, "copy", NULL) : NULL;
        Py_XDECREF(shaped);
        return copied;  /* copy detaches from the input buffer's memory */
    }
    case 'l': {
        uint32_t n;
        if (in_u32(r, &n) < 0) return NULL;
        PyObject *lst = PyList_New(0);
        if (!lst) return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *item = dec(r, depth + 1);
            if (!item || PyList_Append(lst, item) < 0) {
                Py_XDECREF(item); Py_DECREF(lst); return NULL;
            }
            Py_DECREF(item);
        }
        return lst;
    }
    case 't': {
        uint32_t n;
        if (in_u32(r, &n) < 0) return NULL;
        /* build as list first: a hostile count must not preallocate */
        PyObject *lst = PyList_New(0);
        if (!lst) return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *item = dec(r, depth + 1);
            if (!item || PyList_Append(lst, item) < 0) {
                Py_XDECREF(item); Py_DECREF(lst); return NULL;
            }
            Py_DECREF(item);
        }
        PyObject *tup = PyList_AsTuple(lst);
        Py_DECREF(lst);
        return tup;
    }
    case 'd': {
        uint32_t n;
        if (in_u32(r, &n) < 0) return NULL;
        PyObject *dct = PyDict_New();
        if (!dct) return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *key = dec(r, depth + 1);
            PyObject *val = key ? dec(r, depth + 1) : NULL;
            if (!val || PyDict_SetItem(dct, key, val) < 0) {
                Py_XDECREF(key); Py_XDECREF(val); Py_DECREF(dct); return NULL;
            }
            Py_DECREF(key);
            Py_DECREF(val);
        }
        return dct;
    }
    default:
        PyErr_Format(CodecError, "unknown tag %c", *b);
        return NULL;
    }
}

static PyObject *c_loads(PyObject *self, PyObject *arg) {
    PyObject *buf = PyBytes_Check(arg) ? Py_NewRef(arg) : PyBytes_FromObject(arg);
    if (!buf) return NULL;
    In r = {(const unsigned char *)PyBytes_AS_STRING(buf),
            PyBytes_GET_SIZE(buf), 0};
    PyObject *obj = dec(&r, 0);
    if (obj && r.pos != r.len) {
        Py_DECREF(obj);
        obj = NULL;
        PyErr_SetString(CodecError, "trailing bytes after message");
    }
    if (!obj && !PyErr_ExceptionMatches(CodecError)
        && PyErr_ExceptionMatches(PyExc_Exception)) {
        /* mirror codec.loads exactly: any non-CodecError EXCEPTION
           (np.dtype on junk, reshape size mismatch, utf-8 errors,
           unhashable keys) becomes CodecError so connection loops drop
           the peer instead of dying — but KeyboardInterrupt/SystemExit
           (BaseException) propagate, same as the Python implementation */
        PyObject *t, *v, *tb;
        PyErr_Fetch(&t, &v, &tb);
        PyErr_NormalizeException(&t, &v, &tb);
        PyErr_Format(CodecError, "malformed frame: %s: %S",
                     t ? ((PyTypeObject *)t)->tp_name : "Error",
                     v ? v : Py_None);
        Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
    }
    Py_DECREF(buf);
    return obj;
}

/* ---------------- columnar batch fill ----------------
 *
 * Hot path of runtime/batch.py make_batch: each sampled window writes its
 * per-key arrays into a (B, T, ...) output at [b, lo:lo+rows].  For a
 * C-contiguous destination that region is one contiguous byte range, so
 * the whole fancy-indexed numpy assignment (ufunc dispatch, broadcasting
 * machinery, per-call allocation) collapses to a bounds-checked memcpy —
 * fill_column does a whole per-key column (all windows) in one call, and
 * fill_rows broadcasts the value-frozen-at-outcome row.  Python-side
 * (batch.py) pre-checks dtype equality and falls back to numpy on any
 * mismatch; these functions still validate shapes, bounds and itemsize
 * so a buggy caller gets ValueError, never memory corruption.  Buffer
 * protocol only — no numpy C-API, same as the codec.
 */

static Py_ssize_t row_bytes_of(const Py_buffer *b, int from) {
    Py_ssize_t n = b->itemsize;
    for (int i = from; i < b->ndim; i++) n *= b->shape[i];
    return n;
}

static int fmt_equal(const char *a, const char *b) {
    /* NULL format means "B" (unsigned bytes) per the buffer protocol */
    if (!a) a = "B";
    if (!b) b = "B";
    return strcmp(a, b) == 0;
}

static PyObject *c_fill_rows(PyObject *self, PyObject *args) {
    /* broadcast one row (shape == dst.shape[2:]) into dst[b, lo:hi] —
     * the "value frozen at the outcome past episode end" write */
    PyObject *dsto, *rowo;
    Py_ssize_t b, lo, hi;
    if (!PyArg_ParseTuple(args, "OnnnO", &dsto, &b, &lo, &hi, &rowo)) return NULL;
    Py_buffer db, sb;
    if (PyObject_GetBuffer(dsto, &db,
                           PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
        return NULL;
    if (PyObject_GetBuffer(rowo, &sb, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0) {
        PyBuffer_Release(&db);
        return NULL;
    }
    int ok = db.ndim >= 2 && sb.ndim == db.ndim - 2 &&
             db.itemsize == sb.itemsize && fmt_equal(db.format, sb.format);
    for (int i = 0; ok && i < sb.ndim; i++) ok = sb.shape[i] == db.shape[i + 2];
    ok = ok && b >= 0 && b < db.shape[0] && lo >= 0 && hi >= lo && hi <= db.shape[1];
    if (!ok) {
        PyBuffer_Release(&db);
        PyBuffer_Release(&sb);
        PyErr_SetString(PyExc_ValueError,
                        "fill_rows: dst/row shape, dtype or bounds mismatch");
        return NULL;
    }
    Py_ssize_t rb = row_bytes_of(&db, 2);
    char *p = (char *)db.buf + (size_t)(b * db.shape[1] + lo) * (size_t)rb;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t r = lo; r < hi; r++, p += rb)
        memcpy(p, sb.buf, (size_t)rb);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&db);
    PyBuffer_Release(&sb);
    Py_RETURN_NONE;
}

static PyObject *c_fill_column(PyObject *self, PyObject *args) {
    /* fill_column(dst, los, srcs): dst[b, los[b]:los[b]+len(srcs[b])] =
     * srcs[b] for every b — the whole per-key column of a batch in ONE
     * call.  Acquiring the destination buffer once and looping the
     * windows in C is what beats numpy here: per-item buffer-protocol
     * acquisitions cost more on large columns than the fancy-index
     * assignment they replace.  Two phases: validate + acquire every
     * source with the GIL held (shape, bounds, itemsize AND format — a
     * same-width different dtype must raise, never be bit-reinterpreted),
     * then run all memcpys with the GIL RELEASED, so multi-megabyte
     * column copies never stall the learner's other threads. */
    PyObject *dsto, *los, *srcs;
    if (!PyArg_ParseTuple(args, "OOO", &dsto, &los, &srcs)) return NULL;
    Py_buffer db;
    if (PyObject_GetBuffer(dsto, &db,
                           PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
        return NULL;
    PyObject *lof = PySequence_Fast(los, "fill_column: los not a sequence");
    PyObject *srf = lof ? PySequence_Fast(srcs, "fill_column: srcs not a sequence") : NULL;
    if (!srf) {
        Py_XDECREF(lof);
        PyBuffer_Release(&db);
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(lof);
    int ok = db.ndim >= 2 && n == PySequence_Fast_GET_SIZE(srf) && n <= db.shape[0];
    Py_buffer *sbs = NULL;
    Py_ssize_t *offs = NULL;
    Py_ssize_t acquired = 0;
    if (ok && n > 0) {
        sbs = PyMem_Malloc((size_t)n * sizeof(Py_buffer));
        offs = PyMem_Malloc((size_t)n * sizeof(Py_ssize_t));
        if (!sbs || !offs) {
            PyMem_Free(sbs);
            PyMem_Free(offs);
            Py_DECREF(lof);
            Py_DECREF(srf);
            PyBuffer_Release(&db);
            return PyErr_NoMemory();
        }
    }
    Py_ssize_t rb = row_bytes_of(&db, 2);
    for (Py_ssize_t b = 0; ok && b < n; b++) {
        Py_ssize_t lo = PyLong_AsSsize_t(PySequence_Fast_GET_ITEM(lof, b));
        if (lo == -1 && PyErr_Occurred()) { ok = 0; break; }
        Py_buffer *sb = &sbs[b];
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(srf, b), sb,
                               PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0) { ok = 0; break; }
        acquired = b + 1;
        int good = sb->ndim == db.ndim - 1 && sb->itemsize == db.itemsize &&
                   fmt_equal(db.format, sb->format);
        for (int i = 1; good && i < sb->ndim; i++)
            good = sb->shape[i] == db.shape[i + 1];
        good = good && lo >= 0 && sb->shape[0] <= db.shape[1] - lo;
        offs[b] = (b * db.shape[1] + lo) * rb;
        ok = good;
    }
    if (ok && n > 0 && rb > 0) {
        Py_BEGIN_ALLOW_THREADS
        for (Py_ssize_t b = 0; b < n; b++)
            if (sbs[b].len > 0)
                memcpy((char *)db.buf + (size_t)offs[b], sbs[b].buf,
                       (size_t)sbs[b].len);
        Py_END_ALLOW_THREADS
    }
    for (Py_ssize_t b = 0; b < acquired; b++)
        PyBuffer_Release(&sbs[b]);
    PyMem_Free(sbs);
    PyMem_Free(offs);
    Py_DECREF(lof);
    Py_DECREF(srf);
    PyBuffer_Release(&db);
    if (!ok) {
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError,
                            "fill_column: dst/src shape, dtype or bounds mismatch");
        return NULL;
    }
    Py_RETURN_NONE;
}

/* ---------------- module ---------------- */

static PyObject *c_init(PyObject *self, PyObject *args) {
    PyObject *err, *np;
    if (!PyArg_ParseTuple(args, "OO", &err, &np)) return NULL;
    Py_XDECREF(CodecError);
    CodecError = Py_NewRef(err);
#define GRAB(dst, name)                                   \
    do {                                                  \
        Py_XDECREF(dst);                                  \
        dst = PyObject_GetAttrString(np, name);           \
        if (!dst) return NULL;                            \
    } while (0)
    GRAB(np_ndarray, "ndarray");
    GRAB(np_ascontiguous, "ascontiguousarray");
    GRAB(np_frombuffer, "frombuffer");
    GRAB(np_dtype, "dtype");
#undef GRAB
    PyObject *b = PyObject_GetAttrString(np, "bool_");
    PyObject *i = PyObject_GetAttrString(np, "integer");
    PyObject *f = PyObject_GetAttrString(np, "floating");
    if (!b || !i || !f) { Py_XDECREF(b); Py_XDECREF(i); Py_XDECREF(f); return NULL; }
    Py_XDECREF(np_scalar_types);
    np_scalar_types = PyTuple_Pack(3, b, i, f);
    Py_DECREF(b); Py_DECREF(i); Py_DECREF(f);
    if (!np_scalar_types) return NULL;
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"init", c_init, METH_VARARGS,
     "init(CodecError, numpy) — bind the error class and numpy callables"},
    {"dumps", c_dumps, METH_O, "encode to wire bytes"},
    {"loads", c_loads, METH_O, "decode wire bytes"},
    {"fill_rows", c_fill_rows, METH_VARARGS,
     "fill_rows(dst, b, lo, hi, row) — broadcast row into dst[b, lo:hi]"},
    {"fill_column", c_fill_column, METH_VARARGS,
     "fill_column(dst, los, srcs) — dst[b, los[b]:...] = srcs[b] for every b"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_codec_accel",
    "C accelerator for handyrl_tpu_torch.runtime.codec", -1, methods,
};

PyMODINIT_FUNC PyInit__codec_accel(void) { return PyModule_Create(&moduledef); }
