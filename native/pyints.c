/* Python ints -> 256-bit little-endian words, in one call over a list.
 *
 * Host side of the port's bulk conversion (`quill_tpu_torch/fields/
 * device.py: from_ints`, `ints_to_tensor`): a witness of 2^22 values
 * turns into field limbs here instead of through `int.to_bytes` and a join
 * a value.  Loaded with `ctypes.PyDLL`, so it runs holding the GIL and
 * reads the list's objects directly.  Exposes:
 *
 *   Py_ssize_t quill_ints_to_words(PyObject *list, uint64_t *out,
 *                                  const uint64_t *mod);
 *
 * Item i of `list` goes to out[4 i .. 4 i + 3], least significant word
 * first, reduced below the 4-word modulus `mod` when `mod` is not NULL
 * (by subtraction: 2^256 / mod must be small, as it is for the BN254
 * moduli).  Only exact ints in [0, 2^256) are taken: the return value is
 * the index of the first item that is anything else (a negative or larger
 * int, a bool, a numpy scalar, ...), or the list's length when every item
 * was written.  The caller converts a list that stops short on its own
 * path.  A `list` that is not a list returns 0.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* v >= m on 4-word little-endian values */
static int geq(const uint64_t *v, const uint64_t *m) {
    for (int k = 3; k >= 0; k--) {
        if (v[k] != m[k]) return v[k] > m[k];
    }
    return 1;
}

static void sub_in_place(uint64_t *v, const uint64_t *m) {
    unsigned __int128 borrow = 0;
    for (int k = 0; k < 4; k++) {
        unsigned __int128 d = (unsigned __int128)v[k] - m[k] - borrow;
        v[k] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
}

#if PY_VERSION_HEX >= 0x030C0000 && PyLong_SHIFT == 30
/* CPython 3.12+: the value's 30-bit digits, read in place (lv_tag holds
 * the digit count above _PyLong_NON_SIZE_BITS and the sign below). */
static int words_of(PyObject *obj, uint64_t *w) {
    const PyLongObject *op = (const PyLongObject *)obj;
    uintptr_t tag = op->long_value.lv_tag;
    if ((tag & _PyLong_SIGN_MASK) == 2) return -1;         /* negative */
    size_t nd = (size_t)(tag >> _PyLong_NON_SIZE_BITS);
    if (nd > 9) return -1;                                   /* >= 2^270 */
    const digit *d = op->long_value.ob_digit;
    w[0] = w[1] = w[2] = w[3] = 0;
    for (size_t i = 0; i < nd; i++) {
        uint64_t x = d[i];
        unsigned bit = 30u * (unsigned)i;
        unsigned k = bit >> 6, s = bit & 63;
        if (k > 3) {
            if (x) return -1;
            continue;
        }
        w[k] |= x << s;
        if (s > 34) {                    /* the digit runs into word k + 1 */
            uint64_t hi = x >> (64 - s);
            if (k == 3) {
                if (hi) return -1;       /* >= 2^256 */
            } else {
                w[k + 1] |= hi;
            }
        }
    }
    return 0;
}
#else
static int words_of(PyObject *obj, uint64_t *w) {
    unsigned char buf[32];
    if (_PyLong_AsByteArray((PyLongObject *)obj, buf, 32, 1, 0) < 0) {
        PyErr_Clear();
        return -1;
    }
    memcpy(w, buf, 32);                  /* little-endian host */
    return 0;
}
#endif

Py_ssize_t quill_ints_to_words(PyObject *list, uint64_t *out,
                               const uint64_t *mod) {
    if (!PyList_Check(list)) return 0;
    Py_ssize_t n = PyList_GET_SIZE(list);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(list, i);
        uint64_t *w = out + 4 * i;
        if (!PyLong_CheckExact(item) || words_of(item, w) < 0) return i;
        if (mod) {
            while (geq(w, mod)) sub_in_place(w, mod);
        }
    }
    return n;
}
