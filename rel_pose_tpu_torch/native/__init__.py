"""ctypes bindings for the native host-pipeline library.

A copy of ``rel_pose_tpu/native/__init__.py`` for the port.  At first use
``make`` (the host ``g++``, no other dependency) builds
``host_pipeline.cpp`` into ``rel_pose_tpu_torch/_build/librelpose_host.so``,
again whenever the source is newer than the library.  The build writes a
temporary file of its own process and thread and renames it into place, so
that no process loads a library that another one is still writing.  Every
entry point returns None when the library is unavailable, and its callers
take the numpy path (``RELPOSE_NO_NATIVE=1`` forces that);
:func:`build_error` says why a build failed.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_pipeline.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "librelpose_host.so")
_lib = None
_build_error = None


def _build():
    """Build into a temporary name, then rename it over ``_LIB_PATH``."""
    global _build_error
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run(["make", "-s", "-C", _DIR, f"OUT={tmp}"],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = repr(e)
        return False
    if r.returncode != 0 or not os.path.exists(tmp):
        _build_error = r.stderr[-2000:] or f"make exited {r.returncode}"
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if os.environ.get("RELPOSE_NO_NATIVE"):
        _lib = False
        return _lib
    stale = (os.path.exists(_LIB_PATH)
             and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH))
    if (not os.path.exists(_LIB_PATH) or stale) and not _build():
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _build_error = repr(e)
        _lib = False
        return _lib
    lib.rp_pair_to_chw_resize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.rp_color_jitter.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.rp_color_jitter_fused.argtypes = lib.rp_color_jitter.argtypes
    lib.rp_resize_quantize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    for fn in (lib.rp_pair_to_chw_resize, lib.rp_color_jitter,
               lib.rp_color_jitter_fused, lib.rp_resize_quantize):
        fn.restype = None
    _lib = lib
    return _lib


# Per-call thread budget.  0 = the library's default (min(ncpu, 16)) --
# right for a single caller, wrong under a multi-worker DataLoader where
# N workers x 16 threads oversubscribe the host.  The DataLoader calls
# set_num_threads with its per-worker share.
_num_threads = 0


def set_num_threads(k):
    global _num_threads
    _num_threads = max(0, int(k))


def _threads(nthreads):
    return nthreads if nthreads else _num_threads


def available():
    return bool(_load())


def library_path():
    return _LIB_PATH


def build_error():
    """Why the library is unavailable (the build's stderr), or None."""
    _load()
    return _build_error


def pair_to_chw_resize(images_u8, out_hw, nthreads=0):
    """(n, H, W, 3) uint8 BGR -> (n, 3, OH, OW) float32, fused nearest
    resize (torch semantics) + transpose.  Returns None if the native
    library is unavailable."""
    lib = _load()
    if not lib:
        return None
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    n, h, w, c = images_u8.shape
    if c != 3:
        raise ValueError(f"expected (n, H, W, 3) images, got "
                         f"{images_u8.shape}")
    oh, ow = out_hw
    out = np.empty((n, 3, oh, ow), dtype=np.float32)
    lib.rp_pair_to_chw_resize(
        images_u8.ctypes.data, n, h, w, out.ctypes.data, oh, ow,
        _threads(nthreads))
    return out


OP_BRIGHTNESS, OP_CONTRAST, OP_SATURATION, OP_HUE, OP_GRAY = 0, 1, 2, 3, 4


def color_jitter(images_f32, ops, vals, nthreads=0, fused=True):
    """In-place jitter on (n, 3, H, W) float32 BGR 0-255.  ``ops`` is a list
    of OP_* codes, ``vals`` the matching factors.  Returns the array, or
    None if the native library is unavailable.

    ``fused=True`` (default) runs the single-pass kernel (whole op chain per
    pixel in registers); ``fused=False`` the one-pass-per-op path (used for
    equivalence testing)."""
    lib = _load()
    if not lib:
        return None
    if images_f32.dtype != np.float32 or not images_f32.flags.c_contiguous:
        raise ValueError("color_jitter needs a C-contiguous float32 array")
    n, c, h, w = images_f32.shape
    ops_arr = np.asarray(ops, dtype=np.int32)
    vals_arr = np.asarray(vals, dtype=np.float32)
    fn = lib.rp_color_jitter_fused if fused else lib.rp_color_jitter
    fn(images_f32.ctypes.data, n, h, w,
       ops_arr.ctypes.data, vals_arr.ctypes.data, len(ops_arr),
       _threads(nthreads))
    return images_f32


def resize_quantize(images_f32, out_hw, nthreads=0):
    """(n, c, H, W) float32 -> (n, c, OH, OW) uint8: nearest resize (torch
    floor semantics) + round-half-even + clamp to [0, 255] in one threaded
    pass (numpy equivalent: fancy-index resize, np.rint, np.clip,
    astype(uint8)).  Returns None if unavailable."""
    lib = _load()
    if not lib:
        return None
    if images_f32.dtype != np.float32 or not images_f32.flags.c_contiguous:
        raise ValueError("resize_quantize needs a C-contiguous float32 array")
    n, c, h, w = images_f32.shape
    oh, ow = out_hw
    out = np.empty((n, c, oh, ow), dtype=np.uint8)
    lib.rp_resize_quantize(images_f32.ctypes.data, n, c, h, w,
                           out.ctypes.data, oh, ow, _threads(nthreads))
    return out
