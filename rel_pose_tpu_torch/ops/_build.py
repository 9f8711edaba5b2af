"""Build the hand-written CUDA kernels and load them with ctypes.

``nvcc`` compiles every ``rel_pose_tpu_torch/csrc/*.cu`` for Hopper
(``sm_90a``) into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds).  The library lands in
``rel_pose_tpu_torch/_build/`` under a name carrying the hash of the sources
and flags: it is built at first use and rebuilt whenever a source changes.
A failed build raises with nvcc's stderr.  The ``ptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library as
``<name>.log``.

The wrappers pass tensor pointers and the current stream as
``ctypes.c_void_p`` and sizes as ``ctypes.c_int``; every entry point returns
a ``cudaError_t`` which :func:`check` turns into an exception.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I = ctypes.c_void_p, ctypes.c_int

# C signatures of the entry points (csrc/*.cu)
SIGNATURES = {
    "rp_set_device": ([I], ctypes.c_int),
    "rp_error_string": ([I], ctypes.c_char_p),
    # x, pos, out, 12 stacked parameters, 4 scratch buffers;
    # G, N, C, heads, hidden, depth, bf16; stream
    "rp_vit_stack": ([P] * 19 + [I] * 7 + [P], ctypes.c_int),
    # xpair, ln scale, ln bias, w, b, pos, F, 2 scratch buffers;
    # B, N, C, heads, bf16; stream
    "rp_essential_block_pair": ([P] * 9 + [I] * 5 + [P], ctypes.c_int),
}


def _nvcc():
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def sources():
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librelpose_kernels-{h.hexdigest()[:16]}.so"


def build():
    """Compile the kernels unless a library of the current sources exists;
    return its path."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sources() if p.suffix == ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr}")
    so.with_suffix(".log").write_text(res.stderr)
    os.replace(tmp, so)   # atomic: a concurrent loader never sees a partial
    return so


@functools.cache
def library():
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err, what):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().rp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def prepare_launch(device):
    """Make ``device`` current for the kernel library's runtime and return
    the handle of PyTorch's current stream on it."""
    import torch
    check(library().rp_set_device(device.index), "cudaSetDevice")
    return torch.cuda.current_stream(device).cuda_stream
