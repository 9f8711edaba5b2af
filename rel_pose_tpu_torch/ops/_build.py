"""Build the hand-written CUDA kernels and load them with ctypes.

``nvcc`` compiles every ``rel_pose_tpu_torch/csrc/*.cu`` for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds).  The library lands in
``rel_pose_tpu_torch/_build/`` under a name carrying the hash of the sources
and flags: it is built at first use and rebuilt whenever a source changes.
A failed build raises with nvcc's stderr.  The ``ptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library as
``<name>.log``.

The wrappers pass tensor pointers and the current stream as
``ctypes.c_void_p``, sizes as ``ctypes.c_int`` and a softmax scale as
``ctypes.c_float``; every entry point returns
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C signatures of the entry points (csrc/*.cu)
SIGNATURES = {
    "rp_set_device": ([I], ctypes.c_int),
    "rp_error_string": ([I], ctypes.c_char_p),
    # x, pos, out, stash (or NULL), 12 stacked parameters, 4 scratch
    # buffers, fp32's weight splits (or NULL); G, N, C, heads, hidden,
    # depth, bf16; stream
    "rp_vit_stack": ([P] * 21 + [I] * 7 + [P], ctypes.c_int),
    # G, N, C, heads, hidden, bf16 -> workspace bytes of rp_vit_stack_bwd
    "rp_vit_stack_bwd_workspace": ([I] * 6, L),
    # xs, g, 12 stacked parameters, dx, 12 fp32 gradients, workspace,
    # fp32's weight splits (or NULL); G, N, C, heads, hidden, depth, bf16;
    # stream
    "rp_vit_stack_bwd": ([P] * 29 + [I] * 7 + [P], ctypes.c_int),
    # The essential block's entry points take the flags has_pos, single,
    # cross after the sizes; pos (and the positional outputs) NULL without
    # positions.
    # B, N, heads, has_pos, bf16 -> workspace bytes of the three forward
    # entry points below
    "rp_essential_block_workspace": ([I] * 5, L),
    # xpair, ln scale, ln bias, w, b, pos, F, 2 scratch buffers, workspace;
    # B, N, C, heads, 3 flags, bf16; stream
    "rp_essential_block_pair": ([P] * 10 + [I] * 8 + [P], ctypes.c_int),
    # x1, x2, w, b, pos, F, qkv scratch, workspace; B, N, C, heads, 3 flags,
    # bf16; stream
    "rp_essential_block_x": ([P] * 8 + [I] * 8 + [P], ctypes.c_int),
    # qkv1, qkv2, pos, F, workspace; B, N, C, heads, 3 flags, bf16; stream
    "rp_essential_block": ([P] * 5 + [I] * 8 + [P], ctypes.c_int),
    # B, N, heads, has_pos, bf16 -> workspace bytes of rp_essential_block_bwd
    "rp_essential_block_bwd_workspace": ([I] * 5, L),
    # qkv, pos, dF, dqkv, dva (cross), dpos partials, workspace; B, N, C,
    # heads, 3 flags, bf16; stream
    "rp_essential_block_bwd": ([P] * 7 + [I] * 8 + [P], ctypes.c_int),
    # q, k, v, o, stats (or NULL); G, N, d, scale, bf16; stream
    "rp_mhsa_fwd": ([P] * 5 + [I] * 3 + [F, I, P], ctypes.c_int),
    # q, k, v, do, dq, dk, dv, stats, T(do / l) scratch, the forward's o;
    # G, N, d, scale, bf16; stream
    "rp_mhsa_bwd": ([P] * 10 + [I] * 3 + [F, I, P], ctypes.c_int),
    # G, N, e, bf16 -> workspace bytes of rp_bilinear_fwd
    "rp_bilinear_fwd_workspace": ([I] * 4, L),
    # q, k, va, vb, F, workspace; G, N, e, single, scale * log2e, bf16;
    # stream
    "rp_bilinear_fwd": ([P] * 6 + [I] * 4 + [F, I, P], ctypes.c_int),
    # G, N, e, bf16 -> workspace bytes of rp_bilinear_bwd
    "rp_bilinear_bwd_workspace": ([I] * 4, L),
    # q, k, va, vb, dF, dq, dk, dva, dvb, workspace; G, N, e, single,
    # scale * log2e, scale, bf16; stream
    "rp_bilinear_bwd": ([P] * 10 + [I] * 4 + [F, F, I, P], ctypes.c_int),
    # one bf16 GEMM of the ViT stack's wgmma body (test only): op, epilogue;
    # a, b, f, r, out, aux, outb, part, bpart; M, N, K; stream
    "rp_gemm_bf16": ([I, I] + [P] * 9 + [I] * 3 + [P], ctypes.c_int),
    # one fp32 GEMM of its TF32 wgmma body (test only): op, epilogue; a, b,
    # f, r, out, aux, weight split scratch, part, bpart; M, N, K; stream
    "rp_gemm_f32": ([I, I] + [P] * 9 + [I] * 3 + [P], ctypes.c_int),
    # B, N, heads, bf16 -> workspace bytes of the two entry points below
    "rp_cross_variants_workspace": ([I] * 4, L),
    # qkv1, qkv2, pos, F, workspace; B, N, C, heads, S, bf16; stream
    "rp_essential_block_s": ([P] * 5 + [I] * 6 + [P], ctypes.c_int),
    # qkv1, qkv2, pos, F, workspace (bf16); B, N, C, heads, mode; stream
    "rp_essential_block_variant": ([P] * 5 + [I] * 5 + [P], ctypes.c_int),
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
    tag = f"{so.stem}.{os.getpid()}"
    cus = [p for p in sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for p, o in zip(cus, objs)]
    logs, failed = [], []
    for p, proc in zip(cus, procs):
        out, err = proc.communicate()
        logs.append(f"== {p.name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{p.name} (exit {proc.returncode}):\n{err}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = so.with_name(f"{tag}.so.tmp")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {res.returncode}):"
                               f"\n{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(logs))
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
