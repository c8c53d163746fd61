"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ctypes.  The
build runs at first use, never at import, into ``tpuenc_torch/_build``
(listed in ``.gitignore``) under a name keyed on a hash of the sources and
flags; it is written to a temporary file and renamed into place, so
concurrent processes never load a half-written library.

Each entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)

# name -> argtypes of each C entry point (all return int, a cudaError_t).
_SIGNATURES = {
    # x, recip, corr, out, B, stream
    "tpuenc_fdct_quantize": [_P, _P, _P, _P, _LL, _P],
    # q, n_blocks, Bp, dcdiff, dc_tab, ac_tab, pattern, pat, ss, se,
    # emit_dc, caps, words, lens, overflow, stream
    "tpuenc_pack_blocks": [_P, _LL, _LL, _P, _P, _P, _IP, _I, _I, _I, _I,
                           _IP, _P, _P, _P, _P],
    # X, L, n_rows, C_in, run, n_runs, caps, n_levels, out, cap_out,
    # out_len, overflow, stream
    "tpuenc_merge_rows": [_P, _P, _LL, _I, _I, _LL, _IP, _I, _P, _I, _P, _P,
                          _P],
    # rows, pos, bits, R, W, out, capW, stream
    "tpuenc_concat_rows": [_P, _P, _P, _LL, _I, _P, _LL, _P],
    # q, n_blocks, Bp, act, n_bands, bands, cap8, cap_f, words, lens,
    # overflow, stream
    "tpuenc_pack_acbands": [_P, _LL, _LL, _P, _I, _IP, _I, _I, _P, _P, _P,
                            _P],
    # q, n_blocks, n_bands, bands, out, stream
    "tpuenc_hist_count": [_P, _LL, _I, _IP, _P, _P],
    # q, n_blocks, Lp, ss, se, run4, size, parts, stream
    "tpuenc_hist_sym": [_P, _LL, _LL, _I, _I, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu"))
        + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpuenc_torch_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the commands at once and raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(out: str) -> None:
    """One nvcc per source, all started together, then one link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objdir = tempfile.mkdtemp(dir=BUILD_DIR)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = []
    cmds = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(objdir, os.path.basename(src) + ".o")
        objs.append(obj)
        cmds.append([_nvcc(), *compile_flags, "-I", CSRC, "-c", "-o", obj, src])
    try:
        _run_all(cmds)
        _run_all([[_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
        shutil.rmtree(objdir, ignore_errors=True)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def on_cuda(t, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (the wrapper then runs
    the plain version); raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel argument must be before its pointer is
    passed."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def int_array(values):
    """A ctypes int array (host memory) for a by-value kernel argument."""
    values = [int(v) for v in values]
    return (ctypes.c_int * max(1, len(values)))(*values)


def stream_of(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
