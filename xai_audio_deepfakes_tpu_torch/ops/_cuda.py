"""Build, load and count the port's hand-written CUDA kernels.

The sources under `csrc/` are compiled with nvcc for `sm_90a`, one nvcc per
source, all started together, into one shared library with a plain C
interface that ctypes loads. The build happens at first use, into the
checkout's `build/kernels/` (listed in `.gitignore`, see `build_dir`); the
library's name carries a hash of the sources and headers, so an edited
file is rebuilt. Nothing
here runs at import time: on a machine without nvcc or a card the module
imports, and only the kernel launches fail.

Each kernel is a registered op in the `NAMESPACE` library (`addv::attention`,
`addv::stft`, `addv::istft`, `addv::ln_gelu`, `addv::ln_gelu_`,
`addv::conv_ln_gelu`, `addv::pos_conv`, `addv::pos_conv_dgrad`), defined
beside its wrapper: the op's CUDA implementation is the ctypes launch, its
CPU implementation the plain version, and its fake implementation gives the
output's shape, so that
`torch.export` keeps each kernel as a node of its own. `LAUNCHES` counts, per
kernel, the launches of the op's CUDA implementation: it adds one where it
launches its kernel and nowhere else, so a run, or a loaded exported graph,
can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("attention.cu", "stft.cu", "istft.cu", "ln_gelu.cu", "conv_ln_gelu.cu", "pos_conv.cu",
           "errors.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

NAMESPACE = "addv"

LAUNCHES = {"attention": 0, "stft": 0, "istft": 0, "ln_gelu": 0, "conv_ln_gelu": 0,
            "pos_conv": 0, "pos_conv_dgrad": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "addv_attention": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _VOID],
    "addv_attention_max_t": [],
    "addv_stft": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                  _INT, _INT, _INT, _INT, _INT, _INT, _VOID],
    "addv_stft_fft": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT, _VOID],
    "addv_istft_fft": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                       _INT, _INT, _INT, _INT, _INT, _INT, _VOID],
    "addv_istft": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
                   _INT, _INT, _INT, _INT, _INT, _INT, _VOID],
    "addv_ln_gelu": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, ctypes.c_float,
                     _INT, _INT, _VOID],
    "addv_ln_gelu_max_c": [],
    "addv_conv_ln_gelu": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT,
                          ctypes.c_float, _INT, _INT, _VOID],
    "addv_conv_ln_gelu_max_c": [],
    "addv_pos_conv": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                      _VOID],
}

_lib: ctypes.CDLL | None = None
build_log: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources_hash() -> str:
    """Hash of the target, the sources and every header under `csrc/`, so
    that an edited header rebuilds the library too."""
    h = hashlib.sha256(ARCH.encode())
    for name in sorted(SOURCES + tuple(p.name for p in CSRC.glob("*.cuh"))):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """`build/kernels/` of the checkout that holds the package, when it is
    writable; for an installed package, the user's cache directory (the
    library's name carries the sources' hash, so versions do not collide)."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file() and os.access(root, os.W_OK):
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "xai_audio_deepfakes_tpu_torch" / "kernels"


def build() -> Path:
    """Compile the kernels (if this version is not built yet) and return the
    library's path. Records the seconds and the ptxas report in `build_log`."""
    out_dir = build_dir()
    lib_path = out_dir / f"libaddvisor_kernels_{_sources_hash()}.so"
    if lib_path.exists():
        build_log.setdefault("seconds", 0.0)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-Xptxas", "-v",
                   "-Xcompiler", "-fPIC", "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report, objs, failed = [], [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            report.append(f"== {src}\n{out}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(report))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    build_log["seconds"] = time.perf_counter() - t0
    build_log["ptxas"] = "\n".join(report)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        lib.addv_error_string.argtypes = [_INT]
        lib.addv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().addv_error_string(err).decode()
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fresh(t: torch.Tensor) -> torch.Tensor:
    """t as a registered op returns it: a tensor that starts its storage.
    A plain version may return a view into one of its intermediates (the
    iSTFT's trim at batch 1), which the op's fake implementation cannot
    describe; the copy changes no value."""
    return t if t.storage_offset() == 0 else t.clone()


def require_cuda(name: str, *tensors: torch.Tensor, dtypes=(torch.float32,)) -> None:
    """Validate what a kernel takes: one CUDA device, dtypes, contiguity."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
