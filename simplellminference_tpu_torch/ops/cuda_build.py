"""Build and load the port's hand-written CUDA kernels.

Route: every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into an object file — one ``nvcc`` process per source, all started
together, each one's seconds kept — and one link makes
``libsli_kernels.so``, a shared library with a plain C interface loaded
with :mod:`ctypes`. No PyTorch header is compiled, so a build takes
seconds.

The build runs at first use (never at import), keyed by a hash of the
sources and flags, into ``simplellminference_tpu_torch/_build/<hash>/``
(listed in ``.gitignore``). A failed build raises: no caller falls back
to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libsli_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of csrc/*.cu (every launcher returns an int status).
_SIGNATURES = {
    "sli_paged_append_span": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _P],
    "sli_paged_append_prefill": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    "sli_paged_append_span_e4m3": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sli_paged_append_prefill_e4m3": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sli_paged_append_decode_quant": [_P, _P, _P, _P, _P, _P, _L, _L, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sli_paged_append_prefill_quant": [_P, _P, _P, _P, _P, _P, _L, _L, _L,
                                       _L, _P, _I, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _P],
    "sli_flash_prefill": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L,
                          _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _I, _P,
                          _P],
    "sli_paged_flash_decode": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _F, _F, _I, _I, _P, _P],
    "sli_paged_flash_prefill": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _I, _I, _P, _I, _P, _P],
    "sli_quantized_matmul": [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    "sli_quantized_matmul_mma": [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
    "sli_quantized_matmul_rows_mma": [_P, _L, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _P],
    "sli_quantized_matmul_int4": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P],
    "sli_quantized_matmul_int4_mma": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _P],
    "sli_quantized_matmul_int4_wgmma": [_P, _L, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, _I, _I, _P],
    "sli_quantized_matmul_w8a8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P],
    "sli_quantized_matmul_w8a8_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _P],
    "sli_qkv_fused": [_P, _L, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                      _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                      _P, _P],
    "sli_qkv_fused_mma": [_P, _L, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                          _P, _P, _I, _P, _P],
    "sli_ffn_fused": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _F, _I, _I, _I, _P],
    "sli_ffn_fused_mma": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _F, _P],
    "sli_kv_append": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P],
    "sli_kv_append_e4m3": [_P, _P, _P, _P, _L, _L, _L, _L, _P, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _P],
    "sli_flash_decode": [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _F, _F, _I, _I, _P, _P],
    "sli_qkv_fused_dense": [_P, _L, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                            _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                            _P],
    "sli_wo_ffn_max_grid": [_I, _P],
    "sli_wo_ffn": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "sli_flash_decode_dyn": [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _P],
    # shared-KV pools (absorbed MLA): 1l, 2l, 3l, 8l (4l is
    # sli_paged_flash_decode with a null V pool)
    "sli_paged_append_decode_shared": [_P, _P, _L, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _P],
    "sli_paged_append_prefill_shared": [_P, _P, _L, _L, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _I, _P],
    "sli_flash_prefill_shared": [_P, _P, _P, _L, _L, _L, _L, _I, _I, _I, _I,
                                 _I, _F, _I, _P, _I, _P],
    "sli_paged_flash_prefill_shared": [_P, _L, _L, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                       _I, _P, _I, _P],
}

DTYPE_CODES = {"float32": 0, "bfloat16": 1}
# KV pool dtypes (common.cuh SLI_POOL_*), apart from the activation codes
POOL_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "float8_e4m3fn": 3}

_lock = threading.Lock()
_lib = None
# seconds, cached, dir, ptxas, source_seconds (each nvcc's; a fresh build
# only): filled by build()
build_info: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or ``nvcc`` on the PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into the shared library (once per source hash) and
    return its path. Fills :data:`build_info`."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        build_info.update(seconds=0.0, cached=True, dir=str(out_dir),
                          ptxas=_read(out_dir / "ptxas.log"))
        return lib
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    t0 = time.perf_counter()

    def compile_one(src: Path):
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
               str(obj)]
        t = time.perf_counter()
        run = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return src, obj, run, time.perf_counter() - t

    try:
        srcs = sources()
        # one thread a source, so every nvcc starts at once and each one's
        # own seconds are known
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            done = list(pool.map(compile_one, srcs))
        logs = [f"== {src.name}\n{run.stdout}" for src, _o, run, _t in done]
        failed = [src.name for src, _o, run, _t in done if run.returncode]
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(o) for _s, o, _r, _t in done]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        (tmp / "ptxas.log").write_text("\n".join(logs))
        try:
            tmp.rename(out_dir)
        except OSError:
            # another process finished the same build first
            if not lib.is_file():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      dir=str(out_dir), ptxas=_read(out_dir / "ptxas.log"),
                      source_seconds={src.name: t for src, _o, _r, t in done})
    return lib


def _read(p: Path) -> str:
    return p.read_text() if p.is_file() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every argtype set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.sli_error_string.argtypes = [ctypes.c_int]
            lib.sli_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher reported an error."""
    if code != 0:
        msg = lib.sli_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, not {name}")
    return DTYPE_CODES[name]


def pool_code(dtype) -> int:
    """The code of a KV pool dtype: f32, bf16, int8 (with scale pools) or
    float8_e4m3fn (FP8 KV)."""
    name = str(dtype).replace("torch.", "")
    if name not in POOL_CODES:
        raise TypeError(f"KV pools are float32, bfloat16, int8 or "
                        f"float8_e4m3fn, not {name}")
    return POOL_CODES[name]
