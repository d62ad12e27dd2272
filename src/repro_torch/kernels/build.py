"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together), linked into one shared library with a plain
C interface, and loaded with ``ctypes``.  The library goes under
``build/repro_torch_kernels/`` at the root of the checkout (git-ignored),
named by a hash of the sources and flags, so an edited source never loads a
stale build.  The first call in a process builds or loads; later calls
return the loaded library.

Nothing falls back: without ``nvcc``, or when a source does not compile,
:func:`load` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _F, _I, _LL = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, \
    ctypes.c_longlong
# name -> (argtypes, restype) of every extern "C" entry point
SIGNATURES = {
    "zo_dual_perturb": ([_P, _P, _P, _P, _P, _P, _LL, _I, _P], _I),
    "zo_fused_update": ([_P, _P, _P, _P, _P, _LL, _I, _P], _I),
    "gradip_reduce": ([_P, _P, _F, _P, _P, _LL, _P], _I),
    # the flash kernels take their tiling (rows, keys a tile) after is_bf16
    "flash_attn_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                        _I, _F, _I, _I, _I, _P], _I),
    "flash_attn_fwd_probe": ([_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _F, _I, _F, _I, _I, _I, _P, _P], _I),
    "flash_attn_bwd_dq": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _F, _I, _F, _I, _I, _I, _P], _I),
    "flash_attn_bwd_dkv": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _F, _I, _F, _I, _I, _I, _P], _I),
    "flash_attn_bwd_probe": ([_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I,
                              _I, _P, _P], _I),
    "flash_decode": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                      _P], _I),
    "mamba_scan": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                   _I),
    "fixture_double": ([_P, _P, _I, _I, _I, _P], _I),
    # launch-plan queries (kernels/plans.py): shapes in, launches out
    "zo_update_plan": ([_I, _LL, _I, _I, _I, _P], _I),
    "gradip_reduce_plan": ([_LL, _I, _P], _I),
    "flash_attn_fwd_plan": ([_I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "flash_attn_bwd_plan": ([_I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "flash_decode_plan": ([_I, _I, _I, _I, _I, _I, _P], _I),
    "mamba_scan_plan": ([_I, _I, _I, _I, _P], _I),
    "fixture_double_plan": ([_I, _I, _I, _I, _P], _I),
    # launcher state: granted shared bytes, attribute calls
    "fixture_double_smem_state": ([_P], _I),
    # the flash and decode kernels' grants: one instantiation's bytes,
    # attribute calls
    "flash_attn_fwd_smem_state": ([_I, _I, _I, _I, _P], _I),
    "flash_attn_bwd_smem_state": ([_I, _I, _I, _I, _I, _P], _I),
    "flash_decode_smem_state": ([_I, _I, _I, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lib = None
build_seconds = None  # wall time of this process's build (None: loaded)
builds = 0  # nvcc builds in this process (the analyzer's recompile rule)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    for cand in (found,
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built here")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> None:
    """One nvcc per source, all at once, then one link; the compilers'
    output (ptxas register and shared-memory counts) and each source's
    wall seconds go to ptxas.log."""
    global builds
    builds += 1
    tmp = out.parent / f"tmp_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} {time.perf_counter() - t0:.1f} s\n{text}")
        if proc.returncode:
            failed.append(src.name)
    (out.parent / "ptxas.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    so_tmp = tmp / out.name
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-Xcompiler", "-fPIC", "-o", str(so_tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(so_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)


def load():
    """The loaded kernel library (built on first use)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    nvcc = nvcc_path()
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if not out.exists():
        t0 = time.perf_counter()
        _compile(nvcc, out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, (args, res) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    _lib = lib
    return lib


def check(lib, rc: int, what: str) -> None:
    """Raise on a launch the runtime refused (rc = cudaGetLastError)."""
    if rc:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
