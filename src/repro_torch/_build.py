"""Build the port's CUDA kernels at first use and bind them with ``ctypes``.

Each ``.cu`` source under ``kernels/*/csrc/`` (NEP K1 and K2, the SSD
chunk step's forward and backward, flash attention's forward and
backward) becomes its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

into ``build/kernels/`` at the repository root.  The file name carries a
hash of the source, every kernel header (a source may include another
kernel's, as the SSD backward includes flash attention's tensor-core
toolset) and the flags, so an edited
source builds anew and an unchanged one is reused.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them; a failed
build raises with nvcc's stderr.  ptxas's register / spill report is kept
beside each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parents[1] / "build" / "kernels"
SOURCES = {
    "nep_atom_pass": PKG_DIR / "kernels" / "nep" / "csrc" / "nep_atom_pass.cu",
    "nep_force_pass": PKG_DIR / "kernels" / "nep" / "csrc" / "nep_force_pass.cu",
    "ssd_chunks": PKG_DIR / "kernels" / "ssd" / "csrc" / "ssd_chunks.cu",
    "ssd_chunks_bwd": (PKG_DIR / "kernels" / "ssd" / "csrc"
                       / "ssd_chunks_bwd.cu"),
    "flash_attention_fwd": (PKG_DIR / "kernels" / "attention" / "csrc"
                            / "flash_attention_fwd.cu"),
    "flash_attention_bwd": (PKG_DIR / "kernels" / "attention" / "csrc"
                            / "flash_attention_bwd.cu"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# libraries compiled and loaded in this process: what "recompiling" means
# for the port (read by repro_torch.telemetry.metrics.CompileWatchdog)
EVENTS = {"builds": 0, "loads": 0}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    for f in sorted((PKG_DIR / "kernels").rglob("*.cuh")):
        h.update(str(f.relative_to(PKG_DIR)).encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` each, concurrently.  Returns seconds per library built."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    secs, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {SOURCES[name].name} (exit "
                          f"{proc.returncode}) ---\n{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)
            EVENTS["builds"] += 1
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
        EVENTS["loads"] += 1
    return lib
