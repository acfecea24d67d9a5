"""Building the CUDA sources of ``phyx_tpu_torch/csrc`` with ``nvcc``.

Each source becomes a shared library with a plain C interface, loaded with
``ctypes``.  It is compiled at first use on a machine with the CUDA
toolkit, into ``phyx_tpu_torch/_build/``, and named by a hash of the flags,
the source and every header it includes from ``csrc`` (so an edited header
never loads a stale library).  ``compile_all`` starts one ``nvcc`` per
source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

from phyx_tpu_torch import tracing

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: every multiply and add rounds on its own, in the written
# order, so a serial kernel and its plain torch version agree to the bit
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def sources_of(source: pathlib.Path) -> list:
    """``source`` and every file it includes with ``#include "..."``,
    transitively, in a fixed order."""
    seen, todo = [], [pathlib.Path(source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / name
                 for name in _INCLUDE.findall(path.read_text())]
    return seen


def library_path(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sources_of(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{pathlib.Path(source).stem}_{h.hexdigest()[:16]}.so"


def compile_all(sources) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together, inside the host span ``build``
    (``tracing.span``).  Returns {source name: nvcc's report} for the
    ones compiled now."""
    missing = [(source, library_path(source)) for source in sources]
    missing = [(source, so) for source, so in missing if not so.exists()]
    if not missing:
        return {}
    with tracing.span("build"):
        return _run_nvcc(missing)


def _run_nvcc(missing) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source, so in missing:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", tmp, str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((source, so, tmp, proc))
    reports, failed = {}, []
    try:
        for source, so, tmp, proc in running:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"{pathlib.Path(source).name} "
                              f"({proc.returncode}):\n{err}")
            else:
                os.replace(tmp, so)   # atomic: concurrent builds agree
                reports[pathlib.Path(source).name] = out + err
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return reports


def load(source: pathlib.Path) -> tuple:
    """(ctypes library, nvcc's report or "" when it was built before)."""
    report = compile_all([source]).get(pathlib.Path(source).name, "")
    return ctypes.CDLL(str(library_path(source))), report
