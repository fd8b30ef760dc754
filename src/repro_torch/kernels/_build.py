"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled on first
use, by ``nvcc`` alone (no PyTorch headers, so a build takes seconds), into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed by a
hash of the source, of every file it ``#include "..."``s (transitively),
and of its flags. The library is loaded with ``ctypes``.
A missing ``nvcc`` or a failed build raises: there is no fallback.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them, so the wall time of a cold build is that of the slowest source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gf256_matmul", "cdc_gearhash", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# flags that one source adds to NVCC_FLAGS (an -I for a header library, say)
EXTRA_FLAGS: dict[str, tuple[str, ...]] = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    the toolkit's default install location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of repro_torch are built from source at first use"
    )


def nvcc_flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def sources_of(name: str, csrc: Path = CSRC) -> list[Path]:
    """``csrc/<name>.cu`` and every file that it includes with
    ``#include "..."``, transitively, each once. An include that does not
    resolve beside its includer (a header of an ``-I`` path) is left out:
    the flags name it."""
    found: list[Path] = []
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0).resolve()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return found


def build_key(name: str, csrc: Path = CSRC) -> str:
    """Hash of the source, the files it includes and its flags: any change
    to one of them gives another library file, so nothing stale loads."""
    digest = hashlib.sha256()
    for path in sources_of(name, csrc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(nvcc_flags(name)).encode())
    return digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{build_key(name)}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a private file, then rename: concurrent builders never see
    # (or load) a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, Path(tmp), out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every named kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns each compiler's output (empty
    for a library that was already built)."""
    started = {n: _start(n) for n in names}
    logs: dict[str, str] = {}
    errors: list[str] = []
    for n, s in started.items():  # wait for every compiler before raising
        try:
            logs[n] = _finish(n, s)
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def build_variants(name: str, sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Ablation builds: one library per named text of ``csrc/<name>.cu``,
    each in its own directory under ``build/kernels/ablate/`` beside copies
    of the headers the source includes, one ``nvcc`` each, all started
    together, with the source's own flags."""
    procs = {}
    for label, text in sources.items():
        out = BUILD_DIR / "ablate" / name / re.sub(r"[^A-Za-z0-9]+", "_", label)
        out.mkdir(parents=True, exist_ok=True)
        for path in sources_of(name)[1:]:
            (out / path.name).write_bytes(path.read_bytes())
        (out / f"{name}.cu").write_text(text)
        lib = out / f"{name}.so"
        cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(lib), str(out / f"{name}.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {label!r} build of {name}.cu:\n{log}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
