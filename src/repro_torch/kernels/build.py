"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Every C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; the Python wrappers raise when that is not 0.

Libraries are built at first use into ``_build/`` beside this file (listed
in ``.gitignore``), named by a hash of the source, the shared ``*.cuh``
headers and the flags, so a changed source or header rebuilds and an
unchanged one is reused. `build_all` starts one ``nvcc`` per source at once
(one per unit of a source split in `PARTS`, whose objects are then linked
into its library) and waits for all of them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {"ams_matmul": "ams_matmul.cu", "paged_attention": "paged_attention.cu",
           "contiguous_attention": "contiguous_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# sources compiled as several units at once, each with -D<macro>=0 .. n-1
# (the source says what each unit holds), their objects linked into the one
# library: K1's ~250 kernel instantiations took minutes in one nvcc
PARTS = {"ams_matmul": ("K1_PART", 6)}

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelCount:
    """Plain-integer counters one kernel wrapper keeps: ``launches`` grows by
    one where the wrapper launches its kernel and nowhere else;
    ``plain_on_cuda`` counts calls of the kernel's plain torch version on
    CUDA tensors (a serving run on the card must show 0). A CUDA graph
    replay runs no wrapper: `recorded_counts` takes what a capture added,
    and `add_counts` adds it once per replay."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_on_cuda = 0
        _COUNTS.append(self)

    def reset(self) -> None:
        self.launches = 0
        self.plain_on_cuda = 0


_COUNTS: List[KernelCount] = []


@contextlib.contextmanager
def recorded_counts():
    """Around a CUDA graph capture: yields a list that, on exit, holds
    ``(count, launches, plain_on_cuda)`` for every count the capture moved,
    and sets the counts back (a capture launches nothing)."""
    before = [(c, c.launches, c.plain_on_cuda) for c in _COUNTS]
    moved: List[Tuple[KernelCount, int, int]] = []
    try:
        yield moved
    finally:
        for c, n, p in before:
            if (c.launches, c.plain_on_cuda) != (n, p):
                moved.append((c, c.launches - n, c.plain_on_cuda - p))
            c.launches, c.plain_on_cuda = n, p


def add_counts(moved) -> None:
    """Count one replay of a graph whose capture moved the counts ``moved``
    (from `recorded_counts`)."""
    for c, n, p in moved:
        c.launches += n
        c.plain_on_cuda += p


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the first ``nvcc`` on PATH. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The built library of one source, named by a hash of the source, the
    headers beside it and the flags."""
    text = (CSRC / SOURCES[name]).read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS) + repr(PARTS.get(name))
    digest = hashlib.sha1(text + flags.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named source (default: all) that is not built yet, one
    ``nvcc`` process per source or per unit of a source split in `PARTS`
    (then linked into its library), all started together. Returns
    ``{name: {"seconds": s, "log": ptxas report}}`` for the sources built
    now, ``seconds`` from the start to that library's own end. Raises
    RuntimeError with the compiler's output if one fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = {}               # name -> (tmp, out, [(proc, log file, object or None)])
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = str(CSRC / SOURCES[name])
        if name in PARTS:
            macro, n = PARTS[name]
            units = [(tmp.with_suffix(f".{i}.o"),
                      ["-c", f"-D{macro}={i}", "-o", str(tmp.with_suffix(f".{i}.o")), src])
                     for i in range(n)]
        else:
            units = [(None, ["-shared", "-o", str(tmp), src])]
        jobs[name] = (tmp, out, [(*_nvcc(nvcc, [*NVCC_FLAGS, *args], tmp, i), obj)
                                 for i, (obj, args) in enumerate(units)])
    report = {}
    failed = []
    while jobs:
        time.sleep(0.05)
        for name in [n for n, (_, _, units) in jobs.items()
                     if all(proc.poll() is not None for proc, _, _ in units)]:
            tmp, out, units = jobs.pop(name)
            logs = [log_path.read_text() for _, log_path, _ in units]
            for proc, log_path, _ in units:
                log_path.unlink()
            bad = [(proc.returncode, log) for (proc, _, _), log in zip(units, logs)
                   if proc.returncode != 0]
            objs = [str(obj) for _, _, obj in units if obj is not None]
            if objs and not bad:        # the units' objects into one library
                proc, log_path = _nvcc(nvcc, ["-shared", "-o", str(tmp), *objs], tmp, "link")
                proc.wait()
                logs.append(log_path.read_text())
                log_path.unlink()
                if proc.returncode != 0:
                    bad.append((proc.returncode, logs[-1]))
            for o in objs:
                Path(o).unlink(missing_ok=True)
            if bad:
                failed += [f"{name}: nvcc exited {rc}\n{log}" for rc, log in bad]
                continue
            os.replace(tmp, out)
            log = "".join(logs)
            out.with_suffix(".log").write_text(log)
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def _nvcc(nvcc: str, args: List[str], tmp: Path, tag):
    """Start one ``nvcc`` with its output in a file beside ``tmp`` (a pipe
    would stall a compiler whose ptxas report outgrows the pipe's buffer)."""
    log_path = tmp.with_suffix(f".{tag}.out")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([nvcc, *args], stdout=f, stderr=subprocess.STDOUT)
    return proc, log_path


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check_device(t) -> None:
    """Raise unless ``t`` lies on a Hopper card the sm_90a kernels run on."""
    if not t.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a; device has sm_{cap[0]}{cap[1]}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
