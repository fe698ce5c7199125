"""Build and load the CUDA kernels: ``nvcc`` by hand into one shared library
with a plain C interface, loaded with ``ctypes``.

The build happens at first use, from ``csrc/*.cu`` only, into
``_build/<hash>/`` beside this file (listed in ``.gitignore``; override with
``REPRO_TORCH_BUILD_DIR``).  The hash covers the sources and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.  Each
source compiles in its own ``nvcc`` process, all started together, and the
objects link into ``libavec_kernels.so``.  Nothing here runs at import.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC"] + ARCH_FLAGS
LIB_NAME = "libavec_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict = {}
#: device index -> [SM count, int32 counters, fp32 scratch, outgrown buffers]
_pools: dict = {}
#: launches by kernel name and, where a wrapper picked a branch, by branch
#: name, made outside CUDA graph captures (:func:`count`; read by
#: ``ops.launch_counts``)
launches: collections.Counter = collections.Counter()
#: seconds the last build took (0.0 when the cached library was loaded)
last_build_s: float = 0.0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global last_build_s
    final = build_dir() / source_hash()
    lib = final / LIB_NAME
    if lib.exists():
        last_build_s = 0.0
        return lib
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=build_dir()))
    nvcc = nvcc_path()
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
            *[str(obj) for _, obj, _ in procs]]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    try:
        os.replace(tmp, final)
    except OSError:                   # another process finished the same build
        shutil.rmtree(tmp, ignore_errors=True)
    last_build_s = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, argtypes: list):
    """A C entry point of the kernel library with its argument types set
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def launch(entry: str, argtypes: list, args: tuple, *names: str) -> None:
    """Call C entry point ``entry`` (:func:`function`) with ``args``, raise
    on a refused or failed launch, then :func:`count` one launch of each of
    ``names``: the kernel's and, where the wrapper picked a branch, the
    branch's.  The entry returns the ``cudaGetLastError()`` right after its
    launch, or -1 for an unsupported shape or type."""
    rc = function(entry, argtypes)(*args)
    if rc != 0:
        what = "unsupported arguments" if rc < 0 else f"cudaError_t {rc}"
        raise RuntimeError(f"CUDA kernel {'/'.join(names)} failed to launch: {what}")
    count(*names)


def count(*names: str) -> None:
    """Add one launch to each of ``names`` in :data:`launches`, or nothing
    while the current stream is being captured into a CUDA graph, where the
    launch is recorded and runs nothing.  A graph's replays run its kernels
    without their wrappers, so the counts hold only launches made outside a
    graph; a device trace sees both."""
    import torch
    if not torch.cuda.is_current_stream_capturing():
        for name in names:
            launches[name] += 1


_DTYPE_CODES = {"float32": 0, "bfloat16": 1}    # csrc/common.cuh avec::DType


def dtype_code(t) -> int:
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {name}")
    return _DTYPE_CODES[name]


def current_stream(t) -> int:
    """PyTorch's current stream on ``t``'s device, as an int for ctypes."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def _pool(dev) -> list:
    import torch
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    pool = _pools.get(idx)
    if pool is None:
        pool = _pools[idx] = [torch.cuda.get_device_properties(idx).multi_processor_count,
                              torch.zeros(0, dtype=torch.int32, device=dev),
                              torch.empty(0, dtype=torch.float32, device=dev), []]
    return pool


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev``, read once."""
    return _pool(dev)[0]


def scratch(dev, n_ints: int, n_floats: int):
    """(int32 counters, fp32 scratch) of CUDA device ``dev``, the one pool
    of the kernels that need scratch: ``decode_attention``, ``mamba_step``,
    ``moe_route`` and the SSD scan's tensor-core branch (which carves its
    bf16 regions from the same bytes, ``ssd_scan.tc_scratch``).  The contract they share:
    the counters are zero between calls (each kernel's last blocks reset
    the counters they took), and the scratch holds only what one launch
    writes and reads, so calls on one device must run on one stream, one
    after another, as the model's do.  Reused from call to call, so the
    serving path allocates nothing; grown by :func:`grow_scratch`."""
    return grow_scratch(_pool(dev), n_ints, n_floats)


def grow_scratch(pool: list, n_ints: int, n_floats: int):
    """(counters, scratch) of ``pool``, grown to at least ``n_ints``
    counters (zeroed) and ``n_floats`` floats.  A CUDA graph captured over a
    call keeps addressing the buffers it was captured with, so an outgrown
    buffer is kept, not freed; each growth at least doubles, so those kept
    take less memory than the buffers in use."""
    import torch
    if pool[1].numel() < n_ints:
        pool[3].append(pool[1])
        pool[1] = torch.zeros(max(n_ints, 2 * pool[1].numel(), 256), dtype=torch.int32,
                              device=pool[1].device)
    if pool[2].numel() < n_floats:
        pool[3].append(pool[2])
        pool[2] = torch.empty(max(n_floats, 2 * pool[2].numel(), 1 << 16), dtype=torch.float32,
                              device=pool[2].device)
    return pool[1], pool[2]


def require_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")


def unit_last(t):
    """The kernels address rows through strides but need a unit last stride."""
    return t if t.stride(-1) == 1 else t.contiguous()


def rows_aligned(t) -> bool:
    """True when every row of ``t`` starts on 16 bytes: a unit last stride,
    and the base address and every other stride (of a dimension longer than
    1) a multiple of 16 bytes -- what a 16-byte copy of a row needs (cp.async
    or TMA alike)."""
    strides = t.stride()
    if strides[-1] != 1:
        return False
    shape, bits = t.shape, 0
    for i in range(len(strides) - 1):
        if shape[i] > 1:
            bits |= strides[i]
    return (t.data_ptr() | bits * t.element_size()) % 16 == 0


def aligned_rows(t):
    """``t`` itself when :func:`rows_aligned`, else a fresh contiguous copy
    (a fresh allocation starts on 512 bytes, and the kernels' head dims make
    every row a multiple of 16 bytes)."""
    import torch
    return t if rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
