"""Build and bind the port's CUDA kernels (nvcc by hand + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, one ``nvcc`` per source and all of them started together,
into ``_build/<name>-<hash>.so`` (the hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header is
rebuilt and a stale library never loads).
The build directory is listed in ``.gitignore``.  No PyTorch header is
included, so a build takes seconds, not minutes.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` turns a non-zero
code into an exception.  ``LAUNCHES`` counts kernel launches per wrapper
(each wrapper adds one where it launches, and nowhere else), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("path_lookup", "prefix_search", "decode_attention", "decode_scores", "decode_combine",
           "flash_attention", "flash_attention_bwd", "moe_router", "rmsnorm")
#: streaming multiprocessors of an H100 SXM: the launch geometries' default
#: for callers without a card (the wrappers pass ``sm_count`` of theirs)
N_SM = 132
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: dict[str, int] = {"path_lookup": 0, "prefix_search": 0,
                            "decode_attention": 0, "flash_attention": 0, "rmsnorm": 0,
                            "moe_router": 0, "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                            "moe_router_bwd": 0, "decode_scores": 0, "decode_combine": 0}
#: of those, the launches of the attention kernels' float32 bodies (the
#: rest of LAUNCHES' attention counts are bfloat16)
F32_LAUNCHES: dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_SM_COUNT: dict[int, int] = {}
STREAM_SLOTS = 64     # streams a kernel's counter buffer serves on a device
#: each (kernel, device)'s int32 counters (STREAM_SLOTS slots, zeroed once;
#: a launch leaves its slot's counters 0 again), and the slot of each
#: (kernel, device, stream)
_SLOT_BUFFERS: dict = {}
_STREAM_SLOTS: dict[tuple[str, int, int], int] = {}
_SLOT_LOCK = threading.Lock()


def count_launch(name: str, f32: bool = False) -> None:
    # readers on several threads launch at once; an unlocked += can drop one
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if f32:
            F32_LAUNCHES[name] += 1


def reset_launches() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES):
        for k in counts:
            counts[k] = 0


def nbytes(*tensors) -> int:
    """The bytes of the given tensors (None counts 0): a work rule's
    boundary bytes, each operand read once and each result written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


#: why a kernel with a backward refuses an input that requires grad
VIA_OPS = "call kernels.ops, whose autograd Function runs the backward kernel"


def refuse_grad(name: str, *tensors, why: str = VIA_OPS) -> None:
    """Raise when autograd would need the gradient of a kernel's output:
    the wrappers write through raw pointers, so their outputs carry no
    ``grad_fn``, and returning one would silently drop every gradient
    behind it."""
    import torch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad; {why}")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "the machine with the card (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes running at once.  Returns the seconds each build
    took; the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) lands in ``_build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out, time.perf_counter())
        seconds, errors = {}, []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(lib_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(name: str, code: int) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def stream_slot(name: str, t, stream: int, ints: int) -> int:
    """The address of ``ints`` int32 counters of ``stream`` on t's device
    for the kernel ``name`` (rmsnorm_bwd's dscale arrivals,
    flash_attention_bwd's head-split tickets): a slot of that kernel's
    counter buffer on the device, made (zeroed) on the first call, which
    must therefore come outside CUDA graph capture (a warm-up call does
    it).  Two streams never share a slot, so launches on both at once do
    not count each other's blocks; a graph keeps the slot of the stream
    it was captured on."""
    import torch
    dev = t.get_device()
    with _SLOT_LOCK:
        slot = _STREAM_SLOTS.get((name, dev, stream))
        if slot is None:
            slot = sum(k[:2] == (name, dev) for k in _STREAM_SLOTS)
            if slot >= STREAM_SLOTS:
                raise RuntimeError(f"{name}: more than {STREAM_SLOTS} streams on device {dev}")
            _STREAM_SLOTS[(name, dev, stream)] = slot
        buf = _SLOT_BUFFERS.get((name, dev))
        if buf is None:
            buf = _SLOT_BUFFERS[(name, dev)] = torch.zeros(STREAM_SLOTS * ints,
                                                          dtype=torch.int32, device=t.device)
    return buf.data_ptr() + 4 * ints * slot


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device, as an int for a ``c_void_p`` argument.  It asks for the handle
    alone: ``torch.cuda.current_stream`` builds a Python ``Stream`` object
    on every call, a cost each launch of a small kernel would pay."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked once."""
    n = _SM_COUNT.get(index)
    if n is None:
        import torch
        n = _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def graph_nodes(graph) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True`` and captured, counted through libcuda
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``): a wrapper that launches
    one kernel per call and nothing else adds one kernel node per call."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0          # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, n.value
