"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``openvivqa_tpu_torch/csrc/*.cu`` are compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together, then one link) into
one shared library with a plain C interface, at first use, into ``build/kernels/``
at the root of the checkout (named by a hash of the sources and flags, so an edit
rebuilds).  The library is loaded with ``ctypes``; every entry
takes raw device pointers and the current CUDA stream and returns
``cudaGetLastError()``, which :func:`launch` turns into an exception.

The device rule every wrapper follows (:func:`uses_kernel`): tensors on the CPU go
to the kernel's plain PyTorch version, tensors on one CUDA device go to the
kernel, anything else raises.  There is no fallback from a CUDA tensor to the
plain version.

Each wrapper counts one launch where it launches its kernel and nowhere else
(the counter ``kernel.<wrapper>`` of ``utils.tracing``; :func:`launch_counts`
reads them), so a run can show that it went through the kernels; kernels C and
F also tally their launches by row count (:func:`launch_counts_by_rows`).

:func:`gemm_plan` cuts each product of kernels C and F over the card (tile,
K split, cluster): the launch plan lives here, where the CPU tests reach it, and
the C entries take it as arguments.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the wrappers whose launches are counted, each as the counter kernel.<name> of
# utils.tracing; kernels C and F also as kernel.<name>@<rows>
WRAPPERS = (
    "fused_ffn_step",
    "fused_encoder_self_attention",
    "fused_attention_packed",
    "fused_bert_self_step",
    "fused_attention_packed_dropout",
    "fused_attention_packed_dropout_backward",
    "fused_self_attention_step",
    "fused_cross_attention_step",
    "fused_decoder_layer_step",
    "fused_cross_attention_streamed",
    "fused_attention_packed_2bias",
    "fused_attention_packed_streamed",
    "fused_attention",
)
# the wrappers counted by row count too, for the kernels whose launches fall
# at very different row counts (encodes, TextBert, decode steps)
BY_ROWS = ("fused_ffn_step", "fused_encoder_self_attention")
_reset_at: Dict[str, int] = {}  # the kernel counters at the last reset

# C entry -> argument kinds: p pointer, i int, l long long, f float (the
# trailing stream argument is added by `launch`)
_SIGNATURES = {
    "ovq_ffn_forward": "p" * 11 + "i" * 13 + "f",
    "ovq_encoder_attention_forward": "p" * 13 + "i" * 15 + "ff",
    "ovq_packed_attention_forward": "pppp" "li" "p" "iiiii" "f" "i",
    "ovq_bert_self_step_forward": "p" * 16 + "i" * 10 + "ff",
    "ovq_packed_dropout_forward": "pppp" "li" "p" "if" "ppp" "iiiii" "f" "i",
    "ovq_packed_dropout_backward": "ppppp" "li" "f" "ppp" "ppp" "iiiii" "f" "ii",
    "ovq_self_attention_step_forward": "p" * 15 + "i" * 10 + "ff",
    "ovq_cross_attention_step_forward": "p" * 14 + "i" * 9 + "ff",
    "ovq_decoder_layer_step_forward": "p" * 36 + "i" * 17 + "ff",
    "ovq_cross_attention_streamed_forward": "p" * 14 + "i" * 9 + "ff",
    "ovq_packed_2bias_attention_forward": "pppp" "li" "p" "l" "p" "iiiii" "f" "i",
    "ovq_streamed_attention_forward": "pppp" "li" "pp" "iiiii" "iiiii" "f",
    "ovq_flat_attention_forward": "plli" * 3 + "pllii" "plli" "iiiiii" "f",
    "ovq_single_query_attention_forward": "plli" * 3 + "pllii" "plli" "iiiiii" "f",
}
_CTYPES = {
    "p": ctypes.c_void_p, "i": ctypes.c_int,
    "l": ctypes.c_longlong, "f": ctypes.c_float,
}

_lib: Optional[ctypes.CDLL] = None
_entries: Dict[str, object] = {}  # C entry -> its ctypes function, bound once
build_seconds = 0.0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built from "
            "openvivqa_tpu_torch/csrc at first use"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libopenvivqa_kernels_{digest.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on ``build/kernels/.lock``: processes that start cold
    together (the ranks of one machine) build the library once, one after the
    other finding it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as handle:
        fcntl.flock(handle, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(handle, fcntl.LOCK_UN)


def build() -> Path:
    """Compile the kernels unless the library for these sources exists: every
    source to its object file in parallel, then one link, under a file lock
    shared by the processes of one checkout.  The nvcc output (with ptxas's
    registers and spills per kernel) is kept beside the library as
    ``<library>.log``."""
    target = library_path()
    if target.is_file():
        return target
    with _build_lock():
        if not target.is_file():
            _compile(target)
    return target


def _compile(target: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="objects_", dir=BUILD_DIR) as objects:
        jobs = []
        for source in sorted(CSRC.glob("*.cu")):
            obj = Path(objects) / f"{source.stem}.o"
            jobs.append((source, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        outputs = [(source, proc.communicate()[0], proc.returncode) for source, _, proc in jobs]
        log = "".join(f"== {source.name}\n{out}" for source, out, _ in outputs)
        failed = [source.name for source, _, code in outputs if code != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        partial = target.with_name(f"{target.name}.{os.getpid()}.partial")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(partial), *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}{link.stderr}")
    build_seconds = time.perf_counter() - start
    target.with_name(f"{target.name}.log").write_text(log + link.stdout + link.stderr)
    os.replace(partial, target)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; its entries are bound
    to their argument types once, here."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, kinds in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _entries[name] = fn
        loaded.ovq_error_string.argtypes = [ctypes.c_int]
        loaded.ovq_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def launch(entry: str, *args) -> None:
    """Call a C entry on torch's current stream of the current device (its raw
    handle, without building a Stream object); raise if it reports a CUDA
    error."""
    if _lib is None:
        lib()
    err = _entries[entry](*args, torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if err != 0:
        message = _lib.ovq_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({message})")


def ptr(tensor: Optional[torch.Tensor]) -> Optional[int]:
    return None if tensor is None else tensor.data_ptr()


def count(name: str, rows: Optional[int] = None) -> None:
    tracing.count(f"kernel.{name}")
    if rows is not None:
        tracing.count(f"kernel.{name}@{rows}")


def _since_reset() -> Dict[str, int]:
    return {key: value - _reset_at.get(key, 0)
            for key, value in tracing.counters("kernel.").items()}


def reset_launch_counts() -> None:
    """Launch counts start again from 0 (the store's counters go on)."""
    _reset_at.clear()
    _reset_at.update(tracing.counters("kernel."))


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launches since the last reset."""
    counts = _since_reset()
    return {name: counts.get(f"kernel.{name}", 0) for name in WRAPPERS}


def launch_counts_by_rows() -> Dict[str, Dict[int, int]]:
    """Kernels C's and F's launches since the last reset, by rows of the call."""
    counts = _since_reset()
    out = {name: {} for name in BY_ROWS}
    for key, value in counts.items():
        name, _, rows = key[len("kernel."):].partition("@")
        if rows and value:
            out.setdefault(name, {})[int(rows)] = value
    return {name: dict(sorted(by_rows.items())) for name, by_rows in out.items()}


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU (the plain version runs), True
    when all lie on one CUDA device (the kernel runs); raises otherwise."""
    # the decode steps' common case first, without building a device object a tensor
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        if all(t.is_cuda and t.get_device() == index for t in tensors):
            return True
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError(
        "kernel inputs must all lie on the CPU or all on one CUDA device, got "
        f"{sorted(str(d) for d in devices)}"
    )


def kernel_dtype(device: torch.device) -> torch.dtype:
    """Storage type of pre-cast weight matrices and decode caches: bf16 on the
    card (the kernels' dot operand type), float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def require(tensor: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise ValueError unless `tensor` has this dtype, shape and is contiguous."""
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if tensor.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_attention_shape(keys: int, hd: int, heads: int, what: str) -> None:
    """Block B (fused_attention.cu: the packed, dropout and two-bias entries)
    and the streamed block take at least one key and a head dim that is a
    multiple of 16 up to 128."""
    d = hd // heads if heads > 0 else 0
    if keys <= 0 or heads <= 0 or hd % heads or d % 16 or not 0 < d <= 128:
        raise ValueError(
            f"{what}: {keys} keys of head dim {hd}/{heads}: the attention block "
            "takes a head dim that is a multiple of 16 up to 128"
        )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (SM_COUNT for the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return SM_COUNT
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def require_width(hd: int, what: str) -> None:
    """The LayerNorm epilogues (a row over 256 threads of four columns each,
    or a cluster of CTAs of 128 or 256 columns) take widths that are
    multiples of 128 up to 1024."""
    if hd % 128 or not 128 <= hd <= 1024:
        raise ValueError(
            f"{what}: hidden width {hd} is not a multiple of 128 in [128, 1024]"
        )


# -- the launch plan of gemm_sm90.cu (kernels C and F) --------------------------------
SM_COUNT = 132  # streaming multiprocessors of the H100 SXM
MAX_SMEM_BYTES = 232448  # dynamic shared memory of one CTA on the H100
SMEM_PER_SM = 233472  # of all CTAs on one SM, 1 KB of it reserved per CTA
GEMM_BK = 64  # K per pipeline stage
# (rows, columns) of the CTA tiles with the bias epilogue in the GEMM, largest first
GEMM_BIAS_TILES = ((128, 256), (128, 128), (64, 128), (64, 64))
# the tile of the split (partial f32) route at few rows
GEMM_SPLIT_TILE = (64, 64)
# the split route's f32 partial tiles (written once, read once by the reduce
# pass) as a share of the weight's bf16 bytes, at most
GEMM_PARTIAL_SHARE = 0.5


class GemmPlan(NamedTuple):
    """One product's cut over the card (common.cuh's GemmPlan): a bm x bn tile
    per CTA, `splits` CTAs along K over `k_slice` each, and `cluster` 0 for raw
    f32 partial tiles summed by a second pass that runs the epilogue, or >= 1
    for the epilogue in the GEMM (the LayerNorm over `cluster` CTAs along N).
    The fields are in the C entries' argument order."""

    bm: int
    bn: int
    splits: int
    k_slice: int
    cluster: int

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        """CTAs along N, M and K."""
        return -(-n // self.bn), -(-m // self.bm), self.splits

    def ctas(self, m: int, n: int) -> int:
        x, y, z = self.grid(m, n)
        return x * y * z

    def partial_floats(self, m: int, n: int) -> int:
        """f32 workspace of the split route (0 when the epilogue runs in the GEMM)."""
        return 0 if self.cluster else self.splits * m * n


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, n: int, k: int, epilogue: str) -> GemmPlan:
    """The plan of one (m, n, k) product of gemm_sm90.cu, `epilogue` "bias" (to
    bf16, maybe with GELU) or "ln" (residual + LayerNorm over rows of n).

    The bias epilogue takes the largest tile that still puts a CTA on every SM;
    the LayerNorm epilogue a cluster of n / bn CTAs of 128 x bn (bn 256, or 128
    where 256 does not divide n) per row block while those fill the card.
    Otherwise (few rows: the decode and TextBert shapes, where the weights'
    bytes bound the product) 64 x 64 tiles with K split into whole 64-deep
    slices until at least SM_COUNT CTAs stream disjoint slices of the weight,
    unless the f32 partial tiles would outgrow GEMM_PARTIAL_SHARE of the
    weight's bytes (splits * m * n * 4 against k * n * 2): past that K is split
    no further, and a small weight is streamed by fewer CTAs.  A second pass sums
    the slices and runs the epilogue; a bias product that is not split runs its
    epilogue in the GEMM instead."""
    if epilogue not in ("bias", "ln"):
        raise ValueError(f"gemm_plan: unknown epilogue {epilogue!r}")
    if m <= 0 or n <= 0 or k <= 0 or n % 8 or k % 8:
        raise ValueError(
            f"gemm_plan: ({m} x {k}) @ ({k} x {n}) needs positive sizes and N, K "
            "multiples of 8 (16-byte TMA strides)"
        )
    if epilogue == "ln":
        if n % 128 or n > 1024:
            raise ValueError(f"gemm_plan: the LayerNorm epilogue takes N a multiple of 128 up to 1024, got {n}")
        bn = 256 if n % 256 == 0 else 128
        plan = GemmPlan(128, bn, 1, -(-k // GEMM_BK) * GEMM_BK, n // bn)
        if plan.ctas(m, n) >= SM_COUNT:
            return plan
    else:
        for bm, bn in GEMM_BIAS_TILES:
            plan = GemmPlan(bm, bn, 1, -(-k // GEMM_BK) * GEMM_BK, 1)
            if plan.ctas(m, n) >= SM_COUNT:
                return plan
    bm, bn = GEMM_SPLIT_TILE
    tiles = GemmPlan(bm, bn, 1, k, 0).ctas(m, n)
    blocks = -(-k // GEMM_BK)
    most = max(1, int(GEMM_PARTIAL_SHARE * k * 2 // (m * 4)))  # splits the partials allow
    per_slice = max(1, blocks // -(-SM_COUNT // tiles), -(-blocks // most))
    splits = -(-blocks // per_slice)
    if splits == 1 and epilogue == "bias":
        return GemmPlan(bm, bn, 1, blocks * GEMM_BK, 1)
    return GemmPlan(bm, bn, splits, per_slice * GEMM_BK, 0)
