"""Builds the hand-written kernels with ``nvcc`` at first use and loads them.

Each ``csrc/*.cu`` source is compiled to an object by its own ``nvcc``,
all started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
named by a hash of the sources and flags and written under the package's
``_build/`` directory, which git ignores.  Each launcher takes raw device pointers and
the CUDA stream as ``void*``, launches on that stream and returns
``cudaGetLastError()``; `check` raises when that is not 0.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# launcher name → argument types (every device pointer and the stream as void*)
SIGNATURES = {
    # audio, window, dft_re, dft_im, mel_fb, out, batch, samples, n_fft,
    # hop, n_frames, n_bins, n_mels, log_floor, stream
    "stft_logmel_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # qu, qv, k, v, p, lengths, out, lse | NULL, batch, t, heads, head_dim,
    # scale, is_bf16, stream
    "attention_relpos_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # qu, qv, k, v, p, lengths, g, lse, delta, two outputs (dq: dqu, dqv;
    # dkv: dk, dv; dband: dp and the float32 partials), batch, t, heads,
    # head_dim, scale, is_bf16, stream
    **{
        f"attention_relpos_bwd_{name}": (*(_P,) * 11, _I, _I, _I, _I, _F, _I, _P)
        for name in ("dq", "dkv", "dband")
    },
    # qu, k, v, bias, lengths, out, batch, t, heads, head_dim, scale, is_bf16,
    # bias_is_bf16, stream
    "attention_bias_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # xw, w_hh, lengths, h_out, c_out | NULL, gates_out | NULL, batch, t,
    # hidden, reverse, stream
    "lstm_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # gout, gates, c, w_hh_t, lengths, dxw, batch, t, hidden, reverse, stream
    "lstm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # h, dxw, part | NULL, dw, batch, t, hidden, reverse, rows_per_slice,
    # slices, stream
    "lstm_dwhh": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # rows, hidden, SMs → slices, rows per slice (host only; no launch)
    "lstm_dwhh_plan": (_I, _I, _I, _IP, _IP),
    # emit, can_skip, ext_len, input_len, alpha, batch, t, states, stream
    "ctc_alpha": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # emit, alpha, can_skip, ext_len, input_len, ll, g, demit, batch, t,
    # states, stream
    "ctc_beta": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, w, out, batch, t, channels, k, pad_lo, reverse_taps, is_bf16, stream
    "depthwise_conv_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"kernels-{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compiles the kernels unless the library for these sources exists.
    With ``verbose`` the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is printed."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, _, proc in jobs:
        log = proc.communicate()[0]
        if verbose or proc.returncode != 0:
            print(" ".join(cmd) + "\n" + log, flush=True)
        if proc.returncode != 0:
            failed.append(Path(cmd[-1]).name)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            print(link.stdout + link.stderr, flush=True)
            raise RuntimeError(f"nvcc link failed with exit code {link.returncode}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")


def stream_of(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
