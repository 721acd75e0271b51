"""Native host runtime: ctypes bindings for the C++ field/MSM library.

The reference framework is a native (Rust) library end-to-end; here the device
compute path is jax/XLA (`ops/`), and this module is the native *host*
complement — fast 256-bit Montgomery batch field ops and a multi-threaded
Pippenger MSM — compiled on demand from `host_field.cpp` with g++ and
loaded via ctypes (no pybind11 in the image).

Public surface:
    available() -> bool, tape_available() -> bool
    NativeField(p)         .mul/.add/.sub/.inv_batch on int lists
    native_msm(curve_spec, points, scalars, threads=os.cpu_count())

Disable with SIRIUS_TPU_NATIVE=0 (pure-python/jax paths everywhere else
remain the source of truth; tests compare this module against
`fields/gold.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..util.cache import DATA_DIR

_SRC = Path(__file__).with_name("host_field.cpp")
_CACHE_DIR = Path(DATA_DIR)

_lib = None
_lib_error: str | None = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: the libraries are built with
    -march=native, so a checkout moved to another CPU must rebuild them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def _build_lib(src_path: Path) -> ctypes.CDLL:
    """Compile `src_path` with g++ (once per source and CPU) and load it."""
    tag = hashlib.sha256(src_path.read_bytes() + _cpu_flags()).hexdigest()[:16]
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    so = _CACHE_DIR / f"{src_path.stem}-{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-o", str(tmp), str(src_path),
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def _load():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    if os.environ.get("SIRIUS_TPU_NATIVE", "1") == "0":
        _lib_error = "disabled via SIRIUS_TPU_NATIVE=0"
        return None
    try:
        lib = _build_lib(_SRC)
    except Exception as exc:  # toolchain missing, compile error, ...
        _lib_error = f"native build failed: {exc}"
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.st_ctx_size.restype = ctypes.c_size_t
    lib.st_init_ctx.argtypes = [ctypes.c_void_p, u64p, u64p]
    for name in ("st_add_batch", "st_sub_batch", "st_mul_batch"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, u64p, u64p, u64p, ctypes.c_size_t]
    lib.st_inv_batch.argtypes = [ctypes.c_void_p, u64p, u64p, ctypes.c_size_t]
    lib.st_msm.restype = ctypes.c_int
    lib.st_msm.argtypes = [
        ctypes.c_void_p, u64p, u64p, u8p, u64p, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, u64p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    _load()
    return _lib_error


# ------------------------------------------------------------- conversions

def ints_to_u64(values, n_expected=None) -> np.ndarray:
    """int list -> (n, 4) uint64 little-endian limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u8").reshape(-1, 4)
    return np.ascontiguousarray(arr)


def u64_to_ints(arr: np.ndarray) -> list[int]:
    arr = np.ascontiguousarray(arr, dtype="<u8").reshape(-1, 4)
    return [int.from_bytes(row.tobytes(), "little") for row in arr]


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class NativeField:
    """Batch modular arithmetic over a 256-bit prime (standard form I/O)."""

    def __init__(self, p: int, b: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_lib_error}")
        self._lib = lib
        self.p = p
        self._ctx = ctypes.create_string_buffer(lib.st_ctx_size())
        p_arr = ints_to_u64([p])
        b_arr = ints_to_u64([b % p])
        lib.st_init_ctx(self._ctx, _ptr(p_arr), _ptr(b_arr))

    def _binop(self, fn, a, b):
        a_arr, b_arr = ints_to_u64(a), ints_to_u64(b)
        out = np.empty_like(a_arr)
        fn(self._ctx, _ptr(a_arr), _ptr(b_arr), _ptr(out), len(a_arr))
        return u64_to_ints(out)

    def mul(self, a, b):
        return self._binop(self._lib.st_mul_batch, a, b)

    def add(self, a, b):
        return self._binop(self._lib.st_add_batch, a, b)

    def sub(self, a, b):
        return self._binop(self._lib.st_sub_batch, a, b)

    def inv_batch(self, a):
        a_arr = ints_to_u64(a)
        out = np.empty_like(a_arr)
        self._lib.st_inv_batch(self._ctx, _ptr(a_arr), _ptr(out), len(a_arr))
        return u64_to_ints(out)

    def msm(self, xs, ys, infs, scalars, cbits: int = 0, threads: int = 0):
        """Multi-threaded Pippenger MSM; returns (x, y, is_infinity)."""
        n = len(scalars)
        assert len(xs) == len(ys) == n
        if n == 0:
            return 0, 0, True
        if threads <= 0:
            threads = min(os.cpu_count() or 1, 16)
        xs_arr, ys_arr = ints_to_u64(xs), ints_to_u64(ys)
        sc_arr = ints_to_u64([s % (1 << 256) for s in scalars])
        inf_arr = np.asarray(infs, dtype=np.uint8) if infs is not None else None
        inf_ptr = (
            inf_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if inf_arr is not None
            else None
        )
        out = np.zeros((8,), dtype="<u8")
        is_inf = self._lib.st_msm(
            self._ctx, _ptr(xs_arr), _ptr(ys_arr), inf_ptr, _ptr(sc_arr),
            n, cbits, threads, _ptr(out),
        )
        x, y = u64_to_ints(out.reshape(2, 4))
        return x, y, bool(is_inf)


_FIELD_CACHE: dict[tuple[int, int], NativeField] = {}


def get_field(p: int, b: int = 0) -> NativeField:
    key = (p, b)
    if key not in _FIELD_CACHE:
        _FIELD_CACHE[key] = NativeField(p, b)
    return _FIELD_CACHE[key]


# ------------------------------------------------------------- witness tape

_TAPE_SRC = Path(__file__).with_name("witness_tape.cpp")
_tape_lib = None
_tape_error: str | None = None


def _load_tape():
    global _tape_lib, _tape_error
    if _tape_lib is not None or _tape_error is not None:
        return _tape_lib
    if os.environ.get("SIRIUS_TPU_NATIVE", "1") == "0":
        _tape_error = "disabled via SIRIUS_TPU_NATIVE=0"
        return None
    try:
        lib = _build_lib(_TAPE_SRC)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.sirius_tape_replay.restype = ctypes.c_int
        lib.sirius_tape_replay.argtypes = [
            u8p, u32p, u32p, u32p, ctypes.c_int64, ctypes.c_int64,
            u8p, u8p, u8p, ctypes.c_int64, u32p, ctypes.c_int64, u8p,
        ]
        _tape_lib = lib
    except Exception as exc:
        _tape_error = f"tape build failed: {exc}"
        return None
    return _tape_lib


def tape_available() -> bool:
    return _load_tape() is not None


def tape_load_error() -> str | None:
    _load_tape()
    return _tape_error


def tape_replay_native(finalized, inputs, out_slots: np.ndarray):
    """Run the C++ tape interpreter; None if the library is unavailable.

    `finalized` = (code u8, a u32, b u32, c u32, const int list) from
    `TapeBuilder._finalize()`.
    """
    lib = _load_tape()
    if lib is None:
        return None
    code, a, b, c, consts = finalized
    n_ops = len(code)
    inp_buf = b"".join(int(v).to_bytes(32, "little") for v in inputs)
    mag_buf = b"".join(abs(int(v)).to_bytes(128, "little") for v in consts)
    neg_buf = bytes(1 if v < 0 else 0 for v in consts)
    inp_arr = np.frombuffer(inp_buf, dtype=np.uint8) if inp_buf else np.zeros(1, np.uint8)
    mag_arr = np.frombuffer(mag_buf, dtype=np.uint8) if mag_buf else np.zeros(1, np.uint8)
    neg_arr = np.frombuffer(neg_buf, dtype=np.uint8) if neg_buf else np.zeros(1, np.uint8)
    out_slots = np.ascontiguousarray(out_slots, dtype=np.uint32)
    out = np.zeros((len(out_slots), 32), dtype=np.uint8)

    def p8(x):
        return x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def p32(x):
        return x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))

    rc = lib.sirius_tape_replay(
        p8(code), p32(a), p32(b), p32(c),
        n_ops, len(inputs),
        p8(inp_arr), p8(mag_arr), p8(neg_arr), len(consts),
        p32(out_slots), len(out_slots), p8(out),
    )
    if rc != 0:
        raise RuntimeError(f"native tape replay failed with code {rc}")
    return out


def native_msm(curve, points, scalars, cbits: int = 0, threads: int = 0):
    """MSM over `fields.gold.AffinePoint`s on a CurveSpec; returns AffinePoint.

    Host-side analogue of the reference's `best_multiexp` (halo2curves,
    used from src/commitment.rs); Pippenger with one thread per window.
    """
    from ..fields import gold

    p = curve.base.modulus
    f = get_field(p, curve.b)
    xs = [0 if pt.is_identity else pt.x % p for pt in points]
    ys = [0 if pt.is_identity else pt.y % p for pt in points]
    infs = [1 if pt.is_identity else 0 for pt in points]
    x, y, is_inf = f.msm(xs, ys, infs, scalars, cbits=cbits, threads=threads)
    if is_inf:
        return gold.identity(curve)
    return gold.AffinePoint(curve, x, y)
