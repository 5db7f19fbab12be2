"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into objects,
linked into one shared library with a plain C interface under
``build/torch_kernels/`` of the checkout, at first use, and loaded with
``ctypes``.  The kernels compile the modem's shapes in:
:func:`kernel_geometry` gives a config's shapes as ``-D`` defines (none
at the reference numerology, whose library is the default one),
:func:`load` builds and keeps one library per geometry, and
:func:`kernel_limits` states, in one place, the numerologies the kernels
are written for.  Each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; :func:`check` raises on anything but
0.

The objects are shared across geometries.  Each source is compiled once
per distinct preprocessed text (``nvcc -E`` under the geometry's
defines), keyed by a hash of that text, :data:`NVCC_FLAGS` and the nvcc
version, into ``build/torch_kernels/obj/`` with its ``ptxas -v`` log
beside it (one ``nvcc`` per source, the three started together); a
geometry's library is a link of its three objects.  A source reads only
the shapes it compiles in (``csrc/common.cuh``), so a geometry that
changes only the DFT's size reuses the reference's front-end and hunt
objects, one that changes only the equalizer or the segments its
front-end.  :data:`OBJECTS` counts the objects compiled and reused.
``rm -rf build/torch_kernels`` clears every library and object.

``-fmad=false`` keeps nvcc from contracting ``a*b - c*d`` into fused
multiply-adds: every product and sum is rounded where the plain PyTorch
version (and the JAX package) rounds it.  That is what makes the
front-end's bf16 downmix and the recomputed FIR halo bit-identical to
theirs.

``build(csrc=..., defines=...)`` compiles another source tree (a parent
commit's ``csrc`` unpacked beside the checkout) or a variant
(``SC_STAGE_CLOCKS``: the decode kernels' per-stage clocks) into a
library of its own name; :func:`bind` loads one and :func:`using` puts
it in the wrappers' hands for a ``with`` block.  ``kernel_ab.py`` uses
them to hold two builds against each other on the card.

Module state: the library handles (the reference geometry's, and the
others' by their defines), a lock per library and per object (threads
that build or load one geometry at once wait for one build),
:data:`LAUNCHES`, the per-kernel launch counters (each wrapper adds one
where it launches its kernel), :data:`OBJECTS`, and
:data:`COMPILE_LISTENERS`, called with a line for each library built and
each geometry's first load (``runtime.log_compiles``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..config import DEFAULT_CONFIG

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("frontend.cu", "hunt.cu", "decode.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

LAUNCHES = {"frontend_decim": 0, "frontend_rows": 0, "hunt": 0,
            "extract_decode": 0, "decode_extract": 0, "decode_packets": 0,
            "frontend_decim_folded": 0, "frontend_rows_folded": 0,
            "extract_gate": 0, "frontend_full": 0}

COMPILE_LISTENERS = []   # callables taking one line per build or first load
OBJECTS = {"compiled": 0, "reused": 0}   # the objects of the libraries built

_lib = None          # the reference geometry's library
_libs = {}           # every other geometry's, by its defines
_locks = {}          # a lock per library path and per loaded geometry
_locks_guard = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # pcm, p0r, p0i, tail0_r, tail0_i, adv, tab, taps, out,
    # B, C, out_bf16, inv_scale, f32_operands, stream
    "sc_frontend_decim": [_P] * 9 + [_I] * 3 + [_F, _I, _P],
    # decim, dprev0, pn, lag, phase, peak, N, C, in_bf16, int8_hunt,
    # hunt_scale, peak_scale, f32_operand, norm, stream
    "sc_hunt": [_P] * 6 + [_I] * 4 + [_F] * 2 + [_I] * 2 + [_P],
    # decim, dprev0, lag, phase, peak, dft_r, dft_i, pn, mask, out,
    # N, C, in_bf16, refit_sym, refit_iters, refine_iters, peak_gate,
    # ls_reg, ls_offtap, ls_offtap_refit, cfo_scale, derot_k, cfo_bf16,
    # gram_direct, bvec_matmul, stream
    "sc_extract_decode": [_P] * 10 + [_I] * 6 + [_F] * 6 + [_I] * 3 + [_P],
    # pcm, ph_r, ph_i, tail_r, tail_i, tab, taps, out, N, layout,
    # inv_scale, f32_operands, stream
    "sc_frontend_rows": [_P] * 8 + [_I] * 2 + [_F, _I, _P],
    # windows, lag, phase, peak, dft_r, dft_i, pn, mask, out, N, wp,
    # refit_sym, refit_iters, refine_iters, then the six floats and the
    # three knobs of sc_extract_decode, stream
    "sc_decode_extract": [_P] * 9 + [_I] * 5 + [_F] * 6 + [_I] * 3 + [_P],
    # pkt_r, pkt_i, peak, dft_r, dft_i, pn, mask, out, N, refit_sym,
    # refit_iters, refine_iters, the six floats, the three knobs, stream
    "sc_decode_packets": [_P] * 8 + [_I] * 4 + [_F] * 6 + [_I] * 3 + [_P],
    # sc_frontend_decim's operands with (ctaps, unrot) for taps
    "sc_frontend_decim_folded": [_P] * 10 + [_I] * 3 + [_F, _I, _P],
    # sc_frontend_rows's operands with (ctaps, unrot) for taps
    "sc_frontend_rows_folded": [_P] * 9 + [_I] * 2 + [_F, _I, _P],
    # pcm, ph_r, ph_i, tail_r, tail_i, tab, taps, out, N, inv_scale,
    # gain, stream
    "sc_frontend_full": [_P] * 8 + [_I] + [_F] * 2 + [_P],
    # decim, dprev0, lag, phase, peak, out, N, C, in_bf16, peak_gate,
    # stream
    "sc_extract_gate": [_P] * 6 + [_I] * 3 + [_F, _P],
    # host_out (8 x uint64), reset, stream
    "sc_decode_stage_cycles": [_P, _I, _P],
    # out (int32 x 5, 3 and 3): each source's layout at its geometry
    "sc_frontend_layout": [_P],
    "sc_hunt_layout": [_P],
    "sc_decode_layout": [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _notify(event: str) -> None:
    for listener in list(COMPILE_LISTENERS):
        listener(event)


def _lock(key) -> threading.Lock:
    """The one lock of ``key`` (made on first use)."""
    with _locks_guard:
        return _locks.setdefault(key, threading.Lock())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(csrc: Path, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(p.name for p in csrc.iterdir()):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False, *, csrc: Path = CSRC,
          defines: tuple = ()) -> tuple[Path, str]:
    """Link the kernels if the library for these sources is missing.

    Returns ``(library path, compiler output)``; ``verbose`` returns the
    ``-Xptxas -v`` lines (registers, shared memory and spills per kernel)
    of its objects, kept beside the library, else "".  ``csrc`` is the
    source tree (this package's by default), ``defines`` preprocessor
    names to set; each combination has its own library.
    """
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    lib_path = BUILD_DIR / f"libsc_kernels_{_digest(Path(csrc), flags)}.so"
    kept = _kept(lib_path, verbose)
    if kept is not None:
        return lib_path, kept
    with _lock(lib_path):               # one build of a library at a time
        kept = _kept(lib_path, verbose)
        if kept is not None:
            return lib_path, kept
        log = _compile(lib_path, csrc, flags)
    _notify(f"built {lib_path.name} (defines {list(defines)})")
    return lib_path, log if verbose else ""


def _kept(lib_path: Path, verbose: bool):
    """A built library's answer to :func:`build` ("", or its kept log where
    ``verbose``), or None where it must be linked."""
    log = lib_path.with_suffix(".log")
    if lib_path.exists() and not verbose:
        return ""
    if lib_path.exists() and log.exists():
        return log.read_text()
    return None


@functools.lru_cache(maxsize=4)
def _nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True).stdout


def _object(nvcc: str, src: Path, flags) -> tuple[Path, str]:
    """The object of ``src`` under ``flags``, compiled unless one of the
    same preprocessed text is kept; returns (its path, its compiler
    output, the ``ptxas -v`` lines included)."""
    pre = subprocess.run([nvcc, *flags, "-E", str(src)],
                         capture_output=True, text=True)
    if pre.returncode != 0:
        raise RuntimeError(f"nvcc -E failed on {src.name} "
                           f"({pre.returncode}):\n{pre.stderr}")
    key = hashlib.sha256("\0".join(
        [" ".join(NVCC_FLAGS), _nvcc_version(nvcc), src.name, pre.stdout])
        .encode()).hexdigest()[:16]
    obj = BUILD_DIR / "obj" / f"{src.stem}_{key}.o"
    log = obj.with_suffix(".log")
    with _lock(obj):                    # one build of an object at a time
        reused = obj.exists() and log.exists()
        if not reused:
            obj.parent.mkdir(parents=True, exist_ok=True)
            tag = f"{os.getpid()}.{threading.get_ident()}"
            tmp = obj.with_name(f"{obj.stem}.{tag}.o")
            res = subprocess.run(
                [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(tmp),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({res.returncode}):\n{res.stdout}")
            tmp_log = log.with_name(f"{log.stem}.{tag}.log")
            tmp_log.write_text(res.stdout)
            os.replace(tmp_log, log)    # the log first: a kept object has one
            os.replace(tmp, obj)
    with _locks_guard:
        OBJECTS["reused" if reused else "compiled"] += 1
    return obj, log.read_text()


def _compile(lib_path: Path, csrc, flags) -> str:
    """Link ``lib_path`` from the sources' objects (each compiled unless
    kept); keep their logs beside it and return them.  The temporary files
    are named by process and thread."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(
            lambda src: _object(nvcc, Path(csrc) / src, flags), SOURCES))
    tag = f"{lib_path.stem}.{os.getpid()}.{threading.get_ident()}"
    tmp = BUILD_DIR / f"{tag}.tmp"
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *(str(obj) for obj, _ in built)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    log = "".join(text for _, text in built) + res.stdout + res.stderr
    tmp_log = BUILD_DIR / f"{tag}.log"
    tmp_log.write_text(log)
    os.replace(tmp_log, lib_path.with_suffix(".log"))
    os.replace(tmp, lib_path)
    return log


# the entry functions of the ten kernels (the hunt in two bodies), as
# their names stand inside ptxas' mangled ones
KERNEL_ENTRIES = ("frontend_decim_kernel", "frontend_rows_kernel",
                  "frontend_decim_folded_kernel",
                  "frontend_rows_folded_kernel", "frontend_full_kernel",
                  "hunt_mma_kernel", "hunt_toeplitz_kernel",
                  "extract_decode_kernel", "decode_extract_kernel",
                  "decode_packets_kernel", "extract_gate_kernel")


def ptxas_entries(log: str) -> dict:
    """{entry function: what ``ptxas -v`` says of its registers, shared
    memory and spills} of a verbose :func:`build` log, in log order.  An
    entry is named by its kernel and the rest of its mangled name (its
    template arguments and parameters), without the anonymous namespace's
    tag, which differs from one source tree to another."""
    out, said = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kern = max((k for k in KERNEL_ENTRIES if k in name), key=len,
                       default="")
            said = out.setdefault(name[name.index(kern):] if kern else name,
                                  [])
        elif said is not None and ("registers" in line or "spill" in line):
            said.append(line.split("ptxas info    :")[-1].strip())
    return out


def bind(path: Path):
    """Load a built library and type its entry points (those it has: an
    older source tree may lack the newest)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load(cfg=None):
    """The bound kernel library for ``cfg``'s geometry (the reference
    one by default), built on first use."""
    global _lib
    defines = kernel_geometry(cfg) if cfg is not None else ()
    lib = _libs.get(defines) if defines else _lib
    if lib is not None:
        return lib
    with _lock(("load", defines)):      # one thread builds, the rest wait
        if not defines:
            if _lib is None:
                _lib = bind(build()[0])
                _notify("loaded the reference geometry's kernels")
            return _lib
        if defines not in _libs:
            _libs[defines] = bind(build(defines=defines)[0])
            _notify(f"loaded the kernels of geometry {list(defines)}")
        return _libs[defines]


@contextlib.contextmanager
def using(lib, cfg=None):
    """Let the wrappers launch from ``lib`` (a :func:`bind` result)
    inside the block, for configs of ``cfg``'s geometry (the reference
    one by default)."""
    global _lib
    defines = kernel_geometry(cfg) if cfg is not None else ()
    mine = load(cfg)
    if defines:
        _libs[defines] = lib
    else:
        _lib = lib
    try:
        yield lib
    finally:
        if defines:
            _libs[defines] = mine
        else:
            _lib = mine


def layout(lib) -> dict:
    """What a built library's kernels hold a block at its geometry: shared
    bytes (dynamic where past 48 KB) of each body, threads a block, blocks
    an SM of the front-ends, whether the decode's LS solve is in shared
    memory."""
    fe, hu, de = ((ctypes.c_int * n)() for n in (5, 3, 3))
    for fn, arr in ((lib.sc_frontend_layout, fe), (lib.sc_hunt_layout, hu),
                    (lib.sc_decode_layout, de)):
        check(fn(arr), fn.__name__)
    return {"premix_smem": fe[0], "folded_smem": fe[1], "full_smem": fe[2],
            "frontend_threads": fe[3], "frontend_blocks_sm": fe[4],
            "hunt_int8_smem": hu[0], "hunt_toeplitz_smem": hu[1],
            "hunt_toeplitz_threads": hu[2], "decode_smem": de[0],
            "decode_rows": de[1], "ls_in_smem": bool(de[2])}


def check(err: int, name: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


# The shapes csrc/common.cuh compiles in, by their -D names, and their
# values at the reference numerology (the defaults there).
_GEOMETRY = (("SC_N_SAMP", "frame_size", 1880), ("SC_CYC", "cycles", 5),
             ("SC_NTAPS", "ntaps", 49), ("SC_P", "preamble_length", 128),
             ("SC_NSEG", "corr_segments", 8),
             ("SC_D", "frame_symbols", 248), ("SC_L", "eq_length", 5),
             ("SC_NFFT", "cfo_nfft", 512), ("SC_PKT", "pkt_window", 384))


# The numerologies the JAX package runs beyond the reference one, each a
# ``DEFAULT_CONFIG.replace(**kw)``, at which the kernels are held to their
# plain versions on the card (chip_smoke.py, kernel_ab.py --config) and
# the port to the JAX package on the CPU (tests/test_torch_numerology*).
NUMEROLOGIES = {
    "alt_9600": {"fs": 9600.0, "rs": 2400.0, "center": 1500.0},
    "tiny_payload": {"data_symbols": 1, "ns": 2},
    "mid_payload": {"data_symbols": 9, "ns": 8},
    "ns4": {"ns": 4},
    "eq7": {"eq_length": 7},
    "seg4": {"corr_segments": 4},
    "seg16": {"corr_segments": 16},
    "nfft1024": {"cfo_nfft": 1024},
    # the widest shapes the JAX CLI reaches (--eq-length, --fs / --rs,
    # --ns), each at or near a limit of kernel_limits
    "eq9": {"eq_length": 9},
    "eq16": {"eq_length": 16},
    "cyc6": {"fs": 9600.0, "rs": 1600.0, "center": 1500.0},
    "cyc10": {"fs": 16000.0, "rs": 1600.0, "center": 1500.0},
    "ns9": {"ns": 9},
    "ns16": {"ns": 16},
    "wide_corner": {"eq_length": 16, "ns": 16, "fs": 16000.0, "rs": 1600.0,
                    "center": 1500.0},
    # the correlator's segmentation, the CFO DFT's size and the RRC length
    # the JAX package's Pallas paths run, none a CLI flag: 1 segment is the
    # reference's coherent correlator
    "seg1": {"corr_segments": 1},
    "seg2": {"corr_segments": 2},
    "nfft128": {"cfo_nfft": 128},
    "nfft4096": {"cfo_nfft": 4096},
    # the CFO DFT's sizes past a warp's lanes and a 1024-bin block: fewer
    # bins than lanes, a size no multiple of 4, and past 1024 bins, where
    # the DFT keeps a running first maximum, up to the limit
    "nfft16": {"cfo_nfft": 16},
    "nfft1001": {"cfo_nfft": 1001},
    "nfft8192": {"cfo_nfft": 8192},
    "nfft32768": {"cfo_nfft": 32768},
    "taps25": {"ntaps": 25},
    "taps45": {"ntaps": 45},
    # the longest equalizers and packets the JAX CLI decodes (--eq-length,
    # --ns): 24 and 32 taps, and 872, 1120 and 1616 symbols a block (the
    # last the limit, the first two either side of the Toeplitz hunt's
    # 1024 threads)
    "eq24": {"eq_length": 24},
    "eq32": {"eq_length": 32},
    "ns24": {"ns": 24},
    "ns32": {"ns": 32},
    "ns48": {"ns": 48},
}


def is_long(cfg) -> bool:
    """Whether ``cfg`` is past 16 equalizer taps or 624 symbols a block,
    where the kernels' limits stood before their branches for longer
    equalizers and packets."""
    return cfg.eq_length > 16 or cfg.symbols_per_block > 624


# the named numerologies that are long
LONG_NUMEROLOGIES = tuple(name for name, kw in NUMEROLOGIES.items()
                          if is_long(DEFAULT_CONFIG.replace(**kw)))


def is_wide(cfg) -> bool:
    """Whether ``cfg`` is past 7 equalizer taps, 5 cycles or 376 symbols a
    block, where the kernels' limits stood before their wide branches."""
    return (cfg.eq_length > 7 or cfg.cycles > 5
            or cfg.symbols_per_block > 376)


# the named numerologies that are wide and not long
WIDE_NUMEROLOGIES = tuple(name for name, kw in NUMEROLOGIES.items()
                          if is_wide(DEFAULT_CONFIG.replace(**kw))
                          and name not in LONG_NUMEROLOGIES)


def is_retuned(cfg) -> bool:
    """Whether ``cfg`` sets the correlator's segments, the CFO DFT's size
    or the RRC's length outside 4-16 segments, 256-1024 bins and 49 taps,
    where the kernels' limits stood before their branches for the rest."""
    return (cfg.corr_segments not in (4, 8, 16)
            or cfg.cfo_nfft not in (256, 512, 1024) or cfg.ntaps != 49)


# the named numerologies that are retuned
RETUNED_NUMEROLOGIES = tuple(name for name, kw in NUMEROLOGIES.items()
                             if is_retuned(DEFAULT_CONFIG.replace(**kw)))


@functools.lru_cache(maxsize=64)
def kernel_geometry(cfg) -> tuple:
    """The ``-D`` defines that compile the kernels for ``cfg``'s shapes:
    none at the reference numerology, else all nine (``SC_N_SAMP=1504``,
    ...); ``csrc/common.cuh`` derives the rest.  Raises as
    :func:`kernel_limits` for a config outside the limits."""
    kernel_limits(cfg)
    got = tuple((name, int(getattr(cfg, field)))
                for name, field, _ in _GEOMETRY)
    if all(v == ref for (_, v), (*_, ref) in zip(got, _GEOMETRY)):
        return ()
    return tuple(f"{name}={v}" for name, v in got)


@functools.lru_cache(maxsize=64)       # a per-block loop calls it often
def kernel_limits(cfg) -> None:
    """Raise ``NotImplementedError`` naming the limit ``cfg`` exceeds;
    return if the kernels are written for its numerology.

    The limits, all of which the reference numerology meets:

      * preamble_length 128: the hunt's tensor-core tile takes the
        preamble as 8 chunks of 16 chips;
      * corr_segments 1, 2, 4, 8 or 16 (segments of 128, 64, 32, 16 or
        8 chips): a segment is half a chunk, a chunk or whole chunks of
        the tile; 32 segments of 4 chips, which the JAX package's own
        detection sweep leaves out, are not written;
      * ntaps odd from 9 to 49: the front-ends' halo of ntaps - 1
        samples is staged in 8-, 4- or 2-sample steps and each task's
        window of WIN_T + ntaps - 1 inputs sits in registers; at 51 taps
        and more the JAX package's Pallas paths themselves fail, and
        below 9 its receiver finds no packet;
      * cycles 2 to 10 and symbols_per_block at most 1616 (ns 48 at 31
        data symbols; so frame_size at most 16,160 and frame_symbols at
        most 1488): the blocks that hold a row's whole window in shared
        memory reach the 227 KB a block may hold there (the int8 hunt's
        four warps 172 KB at 10 cycles, the premix front-end 163 KB;
        the full-rate front-end stores past 12,900 samples from its
        registers, its row buffer no longer fitting beside them).  The
        Toeplitz hunt takes an operand value a thread, N_SYM + P - 1 of
        them, and two past 897 symbols, where one would pass the 1024
        threads a block may have; the front-ends take a task (4, or 2
        above cycles 5 where the cycle count is even, symbols of one
        plane) a thread, and two where that would pass 1024 (2-symbol
        tasks past 1024 symbols).  Past 496 data symbols the decode's
        per-symbol arrays (47 a lane at 1488) sit in local memory;
      * eq_length 1 to 32 (so pkt_window at most 1648): the LS solve
        gives lane i row i of the Cholesky factor, which stops at the
        warp's 32 lanes, and its matmul b-vector takes a lane one of the
        2 * eq_length sums, two past 16 taps; above 7 taps each warp's
        Gram and factor sit in shared memory (8.4 KB a warp at 32);
      * cfo_nfft any integer from 2 to 32768: the table's rows are
        uploaded padded to a multiple of 4 floats, the DFT's bin groups
        and the argmax's lanes may be ragged (lanes past the last bin, at
        fewer than 32, hold none); up to 1024 bins the powers of the
        block's rows sit in the table tiles, past 1024 none is stored:
        each thread keeps a running first maximum, the block reduces it
        per row and the peak's two neighbours are summed again, so no
        region grows with the size (its groups loop, 64 of 512 bins at
        32768).  Past 32768 bins the JAX package's own decode was not
        tried.  A block takes 8 rows, or 4 where 8 would pass 227 KB (the
        longest packets with the widest equalizers).  So every
        combination inside these limits fits; none is refused for shared
        memory.
    """
    limits = (
        ("preamble_length == 128", cfg.preamble_length == 128),
        ("corr_segments in (1, 2, 4, 8, 16)",
         cfg.corr_segments in (1, 2, 4, 8, 16)),
        ("9 <= ntaps <= 49", 9 <= cfg.ntaps <= 49),
        ("2 <= cycles <= 10", 2 <= cfg.cycles <= 10),
        ("symbols_per_block <= 1616", cfg.symbols_per_block <= 1616),
        ("1 <= eq_length <= 32", 1 <= cfg.eq_length <= 32),
        ("2 <= cfo_nfft <= 32768", 2 <= cfg.cfo_nfft <= 32768),
    )
    for name, ok in limits:
        if not ok:
            raise NotImplementedError(
                f"the CUDA kernels' limit {name} does not hold for this "
                f"config (ops/_build.kernel_limits)")


def decode_params(cfg) -> list:
    """The trailing scalar arguments every decode entry point takes
    (``csrc/decode.cu`` ``Params``, then the three knobs that choose the
    kernel's instantiation)."""
    return [cfg.ls_refit_symbols or cfg.frame_symbols, cfg.ls_refit_iters,
            cfg.phase_refine_iters, float(cfg.effective_peak_gate),
            float(cfg.ls_reg), float(cfg.ls_offtap_reg),
            float(cfg.ls_offtap_reg_refit), float(cfg.rs / cfg.cfo_nfft),
            float(np.float32(-2.0 * np.pi / cfg.rs)),
            int(cfg.cfo_dtype == "bf16"), int(cfg.ls_gram == "direct"),
            int(cfg.ls_bvec == "matmul")]


def cuda_args(*tensors, device):
    """Check that every tensor is contiguous on ``device``; return
    their data pointers."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return [t.data_ptr() for t in tensors]
