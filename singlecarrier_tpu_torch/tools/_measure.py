"""What the tools, ``chip_smoke.py`` and ``kernel_ab`` share: the card's
published peaks and each kernel's bound, CUDA-event timers, the card's
name and power limit, and the kernels' seeded operands.

Nothing here runs at import: no card is needed to import the module.
"""

from __future__ import annotations

import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.fused_rx import _advances

SEED = 1234
C_CMP, B_CMP = 256, 4          # kernel-vs-plain comparison geometry
C_MAIN = 8192                  # channels of a full dispatch
B_KTIME = 4                    # per-kernel timing: C_MAIN x B_KTIME rows

# name -> (source, file:line of the Pallas body it replaces, note)
KERNELS = {
    "frontend_decim": (
        "singlecarrier_tpu_torch/csrc/frontend.cu",
        "singlecarrier_tpu/ops/fused_rx.py:155",
        "front-end stage of kernel #1 fused_rx_block"),
    "frontend_rows": (
        "singlecarrier_tpu_torch/csrc/frontend.cu",
        "singlecarrier_tpu/ops/frontend_pallas.py:200",
        "kernel #3 fused_frontend_decim (_kernel_decim_aligned :200 and "
        "_kernel_decim :149)"),
    "hunt": (
        "singlecarrier_tpu_torch/csrc/hunt.cu",
        "singlecarrier_tpu/ops/decode_pallas.py:705",
        "hunt of _hunt_decode_core, inlined in kernel #1 and in kernel #5 "
        "fused_hunt_decode_decim (_hunt_decode_decim_kernel "
        "decode_pallas.py:933), whose launcher runs hunt + extract_decode"),
    "extract_decode": (
        "singlecarrier_tpu_torch/csrc/decode.cu",
        "singlecarrier_tpu/ops/decode_pallas.py:398",
        "extraction + _decode_core, inlined in kernel #1 and in kernel #5 "
        "fused_hunt_decode_decim (decode_pallas.py:933)"),
    "decode_extract": (
        "singlecarrier_tpu_torch/csrc/decode.cu",
        "singlecarrier_tpu/ops/decode_pallas.py:1140",
        "kernel #6 fused_decode_extract"),
    "decode_packets": (
        "singlecarrier_tpu_torch/csrc/decode.cu",
        "singlecarrier_tpu/ops/decode_pallas.py:370",
        "kernel #7 fused_decode"),
    "frontend_decim_folded": (
        "singlecarrier_tpu_torch/csrc/frontend.cu",
        "singlecarrier_tpu/ops/fused_rx.py:217",
        "front-end stage of kernel #2 fused_rx_block with mixer_fold "
        "(_fused_rx_kernel_folded), followed by hunt + extract_decode"),
    "frontend_rows_folded": (
        "singlecarrier_tpu_torch/csrc/frontend.cu",
        "singlecarrier_tpu/ops/frontend_pallas.py:286",
        "kernel #4 fused_frontend_decim with mixer_fold "
        "(_kernel_decim_folded)"),
    "extract_gate": (
        "singlecarrier_tpu_torch/csrc/decode.cu",
        "singlecarrier_tpu/ops/decode_pallas.py:417",
        "stage='gate' of kernels #1, #2 and #5: extraction + energy gate, "
        "the decode tail not executed"),
    "frontend_full": (
        "singlecarrier_tpu_torch/csrc/frontend.cu",
        "singlecarrier_tpu/ops/frontend_pallas.py:45",
        "kernel #8 fused_frontend"),
}

_DECODES = ("extract_decode", "decode_extract", "decode_packets")
# The seven configuration values of the JAX kernels that the CUDA kernels
# take as template parameters, each with the kernels whose code it changes.
KNOB_VALUES = (
    ("hunt_norm", "energy", ("hunt",)),
    ("hunt_norm", "none", ("hunt",)),
    ("hunt_dtype", "f32", ("hunt",)),
    ("ls_gram", "direct", _DECODES),
    ("ls_bvec", "matmul", _DECODES),
    ("cfo_dtype", "bf16", _DECODES),
    ("frontend_dtype", "f32", ("frontend_decim", "frontend_rows",
                               "frontend_decim_folded",
                               "frontend_rows_folded")),
)

# A decision of the decode kernel may differ from its plain version's
# only on a knife edge: a symbol whose plain soft value lies within this
# fraction of its magnitude of the slicer's boundary.  The kernel's f32
# sums run in another order than the plain version's (lane-strided,
# then a butterfly), which moves a soft symbol by some 1e-7 of itself;
# ``python3 -m singlecarrier_tpu_torch.kernel_ab --knife-edges N``
# counts the symbols that differ on N draws of phase 3's inputs and
# prints their margins.
KNIFE_EDGE = 1e-5


class PhaseError(RuntimeError):
    """A check of a measured run failed."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---- the card ----

class Card(NamedTuple):
    name: str
    power_limit: str
    sms: int

    @property
    def line(self) -> str:
        """As ``nvidia-smi --query-gpu=name,power.limit --format=csv,
        noheader`` prints it."""
        return f"{self.name}, {self.power_limit}"


def card(device=None) -> Card:
    """The card's name, power limit (``nvidia-smi``) and SM count; raises
    without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"card(): {dev} is not a CUDA device")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    if ", " in out:
        name, limit = out.splitlines()[0].rsplit(", ", 1)
        return Card(name, limit, sms)
    return Card(torch.cuda.get_device_name(dev), "power limit unread", sms)


def tool_device(device, tool: str, timing: bool) -> torch.device:
    """A tool's device: ``device.resolve_device`` (the card unless the
    caller names another; raises without one).  A timing tool refuses
    anything but the card: a time it prints is the card's."""
    if timing and device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"{tool} refuses --device {device}: the times it "
                         f"prints are the card's")
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the plain paths' f32 matmuls must not run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def head(dev) -> dict:
    """The record's device fields: the card's name and power limit, or
    ``"device": "cpu"`` and no card."""
    if dev.type != "cuda":
        return {"device": "cpu", "card": None}
    c = card(dev)
    return {"device": "gpu", "card": c.line, "card_name": c.name,
            "power_limit": c.power_limit, "sms": c.sms,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def card_line(dev) -> str:
    return card(dev).line if dev.type == "cuda" else "cpu run, no card"


# ---- peaks and bounds ----

# Published peaks of one H100 SXM (dense): bytes/s of device memory and
# operations/s by operand type (int8 and bf16 on the tensor cores, f32 on
# the CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def bound(nbytes: float, ops_: dict):
    """(least ms the card could take, what binds): the larger of bytes
    over the memory rate and operations over the peak of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops_.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ops(*terms) -> dict:
    """{operand type: operations} summed over (type, count) terms."""
    out = {}
    for kind, n in terms:
        out[kind] = out.get(kind, 0) + n
    return out


def kernel_bounds(cfg, N: int, C: int) -> dict:
    """Bounds of every kernel for N rows of C channels at ``cfg``: each
    input read once, each output written once; operations counted from
    the shapes (multiply-add = 2), at the rate of the operand type the
    config gives them (the knobs: front-end, hunt and CFO DFT operands;
    the hunt's energy sums; the Gram)."""
    n, cyc, n_sym = cfg.frame_size, cfg.cycles, cfg.symbols_per_block
    halo, P, D = cfg.ntaps - 1, cfg.preamble_length, cfg.frame_symbols
    L, pkt = cfg.eq_length, cfg.pkt_window
    R = cfg.ls_refit_symbols or D
    plane_b = 2 if cfg.decim_dtype == "bf16" else 4
    planes = cyc * 2 * n_sym                       # values per row
    out_row = 4 * (D + 8)
    fir = ops((cfg.frontend_dtype, N * 2 * n * cfg.ntaps * 2),  # f32 sums
              ("f32", N * n * 14))                 # scale + complex downmix
    energy = {"espan": 2 * planes * 2 + n_sym * P,          # squares, sums
              "energy": 2 * planes * 2 + cyc * n_sym * P,
              "none": 0}[cfg.hunt_norm]
    hunt_ops = ops((cfg.hunt_dtype, N * cyc * 2 * n_sym * P * 2),
                   ("f32", N * (energy + cyc * n_sym
                                * (4 * cfg.corr_segments + 2))))
    gram = L * (L + 1) // 2 if cfg.ls_gram == "direct" else L
    decode_ops = ops(
        (cfg.cfo_dtype, N * P * cfg.cfo_nfft * 4 * 2),        # CFO DFT
        ("f32", N * (
            cfg.cfo_nfft * 3                                  # power
            + pkt * 8 + 2 * P * 2                             # derotate, gate
            + (P + R) * (gram * 8 + L * 8)                    # Gram, b-vec
            + (P * 2 + R + D) * L * 8                         # apply x4
            + (1 + cfg.phase_refine_iters) * D * 40)))        # refine passes
    k1_bytes = N * n * 2 + C * (2 + 2 * halo) * 4 + N * planes * plane_b
    rows_in = N * n * 2 + N * (2 + 2 * halo) * 4
    return {
        # the fold does the same multiply-adds (two sums over one plane)
        # and moves the mixer's products behind them: K1's bytes and
        # operations
        "frontend_decim": bound(k1_bytes, fir),
        "frontend_decim_folded": bound(k1_bytes, fir),
        "frontend_rows": bound(rows_in + N * planes * plane_b, fir),
        "frontend_rows_folded": bound(rows_in + N * planes * plane_b, fir),
        # all f32: 3.76 KB in and 15 KB out per row, ntaps x 3760
        # multiply-adds outside the tensor cores and 9 operations a
        # sample for the scale (1), p * table (6) and x * (.) (2)
        "frontend_full": bound(
            rows_in + N * 2 * n * 4,
            {"f32": N * (2 * n * cfg.ntaps * 2 + n * 9)}),
        # the 128 preamble chips a row's energy needs of its two planes,
        # its lag, phase and peak, one packed row out
        "extract_gate": bound(
            N * 2 * P * plane_b + N * 12 + N * out_row,
            {"f32": N * (2 * P * 2)}),
        # every row's planes once: whole as the previous block of row
        # n + C, and of the last C rows (previous to none) only the
        # P - 1 values a correlation at lag < n_sym reaches into them
        "hunt": bound((N * planes + C * cyc * 2 * (P - 1)) * plane_b
                      + N * 12, hunt_ops),
        "extract_decode": bound(
            (N + C) * planes * plane_b + N * 12 + N * out_row
            + 2 * P * cfg.cfo_nfft * 4, decode_ops),
        # the packet a row needs of its windows: 2 planes x pkt_window f32
        "decode_extract": bound(
            N * 2 * pkt * 4 + N * 12 + N * out_row
            + 2 * P * cfg.cfo_nfft * 4, decode_ops),
        "decode_packets": bound(
            N * 2 * pkt * 4 + N * 4 + N * out_row
            + 2 * P * cfg.cfo_nfft * 4, decode_ops),
    }


def fp32_floor(cfg, name: str, rows: int, mhz: float, sms: int):
    """(the least ms a front-end's 2 x frame_size x ntaps multiply-adds a
    row take for ``rows`` rows at ``mhz`` on ``sms`` SMs of 128 FP32
    lanes, what it counts): one FFMA a multiply-add, or for
    ``frontend_full``, whose f32 products are not exact, an FMUL and an
    FADD."""
    per = 2 if name.startswith("frontend_full") else 1
    ms = (rows * 2 * cfg.frame_size * cfg.ntaps * per
          / (sms * 128 * mhz * 1e6) * 1e3)
    return ms, ("FMUL + FADD floor" if per == 2 else "FFMA floor")


# ---- timers ----

def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def slope_cuda(fn, k1: int = 2, k2: int = 6) -> float:
    """Milliseconds per call as the slope over two chain lengths of
    CUDA-event-timed calls, ``(T(k2) - T(k1)) / (k2 - k1)``: what is fixed
    per measurement (the first launch's ramp, the events) cancels."""
    fn()                                           # warm-up
    torch.cuda.synchronize()
    t1 = time_cuda(fn, k1, warmup=0) * k1
    t2 = time_cuda(fn, k2, warmup=0) * k2
    return (t2 - t1) / (k2 - k1)


def sm_clock_under(fn, launches: int = 40) -> float:
    """The SM clock in MHz that ``nvidia-smi`` reads while ``launches``
    calls of ``fn`` are queued on the card."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    torch.cuda.synchronize()
    return float(out.split()[0])


def wall(fn) -> float:
    """Wall seconds of ``fn``: its launches and one synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---- operands ----

def bench_point(cfg):
    """The bench operating point at ``cfg``'s numerology: bf16 planes,
    the int8 hunt, ``ls_refit_symbols = min(128, D)``."""
    return cfg.replace(decim_dtype="bf16", hunt_dtype="int8",
                       ls_refit_symbols=min(128, cfg.frame_symbols))


def numerology_tx(cfg, dev, packets: int = 10):
    """[samples] int16 on ``dev``: ``packets`` scrambled packets of seeded
    random payload at ``cfg``'s numerology with the flushed gap, the
    golden stream's make-up at another numerology."""
    from ..modem.tx import tx_stream
    rng = np.random.default_rng(SEED)
    bits = rng.integers(0, 2, (packets, cfg.ns, 2 * cfg.data_symbols),
                        dtype=np.uint8)
    return tx_stream(cfg, bits, flush_gap=True, scramble=True, device=dev)


def golden_stream(tx, C, n_samp, offsets, dev):
    """[C, n_samp] int16: ``tx`` delayed by ``offsets[ch]``, zero elsewhere."""
    stream = torch.zeros((C, n_samp), dtype=torch.int16, device=dev)
    idx = torch.arange(tx.numel(), device=dev)[None] + offsets[:, None]
    stream.scatter_(1, idx, tx[None].expand(C, -1).contiguous())
    return stream


def frames(stream, B, n):
    """[C, B*n] stream -> [B, C, n] contiguous frames."""
    C = stream.shape[0]
    return stream[:, :B * n].reshape(C, B, n).permute(1, 0, 2).contiguous()


def kernel_inputs(gen, tx, cfg, C, B, dev):
    """Kernel operands for [B, C] rows: golden packets at random delays
    and positions with AWGN of 0..4500 (every 8th channel full-scale
    noise only), a random carried state."""
    n = cfg.frame_size
    off = torch.randint(0, 4 * n, (C,), generator=gen, device=dev)
    stream = golden_stream(tx, C, B * n + 4 * n + tx.numel(), off, dev)
    start = torch.randint(0, tx.numel(), (C,), generator=gen, device=dev)
    idx = start[:, None] + torch.arange(B * n, device=dev)[None]
    sig = torch.gather(stream, 1, idx).float()
    sigma = (torch.arange(C, device=dev) % 4).float()[:, None] * 1500.0
    noise = torch.randn((C, B * n), generator=gen, device=dev) * sigma
    x = (sig + noise).clamp(-32768, 32767).to(torch.int16)
    pure = torch.randint(-16384, 16384, (C, B * n), generator=gen,
                         device=dev, dtype=torch.int16)
    x = torch.where((torch.arange(C, device=dev) % 8 == 7)[:, None], pure, x)
    ph = torch.rand((C,), generator=gen, device=dev) * (2 * np.pi)
    halo = cfg.ntaps - 1
    t0r = torch.randn((C, halo), generator=gen, device=dev) * 0.1
    t0i = torch.randn((C, halo), generator=gen, device=dev) * 0.1
    adv = _advances(cfg, B, dev)[1]
    ddt = torch.bfloat16 if cfg.decim_dtype == "bf16" else torch.float32
    dprev0 = (torch.randn((cfg.cycles, 2, C, cfg.symbols_per_block),
                          generator=gen, device=dev) * 0.5).to(ddt)
    return (frames(x, B, n), torch.cos(ph), torch.sin(ph), t0r, t0i, adv,
            dprev0)


def row_inputs(cfg, pcm, p0r, p0i, t0r, t0i, adv):
    """The per-row operands ``prod_rx_batch`` derives for the per-row
    front-end: phases p0 * adv^b and the downmixed tail of the previous
    raw block (the carried tail for block 0)."""
    from ..dsp.mixer import downmix_tail
    B, C, n = pcm.shape
    halo = cfg.ntaps - 1
    ar, ai = adv[0][:, None], adv[1][:, None]
    ph_r = p0r[None] * ar - p0i[None] * ai
    ph_i = p0r[None] * ai + p0i[None] * ar
    x_t = pcm[:, :, n - halo:].float() * (1.0 / cfg.tx_amplitude)
    tl_r, tl_i = downmix_tail(cfg.center, cfg.fs, n, halo, x_t,
                              ph_r[..., None], ph_i[..., None])
    N = B * C
    return (pcm.reshape(N, n), ph_r.reshape(N), ph_i.reshape(N),
            torch.cat([t0r[None], tl_r[:-1]]).reshape(N, halo),
            torch.cat([t0i[None], tl_i[:-1]]).reshape(N, halo))


def hunt_windows(cfg, drow, C):
    """Padded hunt windows [N, cyc, 2, 768] of row-major planes
    ``drow`` [N, cyc, 2, n_sym] (row n's previous block is row n - C;
    zeros before block 0), the plain hunt's (lag, phase, peak), and the
    packet planes [N, pkt_window] (real, imaginary) at that lag and
    phase."""
    from ..modem.rx_production import _extract_packet_planes, _hunt_planes
    off = cfg.eq_length // 2
    n_sym = drow.shape[-1]
    prev = torch.cat([torch.zeros_like(drow[:C]), drow[:-C]])
    wp = -(-max(n_sym - 1 + cfg.pkt_window, off + 2 * n_sym) // 128) * 128
    wins = torch.nn.functional.pad(torch.cat([prev, drow], -1),
                                   (off, wp - off - 2 * n_sym))
    lag, ph, peak = _hunt_planes(cfg, wins, col_offset=off)
    pkt = _extract_packet_planes(
        cfg, wins[..., off:off + 2 * n_sym].contiguous(), lag, ph)
    return (wins.contiguous(), lag, ph, peak, pkt[:, 0].contiguous(),
            pkt[:, 1].contiguous())


def kernel_calls(cfg, inputs, C: int) -> dict:
    """{kernel: (kernel call, plain call)} of the ten kernels on the
    operands of ``inputs`` ([B, C] rows, as ``kernel_inputs`` makes them) at
    ``cfg``: the calls the timing runs."""
    from ..ops.decode import (
        extract_decode, extract_decode_ref, extract_gate, extract_gate_ref,
        fused_decode, fused_decode_extract, fused_decode_extract_ref,
        fused_decode_ref, hunt, hunt_ref)
    from ..ops.frontend import (
        frontend_decim, frontend_decim_folded_ref, frontend_decim_ref,
        frontend_full, frontend_full_ref, frontend_rows,
        frontend_rows_folded_ref, frontend_rows_ref)
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = inputs
    dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    lk, pk_, qk = hunt(cfg, dk, dprev0)
    rows = row_inputs(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    wins, wl, wph, wpk, pkt_r, pkt_i = hunt_windows(
        cfg, frontend_rows(cfg, *rows), C)
    return {
        "frontend_decim": (
            lambda: frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv),
            lambda: frontend_decim_ref(cfg, pcm, p0r, p0i, t0r, t0i, adv)),
        "frontend_rows": (
            lambda: frontend_rows(cfg, *rows, transposed=True),
            lambda: frontend_rows_ref(cfg, *rows, transposed=True)),
        "hunt": (lambda: hunt(cfg, dk, dprev0),
                 lambda: hunt_ref(cfg, dk, dprev0)),
        "extract_decode": (
            lambda: extract_decode(cfg, dk, dprev0, lk, pk_, qk),
            lambda: extract_decode_ref(cfg, dk, dprev0, lk, pk_, qk)),
        "decode_extract": (
            lambda: fused_decode_extract(cfg, wins, wl, wph, wpk),
            lambda: fused_decode_extract_ref(cfg, wins, wl, wph, wpk)),
        "decode_packets": (
            lambda: fused_decode(cfg, pkt_r, pkt_i, wpk),
            lambda: fused_decode_ref(cfg, pkt_r, pkt_i, wpk)),
        "frontend_decim_folded": (
            lambda: frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv,
                                   mixer_fold=True),
            lambda: frontend_decim_folded_ref(cfg, pcm, p0r, p0i, t0r, t0i,
                                              adv)),
        "frontend_rows_folded": (
            lambda: frontend_rows(cfg, *rows, transposed=True,
                                  mixer_fold=True),
            lambda: frontend_rows_folded_ref(cfg, *rows, transposed=True)),
        "extract_gate": (
            lambda: extract_gate(cfg, dk, dprev0, lk, pk_, qk),
            lambda: extract_gate_ref(cfg, dk, dprev0, lk, pk_, qk)),
        "frontend_full": (lambda: frontend_full(cfg, *rows),
                          lambda: frontend_full_ref(cfg, *rows)),
    }
