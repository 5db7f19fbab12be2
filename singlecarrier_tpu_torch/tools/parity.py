"""Decision parity of every kernel path against the XLA path, on the card.

Counterpart of ``tools/tpu_parity.py``::

    python3 -m singlecarrier_tpu_torch.tools.parity [--all-records]
        [--config NAME] [--channels 128] [--packets 6] [--snr-db 12]
        [--freq-hz HZ] [knob overrides] [--device cpu] [--out PATH]

The records' stream (scrambled packets with the flushed gap, each
channel through the port's ``channel`` at ``--snr-db`` and ``--freq-hz``,
cast to int16 as XLA casts) runs through the XLA path ``prod_rx_stream``
(plain PyTorch, the oracle) and every kernel path the config allows: the
two-kernel batch path ``prod_rx_batch`` (``batch_pallas``), the one-kernel
path ``prod_rx_batch(fuse_frontend=True)`` (``fused_rx``), the streaming
path ``prod_rx_stream_pallas`` (``scan_pallas``) and the full-rate
front-end with the XLA back end, ``prod_rx_stream_pallas(fuse_decode=
False)`` (``pallas_fe_xla_decode``); under ``frac_timing`` only the last
two.  Each path is held to the XLA path by the North star's criterion
(identical valid flags, bits on valid blocks, lag and phase; |dcfo| <
0.5 Hz, |deq_error| < 2e-3; under the int8 hunt at most one valid flip
in 1000 blocks, on blocks that are a true packet in neither path) and to
the truth (every packet once, no bit error, no false detect).

Writes ``PARITY_GPU.json`` (``PARITY_TPU.json``'s keys, the card's name
and power limit, the launches of each path); ``--all-records`` runs the
seven pinned configs and writes ``PARITY_GPU.json``, ``_BF16``,
``_WIDE``, ``_FRAC``, ``_INT8``, ``_R128`` and ``_CFO16`` into
``--out-dir``.  ``--config`` also takes a named numerology
(``ops/_build.NUMEROLOGIES``: ``eq16``, ``wide_corner``, ...) at its bench
operating point (at its own CFO or SNR where 15 Hz or 12 dB is out of
its reach, ``NUMEROLOGY_CFO_HZ``, ``NUMEROLOGY_SNR_DB``), written to
``PARITY_GPU_<NAME>.json``, which no
TPU record stands beside.  Exits 1 on any mismatch.  ``--device cpu`` runs the
plain versions (the tests); the record then says ``"device": "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import DEFAULT_CONFIG
from ..ber import assign_detections
from ..channel import channel
from ..device import to_int16
from ..modem import (ProdRxOut, prod_rx_batch, prod_rx_init, prod_rx_stream,
                     prod_rx_stream_pallas)
from ..modem.tx import tx_stream
from ..ops import _build
from ._measure import KNOB_VALUES, SEED, bench_point, head, tool_device

PARITY_C, PARITY_PACKETS = 128, 6        # tools/tpu_parity.py's defaults
PARITY_SNR_DB, PARITY_CFO_HZ = 12.0, 15.0
# The stream's CFO at the numerologies that cannot take 15 Hz.  At 1600
# baud a 128-chip correlator segment spans 80 ms, which 15 Hz turns 1.2
# times round: the coherent sum vanishes (seg1 finds no packet, seg2
# half of them).  A 128-bin DFT of the 128 chips has 12.5 Hz bins and no
# zero padding, so off a bin the parabolic step misses by Hertz (nfft128
# decodes two thirds of the bits wrong at 15 Hz, some at 1 Hz).  4 Hz
# turns a 128-chip segment a third of the way round; 12.5 Hz is a bin.
# A 16-bin DFT's bins are 100 Hz apart, so its parabola cannot place a
# CFO between them (the XLA path decodes 0.4% of the bits wrong at 1 Hz
# on a CPU draw, half at 2 Hz), and at 100 Hz, a bin, a 16-chip
# correlator segment turns once round and no packet is found: its stream
# has no CFO.
NUMEROLOGY_CFO_HZ = {"seg1": 4.0, "seg2": 4.0, "nfft128": 12.5,
                     "nfft16": 0.0}
# The stream's SNR at the numerologies that cannot take 12 dB.  The
# preamble's 128 chips estimate the CFO to about 0.1 Hz at 12 dB, which
# turns the last symbol of an 872- to 1616-symbol packet (0.5 to 1 s) by
# 20 to 40 degrees: the XLA path itself decodes 103 to 45,945 of the
# parity stream's bits wrong there on an H100 (at 0 Hz on a CPU draw as
# well).  On CPU draws at 15 Hz the last bit error at 1616 symbols goes
# at 21 dB; 24 dB leaves 3 dB (tests/test_torch_numerology_long.py).
NUMEROLOGY_SNR_DB = {"ns24": 24.0, "ns32": 24.0, "ns48": 24.0}


class Parts(NamedTuple):
    """How a kernel path may part from the XLA path at a numerology of
    ``JAX_PARTS`` (by default it may not)."""
    noise: frozenset = frozenset()  # noise blocks (channel, block) whose
                                    # valid flag alone may flip: a false
                                    # detect of one path only
    eq_held: bool = True            # |deq_error| < 2e-3 held
    phase_ties: bool = False        # on a block valid in both the timing
                                    # (lag x cycles + phase) may be the
                                    # next sample's (its bits then not
                                    # compared)
    noise_detects: int = 0          # every block that is a true packet
                                    # in neither path is noise: the valid
                                    # flags of at most this many may flip,
                                    # and where one is a false detect its
                                    # bits, cfo, eq_error, lag and phase
                                    # are not compared


# Where the kernel paths part from the XLA path at the bench point just as
# the JAX package's own Pallas and XLA paths part on the same frames
# (tests/test_torch_wide_parity.py), and how they may part there.  At eq16
# noise block 9 of channel 70 crosses the gate in the kernel paths only
# (peak / energy 7.0014 against 6.8544); at ns16, nfft4096 and ns48 a
# packet's eq_error differs by up to 2.5e-3, 3.0e-3 and 3.2e-3, as JAX's
# does (at ns48 a 0.004 Hz CFO gap turns 1488 symbols apart), at
# nfft8192 and nfft32768 by up to 6.6e-3 and 1.0e-2 on a CPU draw (a CFO
# gap of up to 0.1 Hz: bf16 and f32 planes peak apart on bins 0.2 and
# 0.05 Hz wide).  At taps25
# the short filter leaves two neighbouring sample timings (phases, or
# phase cycles - 1 and phase 0 of the next lag) all but tied, and the
# paths may pick either.  At eq24 and eq32 the fit's 24 or 32 taps match
# noise blocks to the preamble now and then, in both packages' paths
# alike (5 and 12 of 1280 blocks of the XLA path on an H100), and the
# bf16 and f32 planes decide such a block, and equalize its noise, apart
# (tests/test_torch_numerology_long.py); as many may flip as were seen to
# (2 of a kernel path's blocks at eq24 on an H100, 3 at eq32 on a CPU
# draw).
JAX_PARTS = {"eq16": Parts(noise=frozenset({(70, 9)})),
             "ns16": Parts(eq_held=False),
             "nfft4096": Parts(eq_held=False),
             "nfft8192": Parts(eq_held=False),
             "nfft32768": Parts(eq_held=False),
             "ns48": Parts(eq_held=False),
             "taps25": Parts(phase_ties=True),
             "eq24": Parts(noise_detects=2),
             "eq32": Parts(noise_detects=3)}


def configs(default):
    """(name, record, config) of the seven pinned ``PARITY_TPU*.json``
    configs, then the library default under each of the six other knob
    values (no record: held to the XLA path and the truth alike)."""
    int8 = default.replace(decim_dtype="bf16", hunt_dtype="int8")
    knobs = [(f"{knob}={value}", None, default.replace(**{knob: value}))
             for knob, value, _ in KNOB_VALUES if knob != "cfo_dtype"]
    return [
        ("default", "PARITY_TPU.json", default),
        ("decim bf16", "PARITY_TPU_BF16.json",
         default.replace(decim_dtype="bf16")),
        ("alpha 0.50", "PARITY_TPU_WIDE.json", default.replace(alpha=0.50)),
        ("frac timing", "PARITY_TPU_FRAC.json",
         default.replace(frac_timing=True)),
        ("hunt int8", "PARITY_TPU_INT8.json", int8),
        ("refit 128", "PARITY_TPU_R128.json",
         int8.replace(ls_refit_symbols=128)),
        ("cfo bf16", "PARITY_TPU_CFO16.json", int8.replace(cfo_dtype="bf16")),
    ] + knobs


def numerology_configs(default):
    """(name, None, config) of each named numerology
    (``ops/_build.NUMEROLOGIES``) at its bench operating point, as
    ``chip_smoke.py`` (j) runs it; no TPU record stands beside them."""
    return [(tag, None, bench_point(default.replace(**kw)))
            for tag, kw in _build.NUMEROLOGIES.items()]


def stream(cfg, bits, seed: int, dev, snr_db: float = PARITY_SNR_DB,
           freq_hz: float = PARITY_CFO_HZ):
    """The records' stream: scrambled packets with the flushed gap, each
    channel through ``channel`` at ``snr_db`` and ``freq_hz`` (its own
    signal power, as the records' per-channel ``vmap`` measures it),
    cast to int16 as XLA casts.  Returns frames [B, C, frame_size]."""
    n = cfg.frame_size
    pcm = tx_stream(cfg, bits, flush_gap=True, scramble=True, device=dev)
    n_blocks = -(-pcm.shape[-1] // n) + 1
    x = torch.zeros((pcm.shape[0], n_blocks * n), device=dev)
    x[:, :pcm.shape[-1]] = pcm.float()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.stack([channel(gen, row, snr_db=snr_db, freq_hz=freq_hz,
                             fs=cfg.fs, device=dev) for row in x])
    return to_int16(x).reshape(-1, n_blocks, n).transpose(0, 1).contiguous()


def truth(cfg, out, ref):
    """Bit errors, bits counted, false detects, the set of (channel,
    block) true-packet detections and {(channel, block): bit errors} of
    those with a bit error, of [C, B] numpy outputs against the sent
    payloads ``ref`` [C, packets, bits], matched by stream position
    (``ber.assign_detections``, the records' semantics)."""
    err = total = false = 0
    hits, wrong = set(), {}
    for c in range(out.valid.shape[0]):
        assigned, f = assign_detections(cfg, out.valid[c], out.lag[c],
                                        out.timing_phase[c], ref.shape[1])
        false += f
        for p, (_, fr) in assigned.items():
            hits.add((c, fr))
            e = int((out.bits[c, fr] != ref[c, p]).sum())
            if e:
                wrong[(c, fr)] = e
            err += e
            total += ref.shape[2]
    return err, total, false, hits, wrong


def check(cfg, out_p, out_x, truth_p, truth_x, expected: int,
          exclude=frozenset(), allow_marginal: bool = False):
    """``tools/tpu_parity.py``'s fields and the North star's criterion of
    one path against the XLA path, with that tool's one allowance: under
    the int8 hunt (or ``allow_marginal``), valid flags may flip on blocks
    that are a true packet in neither path (round() puts noise blocks on
    a knife edge of the energy gate), at most one in 1000 blocks.
    Against the truth every packet is found once, with no bit error and
    no false detect.  ``exclude``: (channel, block)s whose bits, cfo and
    eq_error are not compared (valid, lag and phase still are)."""
    both = out_x.valid & out_p.valid
    lag_both = both.copy()
    for c, b in exclude:
        both[c, b] = False
    diff = out_p.bits[both] != out_x.bits[both]
    flips = [tuple(map(int, cb)) for cb in
             np.argwhere(out_p.valid != out_x.valid)]
    true_miss = any(f in truth_p[3] or f in truth_x[3] for f in flips)
    v_eq = not flips
    v_ok = v_eq or ((cfg.hunt_dtype == "int8" or allow_marginal)
                    and not true_miss
                    and len(flips) <= max(1, out_x.valid.size // 1000))
    cfo_d = float(np.abs(out_p.cfo_hz[both] - out_x.cfo_hz[both]).max(
        initial=0.0))
    eq_d = float(np.abs(out_p.eq_error[both] - out_x.eq_error[both]).max(
        initial=0.0))
    rep = {
        "valid_identical": v_eq, "valid_diff_blocks": flips[:16],
        "valid_diffs_all_gate_marginal_noise": not true_miss,
        "bits_identical_on_valid": not bool(diff.any()),
        "bit_diffs_vs_xla": int(diff.sum()),
        "blocks_differing_vs_xla": int(diff.any(-1).sum()),
        "bit_errors_vs_truth": [truth_p[0], truth_p[1]],
        "false_detects": truth_p[2],
        "errored_blocks": [[c, b, e] for (c, b), e
                           in sorted(truth_p[4].items())[:16]],
        "lag_identical_on_valid": bool(np.array_equal(
            out_p.lag[lag_both], out_x.lag[lag_both])),
        "phase_identical_on_valid": bool(np.array_equal(
            out_p.timing_phase[lag_both], out_x.timing_phase[lag_both])),
        "blocks_not_compared": len(exclude),
        "max_cfo_delta_hz": cfo_d, "max_eq_error_delta": eq_d,
        "packets_detected": int(out_p.valid.sum()),
    }
    rep["valid_ok"] = bool(v_ok)
    rep["agrees_with_xla"] = bool(
        v_ok and rep["bits_identical_on_valid"]
        and rep["lag_identical_on_valid"] and rep["phase_identical_on_valid"]
        and cfo_d < 0.5 and eq_d < 2e-3)
    rep["ok"] = bool(
        rep["agrees_with_xla"] and truth_p[0] == 0
        and truth_p[1] == expected * cfg.bits_per_frame and truth_p[2] == 0)
    return rep


def hold(cfg, out_p, out_o, truth_p, truth_o, expected: int,
         parts: Parts = Parts(), rule: str = "full", cfo: bool = True,
         eq: bool = True, exclude=frozenset()):
    """``out_p`` against ``out_o`` (the XLA path, or the main path) by the
    North star's criterion as ``parts`` lets them part: ``check``'s valid
    rule, and where ``parts.noise`` names blocks, flips on those alone
    (with ``parts.noise_detects``, at most that many, on blocks a true
    packet in neither path, whose false detects are then not compared);
    lag and timing phase equal on blocks valid in both but the ties;
    bits equal there but on the ties, ``exclude`` and,
    unless ``rule`` is "full" or "planes", the blocks either path decodes
    wrong; with ``cfo`` |dcfo| < 0.5 Hz, with ``eq`` (and
    ``parts.eq_held``) |deq_error| < 2e-3.  ``rule`` against the truth:
    "full", every packet once without a bit error and false detects only
    on ``parts.noise`` (with ``parts.noise_detects``, those of ``out_o``
    and the flips); "same", the detections and false detects of
    ``out_o``; "" and "planes" (two paths on the same planes), none.
    With the default ``Parts()`` and "full" this is ``check``'s "ok".
    Returns (held, report)."""
    both = out_p.valid & out_o.valid
    noise, false = parts.noise, set()
    if parts.noise_detects:
        false = {tuple(cb) for cb in np.argwhere(
            out_p.valid | out_o.valid).tolist()} - truth_p[3] - truth_o[3]
        noise = noise | false

    def timing(o):        # the preamble's sample: lag x cycles + phase
        return o.lag.astype(np.int64) * cfg.cycles + o.timing_phase
    tie = (both & (np.abs(timing(out_p) - timing(out_o)) == 1)
           if parts.phase_ties else np.zeros_like(both))
    ties = {tuple(cb) for cb in np.argwhere(tie).tolist()}
    errored = (set() if rule in ("full", "planes")
               else {*truth_p[4], *truth_o[4]})
    rep = check(cfg, out_p, out_o, truth_p, truth_o, expected,
                exclude=ties | errored | false | set(exclude))
    flips = {tuple(cb) for cb in
             np.argwhere(out_p.valid != out_o.valid).tolist()}
    keep = both & ~tie
    for c, b in false:
        keep[c, b] = False
    held = ((rep["valid_ok"] or len(flips) <= parts.noise_detects)
            and (not noise or flips <= noise)
            and rep["bits_identical_on_valid"]
            and np.array_equal(out_p.lag[keep], out_o.lag[keep])
            and np.array_equal(out_p.timing_phase[keep],
                               out_o.timing_phase[keep])
            and (not cfo or rep["max_cfo_delta_hz"] < 0.5)
            and (not eq or not parts.eq_held
                 or rep["max_eq_error_delta"] < 2e-3))
    if rule == "full":
        false_ok = (truth_p[2] <= truth_o[2] + len(flips)
                    if parts.noise_detects else truth_p[2] <= len(noise))
        held = (held and truth_p[0] == 0 and false_ok
                and truth_p[1] == expected * cfg.bits_per_frame)
    elif rule == "same":
        held = (held and truth_p[2] == truth_o[2]
                and rep["packets_detected"] == int(out_o.valid.sum()))
    rep["phase_ties"] = sorted(ties)[:16]
    rep["held"] = bool(held)
    return bool(held), rep


def paths(cfg, frames, dev) -> dict:
    """{path: (run, kernels it launches)} of every kernel path ``cfg``
    allows, each from a fresh state."""
    C = frames.shape[1]
    rows = ("frontend_rows", "hunt", "extract_decode")
    out = {} if cfg.frac_timing else {
        "batch_pallas": (lambda: prod_rx_batch(
            cfg, prod_rx_init(cfg, (C,), dev), frames)[1], rows),
        "fused_rx": (lambda: prod_rx_batch(
            cfg, prod_rx_init(cfg, (C,), dev), frames,
            fuse_frontend=True)[1],
            ("frontend_decim", "hunt", "extract_decode"))}
    out["scan_pallas"] = (lambda: prod_rx_stream_pallas(
        cfg, prod_rx_init(cfg, (C,), dev), frames)[1],
        ("frontend_full", "decode_packets") if cfg.frac_timing else rows)
    out["pallas_fe_xla_decode"] = (lambda: prod_rx_stream_pallas(
        cfg, prod_rx_init(cfg, (C,), dev), frames, fuse_decode=False)[1],
        ("frontend_full",))
    return out


def host(out) -> ProdRxOut:
    """[B, C] outputs -> numpy [C, B]."""
    return ProdRxOut(*(v.transpose(0, 1).cpu().numpy() for v in out))


def drive_counted(what: str, fn, expect):
    """Run ``fn`` with the launch counters at 0 just before and read just
    after; where there is a card every kernel in ``expect`` must have
    launched and no other."""
    _build.reset_launches()
    res = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        if (not all(counts[k] > 0 for k in expect)
                or any(v for k, v in counts.items() if k not in expect)):
            raise RuntimeError(f"{what}: launches {counts}, the path's "
                               f"kernels are {expect}")
    return res


def run_config(cfg, frames, ref, dev, drive=drive_counted, tag: str = "",
               allow_marginal: bool = False):
    """The stream ``frames`` through the XLA path and every kernel path.
    Returns (the XLA path's summary, {path: report}, {path: launches})."""
    C = frames.shape[1]
    expected = C * ref.shape[1]
    out_x = host(drive(f"{tag}: xla", lambda: prod_rx_stream(
        cfg, prod_rx_init(cfg, (C,), dev), frames)[1], ()))
    truth_x = truth(cfg, out_x, ref)
    xla = {"blocks": frames.shape[0],
           "packets_detected": int(out_x.valid.sum()),
           "expected_packets": expected,
           "bit_errors_vs_truth": [truth_x[0], truth_x[1]],
           "false_detects": truth_x[2],
           "errored_blocks": [[c, b, e] for (c, b), e
                              in sorted(truth_x[4].items())[:16]],
           "ok": (truth_x[0] == 0 and truth_x[2] == 0
                  and truth_x[1] == expected * cfg.bits_per_frame)}
    reps, launches = {}, {}
    for path, (fn, expect) in paths(cfg, frames, dev).items():
        out_p = host(drive(f"{tag}: {path}", fn, expect))
        launches[path] = {k: v for k, v in _build.LAUNCHES.items() if v}
        reps[path] = check(cfg, out_p, out_x, truth(cfg, out_p, ref),
                           truth_x, expected, allow_marginal=allow_marginal)
    return xla, reps, launches


def payload(cfg, C: int, packets: int, seed: int, dev):
    """Seeded payload bits [C, packets, ns, 2 * data_symbols] on ``dev``
    and the sent payloads as numpy [C, packets, bits]."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bits = torch.randint(0, 2, (C, packets, cfg.ns, 2 * cfg.data_symbols),
                         generator=gen, device=dev, dtype=torch.uint8)
    return bits, bits.reshape(C, packets, -1).cpu().numpy()


def record(name, rec, cfg, args, dev, dev_head) -> dict:
    """One config's record in ``PARITY_TPU.json``'s layout."""
    bits, ref = payload(cfg, args.channels, args.packets, args.seed, dev)
    freq_hz = (args.freq_hz if args.freq_hz is not None
               else NUMEROLOGY_CFO_HZ.get(name, PARITY_CFO_HZ))
    snr_db = (args.snr_db if args.snr_db is not None
              else NUMEROLOGY_SNR_DB.get(name, PARITY_SNR_DB))
    frames = stream(cfg, bits, args.seed + 1, dev, snr_db, freq_hz)
    xla, reps, launches = run_config(cfg, frames, ref, dev, tag=name,
                                     allow_marginal=args.allow_marginal_flips)
    for path, rep in reps.items():
        rep["launches"] = launches[path]
    return {
        **dev_head, "config": name,
        "counterpart_of": rec,
        "seed": args.seed, "channels": args.channels,
        "packets": args.packets, "blocks": xla["blocks"],
        "snr_db": snr_db, "freq_hz": freq_hz,
        "alpha": cfg.alpha, "frac_timing": cfg.frac_timing,
        "frontend_dtype": cfg.frontend_dtype,
        "decim_dtype": cfg.decim_dtype, "hunt_dtype": cfg.hunt_dtype,
        "hunt_norm": cfg.hunt_norm, "cfo_dtype": cfg.cfo_dtype,
        "ls_refit_symbols": cfg.ls_refit_symbols,
        "xla_packets_detected": xla["packets_detected"],
        "expected_packets": xla["expected_packets"],
        "xla_bit_errors_vs_truth": xla["bit_errors_vs_truth"],
        "xla_false_detects": xla["false_detects"],
        "xla_errored_blocks": xla["errored_blocks"],
        "xla_ok": xla["ok"],
        "paths": reps,
        "ok": bool(xla["ok"] and all(r["ok"] for r in reps.values())),
    }


_OVERRIDES = (("frontend_dtype", str), ("ls_refit_iters", int),
              ("ls_refit_symbols", int), ("phase_refine_iters", int),
              ("hunt_dtype", str), ("hunt_norm", str), ("decim_dtype", str),
              ("cfo_dtype", str), ("alpha", float))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=PARITY_C)
    ap.add_argument("--packets", type=int, default=PARITY_PACKETS)
    ap.add_argument("--snr-db", type=float, default=None,
                    help=f"default {PARITY_SNR_DB}, or the numerology's "
                    f"own (NUMEROLOGY_SNR_DB)")
    ap.add_argument("--freq-hz", type=float, default=None,
                    help=f"default {PARITY_CFO_HZ}, or the numerology's "
                    f"own (NUMEROLOGY_CFO_HZ)")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--config", default="default",
                    choices=[name for name, rec, _ in
                             configs(DEFAULT_CONFIG) if rec]
                    + list(_build.NUMEROLOGIES),
                    help="one of the pinned records' configs, or a named "
                    "numerology at its bench operating point")
    ap.add_argument("--all-records", action="store_true",
                    help="the seven pinned configs, one record each")
    ap.add_argument("--out", default=None,
                    help="the record (default: the config's PARITY_GPU "
                    "file in --out-dir)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--frontend-dtype", choices=["bf16", "f32"])
    ap.add_argument("--refit-iters", dest="ls_refit_iters", type=int)
    ap.add_argument("--refit-symbols", dest="ls_refit_symbols", type=int)
    ap.add_argument("--refine-iters", dest="phase_refine_iters", type=int)
    ap.add_argument("--hunt-dtype", choices=["bf16", "f32", "int8"])
    ap.add_argument("--hunt-norm", choices=["energy", "espan", "none"])
    ap.add_argument("--decim-dtype", choices=["f32", "bf16"])
    ap.add_argument("--cfo-dtype", choices=["f32", "bf16"])
    ap.add_argument("--alpha", type=float)
    ap.add_argument("--frac-timing", action="store_true")
    ap.add_argument("--allow-marginal-flips", action="store_true",
                    help="the int8 hunt's allowance for every hunt dtype")
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu: the plain versions)")
    args = ap.parse_args(argv)
    dev = tool_device(args.device, "parity", timing=False)
    dev_head = head(dev)

    chosen = [(name, rec, cfg) for name, rec, cfg in configs(DEFAULT_CONFIG)
              if rec and (args.all_records or name == args.config)]
    if not args.all_records:
        chosen += [c for c in numerology_configs(DEFAULT_CONFIG)
                   if c[0] == args.config]
    ok = True
    for name, rec, cfg in chosen:
        kw = {k: getattr(args, k) for k, _ in _OVERRIDES
              if getattr(args, k) is not None}
        if args.frac_timing:
            kw["frac_timing"] = True
        cfg = cfg.replace(**kw)
        out_name = (rec.replace("TPU", "GPU") if rec
                    else f"PARITY_GPU_{name.upper()}.json")
        rep = record(name, rec, cfg, args, dev, dev_head)
        path = (args.out if args.out and not args.all_records
                else os.path.join(args.out_dir, out_name))
        with open(path, "w") as f:
            json.dump(rep, f, indent=1)
        print(json.dumps({"config": name, "record": path, "ok": rep["ok"],
                          "paths": {p: r["ok"] for p, r
                                    in rep["paths"].items()},
                          "xla_ok": rep["xla_ok"],
                          "card": rep["card"] or "cpu run, no card"}),
              flush=True)
        ok = ok and rep["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
