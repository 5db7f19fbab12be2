#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the production RX once on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases:

  1. device   -- name, CUDA version, power limit; exits 1 without CUDA;
  2. build    -- compiles the kernels (``singlecarrier_tpu_torch/csrc``)
                 into ``build/torch_kernels/`` and prints ptxas' register
                 and spill report;
  3. kernels  -- each of the ten kernels against its plain PyTorch
                 version on the card (C=256 channels x 4 blocks, golden
                 packets + noise), at the library default and the bench
                 operating point (the decodes' valid flags and dibits
                 equal); the mixer-folded front-ends in all
                 three output layouts and the full-rate front-end, equal
                 to the bit; the gate stage
                 against the full decode's gate column; the bench
                 operating point again on 5 channels x 3 blocks (a row
                 count no block size divides); the four decimating
                 front-ends (premix and folded) on 8192 x 4 rows of
                 noise over the whole int16 range, both plane dtypes and
                 all three layouts, and the full-rate front-end on such
                 rows and on a second block carrying their state, equal
                 to the bit; then the hunt alone on 8192 x 4 rows of
                 full-scale noise at both operating points and with the
                 int8 operand on f32 planes (lag, phase and peak equal
                 on every row); and on NaN windows (a NaN phase state, one
                 NaN sample in the carried planes) under every operand
                 mode and statistic: equal to the plain version, and by
                 the JAX kernel's rule (a phase whose statistic holds a
                 NaN does not win, a NaN quantises to 0);
  4. main     -- ``prod_rx_batch(fuse_frontend=True)`` at the bench
                 operating point, 8192 channels, two chained dispatches
                 of 10 blocks carrying the state, on the golden stream
                 delayed by 0..1879 samples per channel: every channel
                 must decode its 10 packets (a packet at a block seam
                 may be found twice, as in the JAX package; such repeats
                 are counted); 32 channels are checked
                 against the plain path on the CPU; then one noise-only
                 dispatch counts false detects;
  5. paths    -- on the same frames, at the same width: (a) the
                 two-kernel batch path ``prod_rx_batch(fuse_frontend=
                 False)`` with the plane state, (b) the per-block
                 streaming path ``prod_rx_stream_pallas`` with a
                 ``ProdRxState``, (c) the two unfused batch paths
                 (``fuse_hunt=False`` and ``fuse_extract=False``) on the
                 first 4 blocks; each must decode every packet and agree
                 with the others at the level of decisions, and each is
                 driven with the launch counters at 0 just before and
                 read just after; then, the same way, (d) both batch
                 paths with ``mixer_fold=True`` (decisions equal to the
                 premix main path's), (e) the gated two-phase RX
                 ``prod_rx_batch_gated`` on 8192 channels of which every
                 32nd carries the golden stream and the rest full-scale
                 noise (count, order and rows equal to the full path's,
                 across the dispatch seam; a small capacity reports its
                 overflow), (f) ``prod_rx_stream_pallas`` with
                 ``frac_timing=True`` one block at a time (32 channels
                 against the plain path on the CPU, ``frac`` included);
                 (g) loopback parity, the counterpart of
                 ``tools/tpu_parity.py`` and its ``PARITY_TPU*.json``
                 records: the port's TX and channel (128 channels x 6
                 packets, 12 dB, 15 Hz) through the XLA path
                 ``prod_rx_stream`` (plain PyTorch, the oracle) and every
                 kernel path the config allows, each held to it by the
                 North star's criterion and to the truth (768/768
                 packets, 0 bit errors, 0 false detects), for the seven
                 pinned configs and the library default under each of
                 the six other knob values; (h) BER: ``ber_run`` at 2, 4
                 and 6 dB,
                 317,440 bits a point, one noisy stream through the XLA
                 path and both kernel batch paths: every packet found,
                 no false detect; the kernel paths' errors equal and
                 their Wilson interval overlapping ``BER_PALLAS.jsonl``'s
                 at that SNR (a record of the one-kernel path); the XLA
                 path's overlapping theirs, its overlap with the record
                 reported; (i) the knob variants: each of the seven
                 configuration values the kernels take as template
                 parameters (``KNOB_VALUES``) at both operating points,
                 phase 3's comparison of the ten kernels under it on
                 golden rows, then the kernels it changes on 8192 x 4
                 rows of full-scale noise (front-ends equal to the bit,
                 the hunt's lag, phase and peak equal, the decode's gated
                 and valid flags equal); (j) the named numerologies
                 (``ops/_build.NUMEROLOGIES``: the eight of at most 7
                 taps, 5 cycles and 376 symbols a block, the seven
                 wider ones up to 16 taps, 10 cycles and 624 symbols, in
                 ``WIDE_NUMEROLOGIES``, the six of
                 ``RETUNED_NUMEROLOGIES``: 1 and 2 correlation segments,
                 128 and 4096 DFT bins, 25 and 45 RRC taps, and the five
                 of ``LONG_NUMEROLOGIES``: 24 and 32 taps, 872, 1120 and
                 1616 symbols), whose
                 twenty-six libraries build from phase 2 on, seven at
                 a time, each numerology run as its library lands:
                 for each, the build's seconds, ptxas' registers, static
                 shared memory and spills per kernel, and each body's
                 block layout (shared bytes, dynamic past 48 KB;
                 threads; the decode's LS solve in shared memory above
                 7 taps);
                 (1) phase 3's and (i)'s comparisons of every kernel and
                 knob variant with its plain version at the numerology's
                 default and bench operating point, on its own TX's rows
                 among noise and on 32,768 rows of full-scale noise; (2)
                 the XLA path and every kernel path (the batch paths in
                 every flag combination, both with ``mixer_fold``, the
                 superstep, the gated RX, both streaming bodies, and at
                 ``J_FRAC`` the frac body) on (g)'s kind of stream at the
                 numerology (at seg1, seg2 and nfft128 at a CFO they
                 reach, at ns24, ns32 and ns48 at 24 dB, where the XLA
                 path must decode every packet), each held to the XLA
                 path by the North star's
                 criterion, and to the truth where the XLA path itself
                 finds every packet (at ``JAX_PARTS``' numerologies,
                 where the JAX package's own Pallas and XLA paths part
                 alike, as it lets them part); (3) the main path
                 at 8192 x 128 x 3 chained dispatches of full-scale
                 noise (half the channels where a row's PCM and planes
                 pass wide_corner's: ``J_ROW_BYTES``, ns48 at 4096;
                 samples/s, the three kernels beside their bounds,
                 peak memory, launches) and every kernel at 32,768 rows
                 beside its bound;
                 (o) the CLI at a long geometry: ``ber --eq-length 24
                 --ns 24 --snrs 6`` (872 symbols a block, its library
                 built from phase 2 on) in this process through ``--path
                 fused_rx`` (the three main-path kernels launched, the
                 counters at 0 just before), ``--path batch_pallas``
                 (its three kernels) and ``--path xla`` (none): the two
                 kernel paths' detections, bit errors and false detects
                 equal, the XLA path's detections and false detects
                 equal to theirs and each one's bit errors inside the
                 other's Wilson interval;
                 (k) the faithful receiver ``rx_stream`` (plain PyTorch,
                 no kernel: the launch counters stay at 0): the C
                 harness's ``tx_pcm`` on 8192 channels, every channel
                 equal to the C fixture ``rxt_*`` and, at 20 Hz,
                 ``f20_rxt_*`` (matches there equal to the port's own CPU
                 run); 32 channels of it at delays over 0..1879 and
                 ``blocked=32`` on 8192 channels at every delay, each
                 held to the port's CPU run of the same channels; the
                 five other numerologies at which the JAX package's
                 faithful path runs, 128 channels of each one's own TX,
                 held to the CPU run; then its rates at 8192 and 65,536
                 channels x 8 chained frames, exact and blocked, with
                 the host's enqueue time, the launches of one frame,
                 peak memory and the TPU records as history;
                 (l) the runtime layer (``singlecarrier_tpu_torch.
                 runtime``): the native engine's transposes at 8192
                 channels against numpy's; phase 4's frames written
                 interleaved to a file and read back through
                 ``PcmDispatchSource(workers=8)`` -> ``PrefetchIngest``
                 (pinned buffers, side-stream copies) -> ``feed`` -> the
                 main path, every output field equal to phase 4's to the
                 bit, the profiler showing every host-to-device copy
                 pinned and on a stream without kernels; again with
                 ``depth=1, inflight=0`` (each buffer refilled once) and
                 in ring mode at 64 channels, each equal to the main path
                 called directly; ``StreamDemodulator`` on 8192 channels
                 against ``prod_rx_stream``; the plane state checkpointed
                 between the dispatches and resumed, equal to the bit;
                 ``ElasticDemodulator`` through a source fault and a NaN
                 phase, equal to the clean run; ``checkify_step`` on a
                 NaN phase; then the rates at 8192 x 16 blocks a dispatch
                 on a file of full-scale noise: host assembly at 1, 4, 8
                 and 16 workers, memcpy, ring mode, pinned and pageable
                 H2D, compute on a resident operand (and at 128 blocks),
                 end to end through ``feed`` with the compute stream's
                 busy share, and which of them binds;
                 (m) the multi-device layer (``singlecarrier_tpu_torch.
                 parallel``): on a one-rank NCCL group (``tcp://
                 127.0.0.1``), ``make_fused_sharded_rx`` over phase 4's
                 frames equal to phase 4's outputs to the bit (and with
                 ``fuse_frontend=False`` by decisions), ``metrics_summary``
                 through NCCL equal to the local reduction, the plane state
                 through ``save_sharded`` / ``restore_sharded`` between the
                 dispatches resumed equal to the bit; ``_grid_shard`` for
                 each of 2 and 4 time shards in one process, decisions equal
                 to phase 4's across every seam and 10/10 golden packets;
                 two spawned gloo processes on card 0 (NCCL takes one rank a
                 card), ``make_fused_grid_sharded_rx`` at (ch=1, time=2)
                 and ``make_fused_sharded_rx`` at ch=2, each rank equal to
                 its slice to the bit; then the rates: the main path and
                 the one-rank path in turns, the two gloo ranks combined
                 with the halo exchange alone, the grid at 4 shards;
                 (n) the tools (``singlecarrier_tpu_torch.tools``), each
                 one's ``main`` in this process at a reduced size, writing
                 into ``build/chip_smoke_tools``: ``parity`` (one config,
                 128 channels), ``detection`` (8192 x 16 noise blocks,
                 one Pd point), ``roofline`` (the ten kernels at 32,768
                 rows), ``profile_stages`` (the one-kernel prefixes), both
                 gated benches (8192 x 8), ``ingest_bench`` (two
                 dispatches) and ``scaling_bench`` (the one-rank path and
                 two shards): each record parses and names the card,
                 every Wilson interval holds its estimate, no share
                 exceeds 100%, parity reports ok;
                 (p) the edge geometries (``EDGE_GEOMETRIES``: 7 and 9
                 cycles, 64 and 768 bins, 9 and 43 RRC taps; 903
                 symbols at 1 segment, 2-symbol tasks at 1120, 17 taps
                 with 4096 bins at 624 symbols, 32 taps with 1616
                 symbols at 10 cycles and at 4096 bins), whose eleven
                 libraries are queued with (j)'s, the slowest first, and
                 which runs after (o), before (k), so that every library
                 is built before the host-bound phases: each one's
                 ptxas lines and block layout, then (j) 1 at it but for
                 its 5 x 3 rows (at ``EDGE_NO_PACKETS``,
                 where no receiver finds a packet, the decode held by
                 its valid and gated flags alone);
  6. timing   -- chained dispatches of the main path (premix, then
                 ``mixer_fold=True``: (d1)), of the gated RX, of (a) and
                 of (d2), (a) with ``mixer_fold=True`` (8192 x 128
                 blocks), (b) and (f) over 128 blocks, the batch paths'
                 kernels and the full-rate front-end at that dispatch
                 size (the front-ends beside the SM clock they run at
                 and their FFMA floor, or for the full-rate one its
                 FMUL + FADD floor and what ptxas says of it), and each
                 kernel against its plain version at 8192 x 4 rows, each
                 beside its bound (``_kernel_bounds``), the hunt in both
                 operand modes, then each knob variant at 8192 x 4 rows
                 beside its bound and the default instantiation; the main
                 path at 8192 x 128 under each knob value (samples/s
                 beside the operating point's, peak memory, launches, the
                 three kernels' split); the XLA path at 8192 x 8 blocks
                 and ``python -m singlecarrier_tpu_torch loopback``.

Prints one ``{"kernels": [...]}`` line (each kernel with its knob
variants under "variants" and its (j) readings by numerology under
"geometries"), the ``nvidia-smi`` name/power line and,
last, ``{"ok": true, "device": {...}}``.  Any failing phase
exits non-zero before the last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_T0 = time.perf_counter()      # the script's start, for its phase stamps


def _at() -> str:
    return f"{time.perf_counter() - _T0:.0f} s of the script"

try:
    from singlecarrier_tpu_torch.tools._measure import (
        B_CMP, B_KTIME, C_CMP, C_MAIN, KERNELS, KNIFE_EDGE, KNOB_VALUES,
        SEED, PhaseError, bench_point as _bench_point,
        fp32_floor as _fp32_floor, frames as _frames,
        golden_stream as _golden_stream, hunt_windows as _hunt_windows,
        kernel_bounds as _kernel_bounds, kernel_calls as _kernel_calls,
        kernel_inputs as _kernel_inputs, numerology_tx as _numerology_tx,
        require as _require, row_inputs as _row_inputs,
        sm_clock_under as _sm_clock_under, time_cuda as _time_cuda)
except ImportError as e:          # main() reports it, after the CUDA check
    _INCOMPLETE = e
else:
    _INCOMPLETE = None

B_MAIN = 10                    # main path: two dispatches of B_MAIN blocks
B_TIME, ITERS = 128, 3         # timed dispatches of C_MAIN x B_TIME
B_UNFUSED = 4                  # blocks of the unfused paths (c)
N_REF_CH = 32                  # channels re-run on the CPU plain path
GOLDEN_EVERY = 32              # gated RX: every 32nd channel carries packets
K_GATED, K_SMALL = 8192, 64    # gated RX capacities (the second overflows)
K_TIME = (1024, 8192)          # gated RX capacities of the timed noise run:
                               # the first overflows, the second holds the
                               # rows of full-scale noise that pass the gate


def _ptxas_of(log: str, kernel: str) -> str:
    """What ``ptxas -v`` says of ``kernel`` in a verbose build log: its
    registers, shared memory and spills, on one line."""
    from singlecarrier_tpu_torch.ops import _build
    for entry, said in _build.ptxas_entries(log).items():
        if entry.startswith(kernel):
            return "; ".join(said)
    raise PhaseError(f"ptxas said nothing of {kernel}")


def _decisions_agree(a, b, what: str, stats: bool = True) -> None:
    """The port's decision-level parity criterion (tools/tpu_parity.py);
    ``stats=False`` leaves out cfo and eq_error (paths that read the
    planes in different dtypes are compared by decisions, as the JAX
    package's own tests compare them)."""
    import torch
    v = a.valid
    _require(torch.equal(v, b.valid), f"{what}: valid differs "
             f"({int((v != b.valid).sum())} rows)")
    _require(torch.equal(a.bits[v], b.bits[v]), f"{what}: bits differ")
    _require(torch.equal(a.lag[v], b.lag[v]), f"{what}: lag differs")
    _require(torch.equal(a.timing_phase[v], b.timing_phase[v]),
             f"{what}: timing phase differs")
    if stats and bool(v.any()):
        dc = float((a.cfo_hz[v] - b.cfo_hz[v]).abs().max())
        de = float((a.eq_error[v] - b.eq_error[v]).abs().max())
        _require(dc < 0.5 and de < 2e-3,
                 f"{what}: |dcfo| {dc} Hz, |deq_error| {de}")


def _check_packets(torch, outs, tx_bits, cfg) -> int:
    """Every channel decodes each of the 10 transmitted packets once, with
    the transmitted bits except the TX-truncated last 10.

    A preamble that starts within one symbol of a block seam is found by
    both windows that contain it (lag 375 of one, lag 0 of the next), in
    this port as in the JAX package.  Such a repeat -- a detection within
    5 samples of the previous block's, with the same bits -- is counted
    and dropped.  Returns the number of channels with a repeat.
    """
    valid = torch.cat([o.valid for o in outs])               # [2B, C]
    bits = torch.cat([o.bits for o in outs])                 # [2B, C, 496]
    blk = torch.arange(valid.shape[0], device=valid.device)[:, None]
    pos = ((blk * cfg.symbols_per_block + torch.cat([o.lag for o in outs]))
           * cfg.cycles + torch.cat([o.timing_phase for o in outs]))
    rep = torch.zeros_like(valid)
    rep[1:] = valid[1:] & valid[:-1] & (pos[1:] - pos[:-1] <= cfg.cycles)
    same = (bits[1:, :, :-10] == bits[:-1, :, :-10]).all(-1)
    _require(bool((same | ~rep[1:]).all()),
             "a seam repeat decoded different bits")
    kept = valid & ~rep
    per_ch = kept.sum(0)
    C = valid.shape[1]
    _require(bool((per_ch == 10).all()),
             f"packets per channel: min {int(per_ch.min())}, max "
             f"{int(per_ch.max())} (want 10 on all {C})")
    order = torch.sort((~kept).to(torch.int8), dim=0, stable=True).indices
    got = torch.gather(bits, 0, order[:10, :, None].expand(10, C,
                                                           bits.shape[-1]))
    bad = (got[..., :-10] != tx_bits[:, None, :-10]).any(-1).any(0)
    _require(not bool(bad.any()),
             f"payload bits wrong on {int(bad.sum())} channels")
    return int(rep.any(0).sum())


def _compare_kernels(torch, cfg, inputs, what: str,
                     edges: bool = False) -> dict:
    """Each kernel against its plain version on the same operands (the
    decodes' dibits, with ``edges``, but at knife edges); returns {name:
    {"max_abs_err": x}}."""
    from singlecarrier_tpu_torch.ops.decode import (
        _extract_from_planes, extract_decode, extract_decode_ref,
        fused_decode, fused_decode_extract, fused_decode_extract_ref,
        fused_decode_ref, hunt)
    from singlecarrier_tpu_torch.ops.frontend import (
        frontend_decim, frontend_decim_ref, frontend_rows, frontend_rows_ref)
    ddt = torch.bfloat16 if cfg.decim_dtype == "bf16" else torch.float32
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = inputs
    report = {}
    dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    dr = frontend_decim_ref(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    torch.cuda.synchronize()
    err1 = (dk.float() - dr.float()).abs()
    report["frontend_decim"] = {"max_abs_err": float(err1.max())}
    _require(torch.equal(dk, dr),
             f"{what}: frontend_decim differs from its plain version on "
             f"{int((dk != dr).sum())} values, max |err| {float(err1.max())}")
    print(f"[kernels] {what}: frontend_decim vs plain: max |err| "
          f"{float(err1.max()):.3e} (tolerance none: equal to the bit in "
          f"{cfg.decim_dtype}; {_fe_why(cfg)})", flush=True)

    report["hunt"] = _compare_hunt(torch, cfg, dk, dprev0, what)
    lk, pk_, qk = hunt(cfg, dk, dprev0)

    ok_ = extract_decode(cfg, dk, dprev0, lk, pk_, qk)
    or_ = extract_decode_ref(cfg, dk, dprev0, lk, pk_, qk)
    torch.cuda.synchronize()
    pkt = _extract_from_planes(cfg, dk, dprev0, lk, pk_)
    report["extract_decode"] = _compare_decode(
        torch, cfg, ok_, or_, what, "extract_decode",
        (pkt[:, 0].contiguous(), pkt[:, 1].contiguous(), qk), edges)

    # ---- the per-row front-end, both layouts ----
    C = pcm.shape[1]
    rows = _row_inputs(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    worst = 0.0
    for transposed in (True, False):
        fk = frontend_rows(cfg, *rows, transposed=transposed)
        fr = frontend_rows_ref(cfg, *rows, transposed=transposed)
        torch.cuda.synchronize()
        odt = ddt if transposed else torch.float32
        _require(fk.dtype == odt, f"{what}: frontend_rows dtype "
                 f"{fk.dtype}, want {odt}")
        err = (fk.float() - fr.float()).abs()
        _require(torch.equal(fk, fr),
                 f"{what}: frontend_rows (transposed={transposed}) differs "
                 f"from its plain version on {int((fk != fr).sum())} "
                 f"values, max |err| {float(err.max())}")
        worst = max(worst, float(err.max()))
        layout = (f"transposed {cfg.decim_dtype}" if transposed
                  else "row-major f32")
        print(f"[kernels] {what}: frontend_rows ({layout}) vs plain: max "
              f"|err| {float(err.max()):.3e} (tolerance none: equal to the "
              f"bit)", flush=True)
        if transposed:
            _require(torch.equal(fk, dk), f"{what}: frontend_rows with "
                     f"the batch path's phases and tails differs from "
                     f"frontend_decim")
        else:
            drow = fk
    report["frontend_rows"] = {"max_abs_err": worst}

    # ---- the decode variants, on windows of the row-major planes ----
    wins, lag, ph, peak, pkt_r, pkt_i = _hunt_windows(cfg, drow, C)
    ek = _decode_rows(torch, fused_decode_extract(cfg, wins, lag, ph, peak))
    er = fused_decode_extract_ref(cfg, wins, lag, ph, peak)
    pk = _decode_rows(torch, fused_decode(cfg, pkt_r, pkt_i, peak))
    pr = fused_decode_ref(cfg, pkt_r, pkt_i, peak)
    torch.cuda.synchronize()
    report["decode_extract"] = _compare_decode(
        torch, cfg, ek, er, what, "decode_extract", (pkt_r, pkt_i, peak),
        edges)
    report["decode_packets"] = _compare_decode(
        torch, cfg, pk, pr, what, "decode_packets", (pkt_r, pkt_i, peak),
        edges)
    _require(torch.equal(ek, pk), f"{what}: decode_extract and "
             f"decode_packets disagree on the same packets")
    _compare_new_kernels(torch, cfg, inputs, rows, what, report)
    return report


def _compare_hunt(torch, cfg, dk, dprev0, what: str) -> dict:
    """The hunt against its plain version on planes ``dk``: lag and phase
    equal on every row, and the peak equal to the bit: in int8 mode the
    integer correlation is exact, in the bf16 and f32 modes the segment
    sums run in the plain version's ascending k, and every f32 sum after
    them keeps the plain order."""
    from singlecarrier_tpu_torch.ops.decode import hunt, hunt_ref
    lk, pk_, qk = hunt(cfg, dk, dprev0)
    lr, pr_, qr = hunt_ref(cfg, dk, dprev0)
    torch.cuda.synchronize()
    rel = float(((qk - qr).abs() / qr.abs().clamp_min(1e-30)).max())
    _require(torch.equal(lk, lr) and torch.equal(pk_, pr_),
             f"{what}: hunt lag/phase differ on {int((lk != lr).sum())}/"
             f"{int((pk_ != pr_).sum())} rows")
    _require(torch.equal(qk, qr), f"{what}: hunt peak differs on "
             f"{int((qk != qr).sum())} rows (rel err {rel})")
    print(f"[kernels] {what}: hunt ({cfg.hunt_dtype} operand, hunt_norm "
          f"{cfg.hunt_norm}) vs plain: lag and phase identical on "
          f"{lk.numel()} rows, peak equal to the bit", flush=True)
    return {"max_abs_err": float((qk - qr).abs().max())}


def _compare_hunt_nan(torch, cfg, inputs, what: str) -> None:
    """The hunt on NaN windows against its plain version (lag, phase and
    peak equal to the bit), and the JAX kernel's rule on them.  Channels
    4k + 1 carry a NaN phase, so their planes are NaN from the front-end
    on; channels 4k + 2 one NaN sample in the carried planes.  A phase
    whose statistic holds a NaN does not win, so a NaN-phase row keeps
    lag 0, phase 0 and the peak 2 (-1) in the peak's units wherever a NaN
    reaches every phase's statistic (an energy, or a bf16 / f32 operand);
    the int8 operand takes a NaN as 0, so under hunt_norm none the hunt
    of the NaN windows is that of the windows with their NaNs zeroed."""
    from singlecarrier_tpu_torch.ops.decode import hunt
    from singlecarrier_tpu_torch.ops.frontend import frontend_decim
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = inputs
    C, dev = pcm.shape[1], pcm.device
    p0r = p0r.clone()
    p0r[1::4] = float("nan")
    dprev0 = dprev0.clone()
    ch = torch.arange(2, C, 4, device=dev)
    dprev0[ch % cfg.cycles, ch % 2, ch,
           (ch * 37) % cfg.symbols_per_block] = float("nan")
    dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    _compare_hunt(torch, cfg, dk, dprev0, f"{what}, NaN windows")
    lk, pk_, qk = hunt(cfg, dk, dprev0)
    int8_hunt = cfg.hunt_dtype == "int8"
    if int8_hunt and cfg.hunt_norm == "none":
        zk = hunt(cfg, torch.nan_to_num(dk, nan=0.0),
                  torch.nan_to_num(dprev0, nan=0.0))
        _require(all(torch.equal(a, b) for a, b in zip((lk, pk_, qk), zk)),
                 f"{what}: the int8 hunt of NaN windows is not that of "
                 f"the windows with the NaNs zeroed")
        rule = "equal to the hunt of the windows with the NaNs zeroed"
    else:
        scale = 1.0 / cfg.hunt_int8_scale ** 2 if int8_hunt else 1.0
        rows = (torch.arange(lk.numel(), device=dev) % C) % 4 == 1
        want = torch.tensor(2.0 * -1.0, device=dev) * torch.tensor(
            scale, dtype=torch.float32, device=dev)
        _require(bool((lk[rows] == 0).all() and (pk_[rows] == 0).all()
                      and (qk[rows] == want).all()),
                 f"{what}: a NaN-phase row did not keep lag 0, phase 0, "
                 f"peak {float(want)}")
        rule = (f"every NaN-phase row at lag 0, phase 0, peak "
                f"{float(want)}")
    print(f"[kernels] {what}: hunt ({cfg.hunt_dtype} operand, hunt_norm "
          f"{cfg.hunt_norm}) on NaN windows ({len(range(1, C, 4))} "
          f"channels of a NaN phase, {len(ch)} with one NaN sample): lag, "
          f"phase and peak equal to the plain version's; {rule}",
          flush=True)


def _compare_decimating(torch, cfg, inputs, what: str, gen=None):
    """The four decimating front-ends (premix and folded) against their
    plain versions, every layout: equal to the bit.  With ``gen`` the
    rows are full-scale noise (the whole int16 range: saturated inputs
    and bf16 ties) in place of ``inputs``' PCM."""
    from singlecarrier_tpu_torch.ops.frontend import (
        frontend_decim, frontend_decim_folded_ref, frontend_decim_ref,
        frontend_rows, frontend_rows_folded_ref, frontend_rows_ref)
    pcm, p0r, p0i, t0r, t0i, adv, _ = inputs
    rows_of = "golden rows among noise"
    if gen is not None:
        pcm = torch.randint(-32768, 32768, pcm.shape, generator=gen,
                            device=pcm.device, dtype=torch.int16)
        rows_of = "rows of full-scale noise"
    rows = _row_inputs(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    for fold, decim_ref, rows_ref in (
            (False, frontend_decim_ref, frontend_rows_ref),
            (True, frontend_decim_folded_ref, frontend_rows_folded_ref)):
        name = "folded" if fold else "premix"
        dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv,
                            mixer_fold=fold)
        dr = decim_ref(cfg, pcm, p0r, p0i, t0r, t0i, adv)
        _require(torch.equal(dk, dr), f"{what}: {name} frontend_decim "
                 f"differs from its plain version on "
                 f"{int((dk != dr).sum())} values")
        del dr
        for transposed in (True, False):
            fk = frontend_rows(cfg, *rows, transposed=transposed,
                               mixer_fold=fold)
            fr = rows_ref(cfg, *rows, transposed=transposed)
            _require(torch.equal(fk, fr), f"{what}: {name} frontend_rows "
                     f"(transposed={transposed}) differs from its plain "
                     f"version on {int((fk != fr).sum())} values")
            if transposed and not fold:
                _require(torch.equal(fk, dk), f"{what}: frontend_rows "
                         f"differs from frontend_decim")
            del fk, fr
        torch.cuda.synchronize()
        print(f"[kernels] {what}: {name} frontend_decim and frontend_rows "
              f"({cfg.frontend_dtype} operands; transposed "
              f"{cfg.decim_dtype}, row-major f32) vs plain on "
              f"{dk.shape[2]} {rows_of}: max |err| 0 (equal "
              f"to the bit)" + ("" if fold else ", and frontend_rows equal "
                                "to frontend_decim"), flush=True)
        del dk


_FULL_WHY = ("each f32 product and sum rounded on its own, in the plain "
             "version's order")


def _compare_full_on_noise(torch, cfg, inputs, gen, what: str):
    """The full-rate front-end against its plain version on rows of
    full-scale noise (the whole int16 range), then on a second block of
    noise whose halos and phases are the state ``fused_frontend`` carried
    out of the first: equal to the bit on both."""
    from singlecarrier_tpu_torch.ops.frontend import (
        frontend_full, frontend_full_ref, fused_frontend)
    pcm, p0r, p0i, t0r, t0i, adv, _ = inputs

    def noise():
        return torch.randint(-32768, 32768, pcm.shape, generator=gen,
                             device=pcm.device, dtype=torch.int16)

    rows = _row_inputs(cfg, noise(), p0r, p0i, t0r, t0i, adv)
    _, _, ntr, nti, npr, npi = fused_frontend(cfg, *rows)
    chained = (noise().reshape(rows[0].shape), npr, npi, ntr, nti)
    for block, ops in (("first block", rows), ("chained block", chained)):
        fk = frontend_full(cfg, *ops)
        fr = frontend_full_ref(cfg, *ops)
        torch.cuda.synchronize()
        _require(torch.equal(fk, fr), f"{what}: frontend_full ({block}) "
                 f"differs from its plain version on "
                 f"{int((fk != fr).sum())} values, max |err| "
                 f"{float((fk - fr).abs().max())}")
        del fk, fr
    print(f"[kernels] {what}: frontend_full vs plain on {rows[0].shape[0]} "
          f"rows of full-scale noise and on a second block carrying their "
          f"halos and phases: max |err| 0 (equal to the bit; {_FULL_WHY})",
          flush=True)


def _fe_why(cfg) -> str:
    """Why a decimating front-end returns its plain version's bits."""
    if cfg.frontend_dtype == "bf16":
        return "same f32 sum order, exact products"
    return "same f32 sum order, each product and sum rounded on its own"


def _compare_new_kernels(torch, cfg, inputs, rows, what: str, report: dict):
    """The mixer-folded front-ends, the gate stage and the full-rate
    front-end against their plain versions; adds their entries to
    ``report``."""
    from singlecarrier_tpu_torch.ops.decode import (
        extract_decode, extract_gate, extract_gate_ref, hunt)
    from singlecarrier_tpu_torch.ops.frontend import (
        frontend_decim, frontend_decim_folded_ref, frontend_full,
        frontend_full_ref, frontend_rows, frontend_rows_folded_ref)
    ddt = torch.bfloat16 if cfg.decim_dtype == "bf16" else torch.float32
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = inputs

    def _exact(name, got, want, dtype, note="", why=_fe_why(cfg)):
        torch.cuda.synchronize()
        _require(got.dtype == dtype, f"{what}: {name}{note} dtype "
                 f"{got.dtype}, want {dtype}")
        err = (got.float() - want.float()).abs()
        _require(torch.equal(got, want), f"{what}: {name}{note} differs "
                 f"from its plain version on {int((got != want).sum())} "
                 f"values, max |err| {float(err.max())}")
        print(f"[kernels] {what}: {name}{note} vs plain: max |err| "
              f"{float(err.max()):.3e} (tolerance none: equal to the bit; "
              f"{why})", flush=True)
        return float(err.max())

    # each folded kernel against ITS OWN plain version: the two take their
    # halos differently, so their planes are not the same to the bit
    dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv, mixer_fold=True)
    report["frontend_decim_folded"] = {"max_abs_err": _exact(
        "frontend_decim_folded", dk,
        frontend_decim_folded_ref(cfg, pcm, p0r, p0i, t0r, t0i, adv), ddt)}
    worst = 0.0
    for dd, transposed in (("f32", True), ("bf16", True), ("f32", False)):
        c_ = cfg.replace(decim_dtype=dd)
        odt = torch.bfloat16 if dd == "bf16" else torch.float32
        fk = frontend_rows(c_, *rows, transposed=transposed, mixer_fold=True)
        worst = max(worst, _exact(
            "frontend_rows_folded", fk,
            frontend_rows_folded_ref(c_, *rows, transposed=transposed), odt,
            f" ({'transposed ' + dd if transposed else 'row-major f32'})"))
        if transposed and odt == ddt:
            n_diff = int((fk != dk).sum())
            print(f"[kernels] {what}: the two folded front-ends differ on "
                  f"{n_diff} of {dk.numel()} plane values (a carried halo "
                  f"un-rotates to the raw sample only up to rounding)",
                  flush=True)
    report["frontend_rows_folded"] = {"max_abs_err": worst}

    D = cfg.frame_symbols
    lk, pk_, qk = hunt(cfg, dk, dprev0)
    gk = extract_gate(cfg, dk, dprev0, lk, pk_, qk)
    gr = extract_gate_ref(cfg, dk, dprev0, lk, pk_, qk)
    full = extract_decode(cfg, dk, dprev0, lk, pk_, qk)
    torch.cuda.synchronize()
    _require(torch.equal(gk[:, D + 3], gr[:, D + 3])
             and torch.equal(gk[:, D + 3], full[:, D + 3]),
             f"{what}: extract_gate's gated flags differ from its plain "
             f"version's or from extract_decode's")
    n_gated = int(gk[:, D + 3].sum())
    _require(0 < n_gated < gk.shape[0] or not _packets_expected,
             f"{what}: extract_gate gated {n_gated} of {gk.shape[0]} rows")
    _require(torch.equal(gk[:, D + 4:], full[:, D + 4:]),
             f"{what}: extract_gate's energy or hunt slots differ from "
             f"extract_decode's")
    _require(bool((gk[:, :D + 3] == 0).all()),
             f"{what}: extract_gate left a decode slot non-zero")
    rel = float(((gk[:, D + 4] - gr[:, D + 4]).abs()
                 / gr[:, D + 4].abs().clamp_min(1e-30)).max())
    _require(rel <= 1e-5 and torch.equal(gk[:, D + 5:], gr[:, D + 5:]),
             f"{what}: extract_gate energy rel err {rel}")
    print(f"[kernels] {what}: extract_gate vs plain: gated identical "
          f"({n_gated}/{gk.shape[0]} rows) and equal to extract_decode's "
          f"column; energy, lag, phase, peak equal to extract_decode's, "
          f"energy rel err vs plain {rel:.3e} (tolerance 1e-5; a 128-term "
          f"sum in butterfly order); every decode slot zero", flush=True)
    report["extract_gate"] = {
        "max_abs_err": float((gk - gr).abs().max())}

    report["frontend_full"] = {"max_abs_err": _exact(
        "frontend_full", frontend_full(cfg, *rows),
        frontend_full_ref(cfg, *rows), torch.float32, why=_FULL_WHY)}


def _plain_margins(torch, cfg, packets):
    """[N, D] the plain decode's soft margin of each symbol of the packets
    (pkt_r, pkt_i, peak): distance to the slicer's boundary over the
    symbol's magnitude."""
    from singlecarrier_tpu_torch.ops import decode
    pkt_r, pkt_i, peak = packets
    mask = torch.from_numpy(decode._mask_np(cfg.frame_symbols, True)).to(
        pkt_r.device)
    _, ar, ai = decode._decode_core(cfg, pkt_r, pkt_i, peak[:, None], mask,
                                    soft=True)
    return (torch.minimum((ar - ai).abs(), (ar + ai).abs())
            / torch.sqrt(ar * ar + ai * ai).clamp_min(1e-30))


def _compare_decode(torch, cfg, out_k, out_r, what: str, name: str,
                    packets, edges: bool = False) -> dict:
    """A decode kernel's packed rows against its plain version's on the
    packets (pkt_r, pkt_i, peak) it decoded: valid equal; dibits equal on
    valid rows, with ``edges`` but at knife edges (``KNIFE_EDGE``, each
    printed: the kernel's sums run in other orders than the plain
    version's); |dcfo| < 0.5 Hz, |deq_error| < 2e-3."""
    D = cfg.frame_symbols
    vk = (out_k[:, D + 3] > 0.5) & (out_k[:, D] > cfg.match_threshold)
    vr = (out_r[:, D + 3] > 0.5) & (out_r[:, D] > cfg.match_threshold)
    _require(torch.equal(vk, vr), f"{what}: {name} valid differs "
             f"on {int((vk != vr).sum())} rows")
    _require(bool(vk.any()) or not _packets_expected,
             f"{what}: {name}: no packet decoded")
    _require(_packets_expected
             or torch.equal(out_k[:, D + 3], out_r[:, D + 3]),
             f"{what}: {name} gated differs on "
             f"{int((out_k[:, D + 3] != out_r[:, D + 3]).sum())} rows")
    diff = (out_k[:, :D] != out_r[:, :D]) & vk[:, None]
    _require(edges or not bool(diff.any()),
             f"{what}: {name} dibits differ on {int(diff.sum())} symbols "
             f"of valid rows")
    margins = (_plain_margins(torch, cfg, packets)[diff] if diff.any()
              else out_k.new_zeros((0,)))
    _require(bool((margins < KNIFE_EDGE).all()),
             f"{what}: {name} dibits differ on valid rows off a knife edge "
             f"(plain margins {margins.tolist()[:8]})")
    stat_err = (out_k[vk, D:D + 5] - out_r[vr, D:D + 5]).abs()
    if not vk.any():                       # EDGE_NO_PACKETS
        stat_err = out_k.new_zeros((1, 5))
    dcfo, deq = float(stat_err[:, 2].max()), float(stat_err[:, 1].max())
    _require(dcfo < 0.5 and deq < 2e-3,
             f"{what}: {name} |dcfo| {dcfo}, |deq| {deq}")
    rule = (f"but {margins.numel()} on a knife edge (plain margins "
            f"{[f'{x:.1e}' for x in margins.tolist()]}, allowed under "
            f"{KNIFE_EDGE:.0e})" if edges else "(tolerance none)")
    print(f"[kernels] {what}: {name} vs plain: valid identical "
          f"({int(vk.sum())}/{vk.numel()} rows valid), descrambled dibits "
          f"identical {rule}, |dcfo| {dcfo:.3e} Hz, |deq_error| "
          f"{deq:.3e}, max |err| of the valid rows' stats "
          f"{float(stat_err.max()):.3e} (tolerances 0.5 Hz, 2e-3)",
          flush=True)
    return {"max_abs_err": float(stat_err.max())}


def _decode_rows(torch, dec):
    """A decode launcher's stat dict as packed [N, D + 5] rows."""
    return torch.cat([dec["dibits"], dec["matches"].float()[:, None],
                      dec["eq_error"][:, None], dec["cfo_hz"][:, None],
                      dec["gated"].float()[:, None], dec["energy"][:, None]],
                     dim=1)


# ---- (i) the knob variants: the kernels' other instantiations


def _compare_decode_soft(torch, cfg, out_k, pkt_r, pkt_i, peak, what: str,
                         name: str) -> dict:
    """A decode kernel variant's packed rows against its plain version on
    the same packets, as ``_compare_decode`` holds them."""
    from singlecarrier_tpu_torch.ops import decode
    mask = torch.from_numpy(decode._mask_np(cfg.frame_symbols, True)).to(
        pkt_r.device)
    out_r = decode._decode_core(cfg, pkt_r, pkt_i, peak[:, None], mask)
    return _compare_decode(torch, cfg, out_k, out_r, what, name,
                           (pkt_r, pkt_i, peak), edges=True)


def _compare_decode_variants(torch, cfg, inputs, what: str) -> dict:
    """The three decode kernels under ``cfg`` against their plain
    versions (``_compare_decode_soft``) on the golden rows of
    ``inputs``: extract_decode on the front-end's planes at the hunt's
    lag and phase, decode_extract and decode_packets on the windows and
    packets the plain hunt finds in the row-major planes."""
    from singlecarrier_tpu_torch.ops.decode import (
        _extract_from_planes, extract_decode, fused_decode,
        fused_decode_extract, hunt)
    from singlecarrier_tpu_torch.ops.frontend import (frontend_decim,
                                                      frontend_rows)
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = inputs
    dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    lk, pk_, qk = hunt(cfg, dk, dprev0)
    pkt = _extract_from_planes(cfg, dk, dprev0, lk, pk_)
    D = cfg.frame_symbols
    rep = {"extract_decode": _compare_decode_soft(
        torch, cfg, extract_decode(cfg, dk, dprev0, lk, pk_, qk)[:, :D + 5],
        pkt[:, 0].contiguous(), pkt[:, 1].contiguous(), qk, what,
        "extract_decode")}
    rows = _row_inputs(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    wins, wl, wph, wpk, pkt_r, pkt_i = _hunt_windows(
        cfg, frontend_rows(cfg, *rows), pcm.shape[1])
    ek = _decode_rows(torch, fused_decode_extract(cfg, wins, wl, wph, wpk))
    dp = _decode_rows(torch, fused_decode(cfg, pkt_r, pkt_i, wpk))
    rep["decode_extract"] = _compare_decode_soft(
        torch, cfg, ek, pkt_r, pkt_i, wpk, what, "decode_extract")
    rep["decode_packets"] = _compare_decode_soft(
        torch, cfg, dp, pkt_r, pkt_i, wpk, what, "decode_packets")
    _require(torch.equal(ek, dp), f"{what}: decode_extract and "
             f"decode_packets disagree on the same packets")
    return rep


def _compare_decode_on_noise(torch, cfg, dk, dprev0, what: str) -> dict:
    """extract_decode against its plain version on planes of full-scale
    noise: valid and gated identical on every row.  No packet is there to
    hold the stats to; the largest |dcfo| and |deq_error| of the rows
    that pass the energy gate are reported."""
    from singlecarrier_tpu_torch.ops.decode import (
        extract_decode, extract_decode_ref, hunt)
    D = cfg.frame_symbols
    lag, ph, peak = hunt(cfg, dk, dprev0)
    ok_ = extract_decode(cfg, dk, dprev0, lag, ph, peak)
    or_ = extract_decode_ref(cfg, dk, dprev0, lag, ph, peak)
    torch.cuda.synchronize()
    gk, gr = ok_[:, D + 3] > 0.5, or_[:, D + 3] > 0.5
    vk = gk & (ok_[:, D] > cfg.match_threshold)
    vr = gr & (or_[:, D] > cfg.match_threshold)
    _require(torch.equal(gk, gr) and torch.equal(vk, vr),
             f"{what}: extract_decode gated/valid differ from the plain "
             f"version on {int((gk != gr).sum())}/{int((vk != vr).sum())} "
             f"rows")
    err = (ok_[gk, D:D + 3] - or_[gk, D:D + 3]).abs()
    dcfo = float(err[:, 2].max()) if err.numel() else 0.0
    deq = float(err[:, 1].max()) if err.numel() else 0.0
    print(f"[knobs] {what}: extract_decode vs plain on {dk.shape[2]} rows "
          f"of full-scale noise: gated ({int(gk.sum())} rows) and valid "
          f"({int(vk.sum())}) identical; on the gated rows |dcfo| "
          f"{dcfo:.3e} Hz, |deq_error| {deq:.3e} (reported)", flush=True)


def _knob_phase(torch, gen, inputs_fn, default, bench, prefix="") -> dict:
    """(i): each knob value at both operating points, the kernels it
    changes against their plain versions (the others run their default
    instantiation, which phase 3 holds): on golden rows among noise
    (C_CMP x B_CMP), then on C_MAIN x B_KTIME rows of full-scale noise.
    The front-ends equal to the bit in every layout; the hunt's lag,
    phase and peak equal to the bit; the decode by decisions, knife edges
    aside (``_compare_decode_soft``), and on noise its gated and valid
    flags.  ``prefix`` leads every label.  Returns {knob: {kernel:
    largest max |err|}}."""
    from singlecarrier_tpu_torch.ops.frontend import frontend_decim
    errs = {}
    for knob, value, kernels in KNOB_VALUES:
        name = f"{knob}={value}"
        worst = errs[name] = {k: 0.0 for k in kernels}
        for what, base in (("library default", default),
                           ("bench operating point", bench)):
            cfg = base.replace(**{knob: value})
            tag = f"{prefix}{name} at the {what}"
            golden = inputs_fn(cfg, C_CMP, B_CMP)
            noisy = inputs_fn(cfg, C_MAIN, B_KTIME)
            if knob == "frontend_dtype":
                for inputs, g in ((golden, None), (noisy, gen)):
                    _compare_decimating(torch, cfg, inputs, tag, g)
                continue
            pcm, p0r, p0i, t0r, t0i, adv, dprev0 = noisy
            pcm = torch.randint(-16384, 16384, pcm.shape, generator=gen,
                                device=pcm.device, dtype=torch.int16)
            dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
            rows = f"{tag}, {C_MAIN} x {B_KTIME} rows of noise"
            if knob.startswith("hunt"):
                gk = frontend_decim(cfg, *golden[:6])
                _compare_hunt(torch, cfg, gk, golden[6], f"{tag}, golden")
                _compare_hunt(torch, cfg, dk, dprev0, rows)
                continue
            for k, r in _compare_decode_variants(torch, cfg, golden,
                                                 tag).items():
                worst[k] = max(worst[k], r["max_abs_err"])
            _compare_decode_on_noise(torch, cfg, dk, dprev0, rows)
            del golden, noisy, pcm, dk
    return errs


def _knob_main_paths(torch, np, cfg, noise, rate, dispatches, main_rate,
                     smi_line: str) -> dict:
    """The main path at the full dispatch under each knob value, the rest
    of ``cfg`` (the bench operating point) unchanged: samples/s over
    ITERS chained dispatches of ``noise`` beside ``main_rate`` (the
    operating point's own reading), peak memory, the launches of the run
    and the three kernels' split of a dispatch.  Then the batch paths
    that launch the knob's other kernels (the two-kernel and folded ones
    for the front-end knob, the two unfused ones for the decode knobs),
    one dispatch of B_UNFUSED blocks each.  Returns {knob: {kernel:
    launches over those runs}}."""
    from singlecarrier_tpu_torch.modem import (prod_rx_batch, prod_rx_init,
                                               prod_rx_init_planes)
    from singlecarrier_tpu_torch.ops import _build
    from singlecarrier_tpu_torch.ops.decode import extract_decode, hunt
    from singlecarrier_tpu_torch.ops.frontend import frontend_decim
    n, B = cfg.frame_size, noise.shape[0]
    advs = np.exp(-2j * np.pi * cfg.center / cfg.fs * n
                  * np.arange(B)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag])).to(noise.device)
    main = ("frontend_decim", "hunt", "extract_decode")
    launches = {}
    for knob, value, _ in KNOB_VALUES:
        kcfg, key = cfg.replace(**{knob: value}), f"{knob}={value}"
        state = prod_rx_init_planes(kcfg, C_MAIN)
        state, _ = prod_rx_batch(kcfg, state, noise, fuse_frontend=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        r = rate(f"main path with {key} {C_MAIN} ch x {B} blocks x {ITERS} "
                 f"chained dispatches",
                 lambda: dispatches(state, kcfg, fuse_frontend=True),
                 ITERS * B)
        counts = launches[key] = dict(_build.LAUNCHES)
        _require(all(counts[k] == ITERS for k in main)
                 and sum(counts.values()) == ITERS * len(main),
                 f"main path with {key}: launches {counts}")
        p0r, p0i, t0r, t0i, dprev0 = prod_rx_init_planes(kcfg, C_MAIN)
        dk = frontend_decim(kcfg, noise, p0r, p0i, t0r, t0i, adv)
        lk, pk_, qk = hunt(kcfg, dk, dprev0)
        split = {
            "frontend_decim": lambda: frontend_decim(kcfg, noise, p0r, p0i,
                                                     t0r, t0i, adv),
            "hunt": lambda: hunt(kcfg, dk, dprev0),
            "extract_decode": lambda: extract_decode(kcfg, dk, dprev0, lk,
                                                     pk_, qk)}
        print(f"[timing] main path with {key}: {r:.4e} samples/s, "
              f"{r / main_rate:.4f} of the operating point's {main_rate:.4e}"
              f"; launches {counts}; kernels of one {C_MAIN} x {B} "
              f"dispatch: " + ", ".join(
                  f"{k} {_time_cuda(fn, 3):.3f} ms" for k, fn in split.items())
              + f"; {smi_line}", flush=True)
        del state, dk, lk, pk_, qk, split
        fold = kcfg.replace(mixer_fold=True)
        runs = {"frontend_dtype": ((fold, {"fuse_frontend": True}),
                                   (fold, {}), (kcfg, {}))}.get(
            knob, () if knob.startswith("hunt") else (
                (kcfg, {"fuse_hunt": False}),
                (kcfg, {"fuse_hunt": False, "fuse_extract": False})))
        for rcfg, flags in runs:
            st = (prod_rx_init(rcfg, (C_MAIN,)) if "fuse_hunt" in flags
                  else prod_rx_init_planes(rcfg, C_MAIN))
            _build.reset_launches()
            prod_rx_batch(rcfg, st, noise[:B_UNFUSED], **flags)
            torch.cuda.synchronize()
            for k, v in _build.LAUNCHES.items():
                counts[k] += v
        if runs:
            print(f"[timing] {key}: launches over the main path's run and "
                  f"one {C_MAIN} x {B_UNFUSED} dispatch of each other batch "
                  f"path that launches its kernels: {counts}", flush=True)
    return launches


# ---- (g) loopback parity and (h) BER: the port's XLA path as the oracle

BER_SNRS = (2.0, 4.0, 6.0)
BER_PACKETS, BER_TRIALS = 10, 64         # 317,440 payload bits a point
BER_RECORD = "BER_PALLAS.jsonl"
B_XLA = 8                                # timed XLA path: C_MAIN x B_XLA


def _report(tag: str, line: dict) -> None:
    print(f"[{tag}] {json.dumps(line)}", flush=True)


def _parity_phase(torch, default, drive, dev, seed: int) -> dict:
    """(g): the records' stream through the XLA path (the oracle) and every
    path the config allows (``tools/parity.run_config``), each held to it;
    one ``[parity]`` line each.  Returns {config: {kernel: launches over
    its kernel paths}}."""
    from singlecarrier_tpu_torch.tools import parity
    bits, ref = parity.payload(default, parity.PARITY_C,
                               parity.PARITY_PACKETS, seed, dev)
    streams, launches = {}, {}
    for name, record, cfg in parity.configs(default):
        head = {"config": name, "record": record}
        counts = launches[name] = {}
        if cfg.alpha not in streams:
            streams[cfg.alpha] = parity.stream(cfg, bits, seed + 1, dev)
        xla, reps, path_launches = parity.run_config(
            cfg, streams[cfg.alpha], ref, dev, drive, f"parity {name}")
        line = {**head, "path": "xla",
                **{k: v for k, v in xla.items() if k != "errored_blocks"}}
        _report("parity", line)
        _require(xla["ok"], f"parity {name}: the XLA path against the "
                 f"truth: {line}")
        for path, rep in reps.items():
            for k, v in path_launches[path].items():
                counts[k] = counts.get(k, 0) + v
            _report("parity", {**head, "path": path, **rep})
            _require(rep["ok"], f"parity {name}: {path} against the XLA "
                     f"path: {rep}")
    return launches


def _ber_record(path: str) -> dict:
    with open(path) as f:
        return {r["snr_db"]: r for r in map(json.loads, f) if r}


def _overlap(a, b) -> bool:
    return a[0] <= b[1] and b[0] <= a[1]


def _ber_phase(torch, cfg, drive, dev, seed: int, record: dict) -> None:
    """(h): ``ber_run`` at BER_SNRS on the same noisy stream (the generator
    reseeded alike) through the three paths.  Gates: every packet found
    with no false detect on every path; the two kernel paths' errors
    equal and their Wilson interval overlapping the record's (the record
    is of the one-kernel path); the XLA path's interval overlapping the
    kernel paths'.  The XLA path rounds nowhere the kernels round (f32
    front-end, float PCM), so its errors on the same stream are another
    draw of the same statistic: its overlap with the record is reported
    beside it, not gated."""
    from singlecarrier_tpu_torch.ber import PATHS, ber_run
    expect = {"xla": (),
              "batch_pallas": ("frontend_rows", "hunt", "extract_decode"),
              "fused_rx": ("frontend_decim", "hunt", "extract_decode")}
    for i, snr in enumerate(BER_SNRS):
        res = {}
        for path in PATHS:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + i)
            res[path] = drive(f"ber {snr} dB: {path}", lambda: ber_run(
                cfg, gen, snr_db=snr, n_packets=BER_PACKETS,
                n_trials=BER_TRIALS, path=path, device=dev), expect[path])
        rec = record[snr]
        for path, r in res.items():
            _report("ber", {"path": path, **r, "record_ci95": rec["ber_ci95"],
                            "overlaps_record": _overlap(r["ber_ci95"],
                                                        rec["ber_ci95"])})
            _require(r["detection_rate"] == 1.0 and r["false_detects"] == 0,
                     f"ber {snr} dB, {path}: detection "
                     f"{r['detection_rate']}, {r['false_detects']} false")
        kern = res["fused_rx"]
        _require(res["batch_pallas"]["err_bits"] == kern["err_bits"],
                 f"ber {snr} dB: the kernel paths count "
                 f"{res['batch_pallas']['err_bits']} and {kern['err_bits']} "
                 f"errors on the same stream")
        _require(_overlap(kern["ber_ci95"], rec["ber_ci95"]),
                 f"ber {snr} dB: the kernel paths' interval "
                 f"{kern['ber_ci95']} misses {BER_RECORD}'s "
                 f"{rec['ber_ci95']}")
        _require(_overlap(res["xla"]["ber_ci95"], kern["ber_ci95"]),
                 f"ber {snr} dB: the XLA path's interval "
                 f"{res['xla']['ber_ci95']} misses the kernels' "
                 f"{kern['ber_ci95']}")


# ---- (j) the numerologies: every kernel path at the named numerologies

J_FRAC = ("alt_9600",)       # numerologies whose (j) 2 runs the frac body
# Geometries whose default-knob decodes may part from their plain versions
# by a dibit at a knife edge (``KNIFE_EDGE``, each printed with its
# margin), as the knob variants may everywhere: cyc9, where a draw
# flipped one, the retuned numerologies and the edge geometries of their
# limits, where a draw flipped one at taps45, and the long ones and
# theirs (up to six times the symbols a packet).  Elsewhere the default
# knobs' dibits are equal.
KNIFE_EDGE_AT = ("cyc9", "seg1", "seg2", "nfft128", "nfft4096", "taps25",
                 "taps45", "nfft64", "nfft768", "taps9", "taps43", "eq24",
                 "eq32", "ns24", "ns32", "ns48", "seg1_ns25", "cyc6_ns32",
                 "eq17_ns16_nfft4096", "eq32_ns48_cyc10",
                 "eq32_ns48_nfft4096")
# Libraries built at once, each running its three nvcc together: enough
# to keep the card's machine's 8 cores busy (a build's last nvcc, the
# decode's, runs alone for a while), few enough that the first libraries
# land early and (j) runs each numerology while the later ones build.
BUILD_WORKERS = 7
_build_pool = []                # the one pool, made at the first queueing
# (j) 3 times C_MAIN x B_TIME blocks, or half the channels (and half
# again) where a row's PCM and bf16 planes pass wide_corner's 37,440 B:
# its split held two dispatches' planes beside the noise, 48.8 GiB of
# the card's 80 GB
J_ROW_BYTES = 37_440


def _timed_channels(cfg) -> int:
    """(j) 3's channels at ``cfg``: C_MAIN, halved while a dispatch's
    rows would pass C_MAIN rows of J_ROW_BYTES."""
    row = cfg.frame_size * 2 + cfg.cycles * 2 * cfg.symbols_per_block * 2
    c = C_MAIN
    while row * c > J_ROW_BYTES * C_MAIN:
        c //= 2
    return c


def _start_builds(configs: dict):
    """Queue every config's kernel library build, in order, on one pool of
    BUILD_WORKERS threads.  Returns {name: future of (seconds from its
    start, ptxas log)}."""
    import concurrent.futures
    from singlecarrier_tpu_torch.ops import _build

    def one(cfg):
        t0 = time.perf_counter()
        _, log = _build.build(verbose=True,
                              defines=_build.kernel_geometry(cfg))
        return time.perf_counter() - t0, log

    if not _build_pool:
        _build_pool.append(concurrent.futures.ThreadPoolExecutor(
            BUILD_WORKERS))
    return {name: _build_pool[0].submit(one, cfg)
            for name, cfg in configs.items()}


def _ptxas_table(log: str) -> dict:
    """{kernel: "regs a..b, smem ..., spills ..."} over every instantiation
    of each of the ten kernels in a verbose build log."""
    import re
    from singlecarrier_tpu_torch.ops import _build
    seen = {}
    for entry, said in _build.ptxas_entries(log).items():
        kernel = next((k for k in _build.KERNEL_ENTRIES
                       if entry.startswith(k)), None)
        if kernel:
            text = " ".join(said)
            seen.setdefault(kernel, []).append([
                int(m.group(1)) if m else 0 for m in (
                    re.search(r"Used (\d+) registers", text),
                    re.search(r"(\d+) bytes smem", text),
                    re.search(r"(\d+) bytes spill stores", text))])
    return {k: (f"{len(v)} instantiations, registers "
                f"{min(x[0] for x in v)}..{max(x[0] for x in v)}, static "
                f"smem {max(x[1] for x in v)} B, spill stores up to "
                f"{max(x[2] for x in v)} B")
            for k, v in seen.items()}


def _gated_as_out(torch, out, B: int, C: int):
    """The gated RX's compacted rows put back in the [B, C] layout of
    ``ProdRxOut`` (a row it did not decode is not valid)."""
    from singlecarrier_tpu_torch.modem import ProdRxOut
    count = min(int(out["count"]), out["valid"].shape[0])
    b = out["block_idx"][:count].long()
    c = out["channel_idx"][:count].long()

    def scatter(x):
        full = torch.zeros((B, C, *x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        full[b, c] = x[:count]
        return full
    return ProdRxOut(*(scatter(out[f]) for f in ProdRxOut._fields))


def _numerology_parity(torch, cfg, drive, dev, tag: str,
                       frac: bool) -> dict:
    """(j) 2: the records' kind of stream (``tools/parity.PARITY_C``
    channels x ``PARITY_PACKETS`` packets, 12 dB, 15 Hz, or the
    numerology's own CFO or SNR where those are out of its reach,
    ``tools/parity.NUMEROLOGY_CFO_HZ`` and ``NUMEROLOGY_SNR_DB``, where
    the XLA path must then decode every packet) at ``cfg``'s numerology
    through
    the XLA path and every kernel path, each held to the XLA path by
    ``tools/parity.hold``: the North star's criterion and the truth, every
    packet once with no bit error and no false detect.  Where the XLA path
    itself decodes packets with bit errors (a numerology whose band is
    impaired at 12 dB), the two receivers, which round in other places,
    may decide a marginal symbol or a refit guard apart: there a kernel
    path is held by decisions (valid, lag and phase everywhere, bits on
    the packets neither decoded wrong, the same detections and false
    detects, |dcfo| < 0.5 Hz; |deq_error| reported).  At the numerologies
    of ``tools/parity.JAX_PARTS``, where the JAX package's own Pallas and
    XLA paths part just as the port's do, a kernel path may part from the
    XLA path as it says.  Every path is held to the main path by the same
    decisions, with |dcfo| < 0.5 Hz, |deq_error| < 2e-3 and the bits of
    packets decoded wrong besides on the paths that read the main path's
    own planes; the others (the unfused
    ones, which read f32 windows, the folded ones, whose front-end rounds
    elsewhere, and the full-rate front-end with the XLA back end) may tie
    a timing with it where ``JAX_PARTS`` lets them tie with the XLA path.
    Both counts against the truth are printed. Returns {kernel:
    launches}."""
    from singlecarrier_tpu_torch.modem import (
        ProdRxOut, prod_rx_batch, prod_rx_batch_gated, prod_rx_gated_init,
        prod_rx_init, prod_rx_init_planes, prod_rx_stream,
        prod_rx_stream_pallas, prod_rx_stream_superstep)
    from singlecarrier_tpu_torch.ops import _build
    from singlecarrier_tpu_torch.tools import parity
    bits, ref = parity.payload(cfg, parity.PARITY_C, parity.PARITY_PACKETS,
                               SEED, dev)
    expected = parity.PARITY_C * parity.PARITY_PACKETS
    freq_hz = parity.NUMEROLOGY_CFO_HZ.get(tag, parity.PARITY_CFO_HZ)
    snr_db = parity.NUMEROLOGY_SNR_DB.get(tag, parity.PARITY_SNR_DB)
    frames = parity.stream(cfg, bits, SEED + 1, dev, snr_db, freq_hz)
    B, C = frames.shape[0], frames.shape[1]
    launches = {}

    def host(out):                                  # [B, C] -> numpy [C, B]
        return ProdRxOut(*(v.transpose(0, 1).cpu().numpy() for v in out))

    rows = ("frontend_rows", "hunt", "extract_decode")
    main = ("frontend_decim", "hunt", "extract_decode")
    fold = cfg.replace(mixer_fold=True)
    sup = next(k for k in (4, 3, 2, 1) if B % k == 0)
    runs = [(cfg, {
        "fused_rx, plane state": (lambda: prod_rx_batch(
            cfg, prod_rx_init_planes(cfg, C, dev), frames,
            fuse_frontend=True)[1], main),
        "batch_pallas": (lambda: prod_rx_batch(
            cfg, prod_rx_init(cfg, (C,), dev), frames)[1], rows),
        "fused_rx": (lambda: prod_rx_batch(
            cfg, prod_rx_init(cfg, (C,), dev), frames,
            fuse_frontend=True)[1], main),
        f"superstep {sup}": (lambda: prod_rx_stream_superstep(
            cfg, prod_rx_init_planes(cfg, C, dev), frames, superstep=sup,
            fuse_frontend=True)[1], main),
        "fuse_hunt=False": (lambda: prod_rx_batch(
            cfg, prod_rx_init(cfg, (C,), dev), frames, fuse_hunt=False)[1],
            ("frontend_rows", "decode_extract")),
        "fuse_extract=False": (lambda: prod_rx_batch(
            cfg, prod_rx_init(cfg, (C,), dev), frames, fuse_hunt=False,
            fuse_extract=False)[1], ("frontend_rows", "decode_packets")),
        "fused_rx, mixer_fold": (lambda: prod_rx_batch(
            fold, prod_rx_init_planes(fold, C, dev), frames,
            fuse_frontend=True)[1],
            ("frontend_decim_folded", "hunt", "extract_decode")),
        "batch_pallas, mixer_fold": (lambda: prod_rx_batch(
            fold, prod_rx_init_planes(fold, C, dev), frames)[1],
            ("frontend_rows_folded", "hunt", "extract_decode")),
        "gated": (lambda: _gated_as_out(torch, prod_rx_batch_gated(
            cfg, prod_rx_gated_init(cfg, C, dev), frames,
            max_detections=B * C)[1], B, C),
            ("frontend_decim", "hunt", "extract_gate", "extract_decode")),
        "scan_pallas": (lambda: prod_rx_stream_pallas(
            cfg, prod_rx_init(cfg, (C,), dev), frames)[1], rows),
        "pallas_fe_xla_decode": (lambda: prod_rx_stream_pallas(
            cfg, prod_rx_init(cfg, (C,), dev), frames,
            fuse_decode=False)[1], ("frontend_full",)),
    })]
    if frac:
        fcfg = cfg.replace(frac_timing=True)
        runs.append((fcfg, {
            "frac scan_pallas": (lambda: prod_rx_stream_pallas(
                fcfg, prod_rx_init(fcfg, (C,), dev), frames)[1],
                ("frontend_full", "decode_packets")),
            "frac pallas_fe_xla_decode": (lambda: prod_rx_stream_pallas(
                fcfg, prod_rx_init(fcfg, (C,), dev), frames,
                fuse_decode=False)[1], ("frontend_full",))}))
    parts = parity.JAX_PARTS.get(tag, parity.Parts())
    for rcfg, paths in runs:
        head = {"numerology": tag, "frac_timing": rcfg.frac_timing,
                "freq_hz": freq_hz, "snr_db": snr_db}
        anchor = None                   # the first path: the main one
        out_x = host(drive(f"{tag} parity: xla", lambda: prod_rx_stream(
            rcfg, prod_rx_init(rcfg, (C,), dev), frames)[1], ()))
        truth_x = parity.truth(rcfg, out_x, ref)
        # every packet once without a bit error, and no false detect but
        # where JAX_PARTS lets noise pass (eq24, eq32)
        xla_full = (truth_x[0] == 0
                    and (truth_x[2] == 0 or parts.noise_detects)
                    and truth_x[1] == expected * rcfg.bits_per_frame)
        _report("numerology", {**head, "path": "xla", "blocks": B,
                               "packets_detected": int(out_x.valid.sum()),
                               "expected_packets": expected,
                               "bit_errors_vs_truth": list(truth_x[:2]),
                               "false_detects": truth_x[2],
                               "truth_held": xla_full})
        # a stream chosen for the numerology is one the XLA path decodes
        _require(xla_full or (tag not in parity.NUMEROLOGY_CFO_HZ
                              and tag not in parity.NUMEROLOGY_SNR_DB),
                 f"{tag} parity: the XLA path decodes {truth_x[:3]} "
                 f"(bit errors, bits, false detects) at {freq_hz} Hz, "
                 f"{snr_db} dB")
        for path, (fn, expect) in paths.items():
            out_p = host(drive(f"{tag} parity: {path}", fn, expect))
            for k, v in _build.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v
            truth_p = parity.truth(rcfg, out_p, ref)
            # where the XLA path itself decodes packets wrong, by
            # decisions: those packets held by valid, lag and phase only,
            # |deq_error| reported
            held, rep = parity.hold(
                rcfg, out_p, out_x, truth_p, truth_x, expected, parts,
                "full" if xla_full else "same", eq=xla_full)
            _report("numerology", {**head, "path": path, **rep})
            _require(held, f"{tag} parity: {path} against the XLA path: "
                     f"{rep}")
            if anchor is None:          # the main path: the first run
                anchor = (out_p, truth_p)
                continue
            # the paths that read the main path's own planes equal it,
            # the bits of packets decoded wrong too; the others round
            # elsewhere, as the XLA path does, and may tie where it may;
            # bits of a noise block that JAX_PARTS lets cross the gate
            # are equalized noise, not compared
            stats = not any(k in path for k in ("fuse_", "fold", "xla"))
            held, to_main = parity.hold(
                rcfg, out_p, anchor[0], truth_p, anchor[1], expected,
                parity.Parts(phase_ties=parts.phase_ties and not stats,
                             noise_detects=0 if stats
                             else parts.noise_detects),
                "planes" if stats else "",
                cfo=stats, eq=stats, exclude=parts.noise)
            _report("numerology", {**head, "path": path,
                                   "against": "fused_rx, plane state",
                                   **to_main})
            _require(held, f"{tag} parity: {path} against the main path: "
                     f"{to_main}")
    return launches


def _print_build(kind: str, tag: str, cfg, sec: float, log: str,
                 how: str) -> None:
    """A geometry's build: its defines and seconds, ptxas' registers,
    shared memory and spills per kernel, and each body's block layout."""
    from singlecarrier_tpu_torch.ops import _build
    lib = _build.load(cfg)
    print(f"[{kind}] {tag}: {' '.join(_build.kernel_geometry(cfg))} built "
          f"in {sec:.1f} s ({how})", flush=True)
    for kern, line in _ptxas_table(log).items():
        print(f"[{kind}] {tag}: ptxas {kern}: {line}", flush=True)
    print(f"[{kind}] {tag}: block layout (shared bytes, dynamic past "
          f"48 KB): {json.dumps(_build.layout(lib))}", flush=True)


def _numerology_kernels(torch, gen, dev, tag: str, default):
    """(j) 1's first part: every kernel against its plain version at
    ``default``'s numerology, at the library default and the bench
    operating point, on rows of the numerology's own TX among noise and
    on C_MAIN x B_KTIME rows of full-scale noise (the decodes' dibits
    equal, at ``KNIFE_EDGE_AT`` but at knife edges).  Returns ({kernel:
    largest max |err|}, the inputs function)."""
    from singlecarrier_tpu_torch.ops.frontend import frontend_decim
    bench = _bench_point(default)
    tx = _numerology_tx(default, dev)

    def inputs(cfg_, C, B):
        return _kernel_inputs(gen, tx, cfg_, C, B, dev)

    errs = {}
    for what, cfg in (("default", default), ("bench", bench)):
        w = f"{tag} {what}"
        rep = _compare_kernels(torch, cfg, inputs(cfg, C_CMP, B_CMP), w,
                               tag in KNIFE_EDGE_AT)
        for k, v in rep.items():
            errs[k] = max(errs.get(k, 0.0), v["max_abs_err"])
        noisy = inputs(cfg, C_MAIN, B_KTIME)
        _compare_decimating(torch, cfg, noisy, f"{w}, {C_MAIN} x "
                            f"{B_KTIME}", gen)
        _compare_full_on_noise(torch, cfg, noisy, gen, f"{w}, {C_MAIN}"
                               f" x {B_KTIME}")
        pcm = torch.randint(-16384, 16384, noisy[0].shape, generator=gen,
                            device=dev, dtype=torch.int16)
        dk = frontend_decim(cfg, pcm, *noisy[1:6])
        _compare_hunt(torch, cfg, dk, noisy[6], f"{w}, {C_MAIN} x "
                      f"{B_KTIME} rows of noise")
        del noisy, pcm, dk
    return errs, inputs


def _numerology_phase(torch, np, dev, builds, drive, smi_line) -> dict:
    """(j): at every named numerology, (1) every kernel and knob variant
    against its plain version, (2) every kernel path against the XLA path
    (``_numerology_parity``), (3) the main path at C_MAIN x B_TIME x
    ITERS chained dispatches on full-scale noise, with the three kernels'
    ms beside their bounds.  The numerologies run in the order their
    libraries land, each on its own generator seeded from its name.
    Returns {kernel: {numerology: entry}} for the kernels line's
    "geometries"."""
    import concurrent.futures
    import zlib
    from singlecarrier_tpu_torch import DEFAULT_CONFIG
    from singlecarrier_tpu_torch.modem import (prod_rx_batch,
                                               prod_rx_init_planes)
    from singlecarrier_tpu_torch.ops import _build
    from singlecarrier_tpu_torch.ops.decode import extract_decode, hunt
    from singlecarrier_tpu_torch.ops.frontend import frontend_decim
    geometries = {name: {} for name in KERNELS}
    tags = {fut: tag for tag, fut in builds.items()}
    t_wait = time.perf_counter()
    for fut in concurrent.futures.as_completed(tags):
        tag = tags[fut]
        default = DEFAULT_CONFIG.replace(**_build.NUMEROLOGIES[tag])
        _print_build("numerology", tag, default, *fut.result(),
                     f"{BUILD_WORKERS} at once, queued at phase 2; waited "
                     f"{time.perf_counter() - t_wait:.1f} s, at {_at()}")
        t_start = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + zlib.crc32(tag.encode()))
        bench = _bench_point(default)
        # ---- 1. every kernel and knob variant against its plain version
        errs, inputs = _numerology_kernels(torch, gen, dev, tag, default)
        _compare_kernels(torch, bench, inputs(bench, 5, 3),
                         f"{tag} bench, 5 channels x 3 blocks",
                         tag in KNIFE_EDGE_AT)
        _knob_phase(torch, gen, inputs, default, bench, f"{tag}: ")
        t_1 = time.perf_counter()
        # ---- 2. parity of every kernel path with the XLA path
        launches = _numerology_parity(torch, bench, drive, dev, tag,
                                      tag in J_FRAC)
        t_2 = time.perf_counter()
        # ---- 3. the main path at full width on full-scale noise
        n, c_time = bench.frame_size, _timed_channels(bench)
        noise = torch.randint(-16384, 16384, (B_TIME, c_time, n),
                              generator=gen, device=dev, dtype=torch.int16)
        state = prod_rx_init_planes(bench, c_time)
        state, _ = prod_rx_batch(bench, state, noise, fuse_frontend=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            state, out = prod_rx_batch(bench, state, noise,
                                       fuse_frontend=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        main = ("frontend_decim", "hunt", "extract_decode")
        _require(all(counts[k] == ITERS for k in main)
                 and sum(counts.values()) == ITERS * len(main),
                 f"{tag} main path: launches {counts}")
        _require(bool(torch.isfinite(out.eq_error).all()
                      and torch.isfinite(out.cfo_hz).all()),
                 f"{tag} main path: non-finite outputs")
        rate = ITERS * B_TIME * c_time * n / wall
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the split below holds two dispatches' planes at once (48.8 GiB
        # at wide_corner): the loop's cached blocks go back first
        del state, out
        torch.cuda.empty_cache()
        p0r, p0i, t0r, t0i, dprev0 = prod_rx_init_planes(bench, c_time)
        advs = np.exp(-2j * np.pi * bench.center / bench.fs * n
                      * np.arange(B_TIME)).astype(np.complex64)
        adv = torch.from_numpy(np.stack([advs.real, advs.imag])).to(dev)
        dk = frontend_decim(bench, noise, p0r, p0i, t0r, t0i, adv)
        lk, pk_, qk = hunt(bench, dk, dprev0)
        split = {
            "frontend_decim": lambda: frontend_decim(
                bench, noise, p0r, p0i, t0r, t0i, adv),
            "hunt": lambda: hunt(bench, dk, dprev0),
            "extract_decode": lambda: extract_decode(
                bench, dk, dprev0, lk, pk_, qk)}
        bounds = _kernel_bounds(bench, c_time * B_TIME, c_time)
        k_ms = {k: _time_cuda(fn, 3) for k, fn in split.items()}
        print(f"[numerology] {tag}: main path {c_time} ch x {B_TIME} blocks "
              f"x {ITERS} chained dispatches on full-scale noise: "
              f"{wall:.3f} s, {rate:.4e} samples/s, peak memory "
              f"{peak:.1f} GiB, launches {counts}; kernels of one dispatch "
              + ", ".join(f"{k} {k_ms[k]:.3f} ms (bound {bounds[k][0]:.3f} "
                          f"ms, {bounds[k][1]})" for k in main)
              + f"; {smi_line}", flush=True)
        del noise, dk, lk, pk_, qk, split
        torch.cuda.empty_cache()
        # every kernel at C_MAIN x B_KTIME rows beside its bound
        kin = inputs(bench, C_MAIN, B_KTIME)
        kbounds = _kernel_bounds(bench, C_MAIN * B_KTIME, C_MAIN)
        for name, (kern, _) in _kernel_calls(bench, kin,
                                             C_MAIN).items():
            geometries[name][tag] = {
                "launches": launches.get(name, 0),
                "max_abs_err": errs.get(name, 0.0),
                "ms": _time_cuda(kern, 10), "bound_ms": kbounds[name][0],
                "bound_by": kbounds[name][1],
                "main_path_ms": k_ms.get(name),
                "main_path_bound_ms": bounds[name][0] if name in k_ms
                else None}
        del kin
        _require(all(v.get(tag, {}).get("launches", 0) > 0
                     for v in geometries.values()),
                 f"{tag}: a kernel was launched on none of (j)'s paths: "
                 f"{launches}")
        print(f"[numerology] {tag}: " + ", ".join(
            f"{k} {v[tag]['ms']:.3f} ms (bound {v[tag]['bound_ms']:.4f})"
            for k, v in geometries.items())
            + f" at {C_MAIN} x {B_KTIME} rows; phase seconds: kernels "
            f"{t_1 - t_start:.1f}, parity {t_2 - t_1:.1f}, timing "
            f"{time.perf_counter() - t_2:.1f}; {smi_line}", flush=True)
        t_wait = time.perf_counter()
    return geometries


# ---- (p) the edge geometries: builds no named numerology makes

# Shapes inside kernel_limits whose compile-time branches no named
# numerology takes: odd cycle counts above 5 (4-symbol front-end tasks of
# 28 and 36 accumulators, blocks an SM from the register file), and
# those of the limits below.  They build with (j)'s libraries.  (At 2
# cycles the receiver finds no packet of its own TX, the XLA path
# neither, so (j) 1 has no decode to hold there.)
EDGE_GEOMETRIES = {
    "cyc7": {"fs": 11200.0, "rs": 1600.0, "center": 1500.0},
    "cyc9": {"fs": 14400.0, "rs": 1600.0, "center": 1500.0},
    # the retuned limits' own branches: fewer bins than the DFT's
    # threads, a size no power of two, the shortest filter, a halo of
    # 4k + 2 samples (the front-ends' 8-byte staging)
    "nfft64": {"cfo_nfft": 64},
    "nfft768": {"cfo_nfft": 768},
    "taps9": {"ntaps": 9},
    "taps43": {"ntaps": 43},
    # the long limits' own branches: the first symbol count past the
    # Toeplitz hunt's 1024 threads (two values a thread) with 128-chip
    # segments (the Toeplitz body's 16-value slices, the int8 body's
    # sums over eight chunks), 2-symbol front-end tasks past 1024 threads
    # (two tasks a thread), the first b-vector of two sums a lane in an
    # 8-row decode block with its LS warps and separate powers (219,712
    # B), the widest front-end, hunt and decode blocks together (the
    # full-rate front-end's stores from its registers), and the decode's
    # largest block (4 rows of it)
    "seg1_ns25": {"corr_segments": 1, "ns": 25},
    "cyc6_ns32": {"fs": 9600.0, "rs": 1600.0, "center": 1500.0, "ns": 32},
    "eq17_ns16_nfft4096": {"eq_length": 17, "ns": 16, "cfo_nfft": 4096},
    "eq32_ns48_cyc10": {"eq_length": 32, "ns": 48, "fs": 16000.0,
                        "rs": 1600.0, "center": 1500.0},
    "eq32_ns48_nfft4096": {"eq_length": 32, "ns": 48, "cfo_nfft": 4096},
}
# Edge geometries whose receiver finds no packet of its own TX, the JAX
# package's neither (9 taps: the filter is too short): their decodes are
# held to the plain versions by the valid and gated flags alone.
EDGE_NO_PACKETS = ("taps9",)
_packets_expected = True     # False while (p) runs an EDGE_NO_PACKETS shape


def _edge_phase(torch, gen, dev, builds, smi_line: str) -> None:
    """(p): each of ``EDGE_GEOMETRIES`` as (j) 1 holds a named numerology
    but for its 5 x 3 rows: its build's ptxas lines and block layout, then
    every kernel and knob variant against its plain version, on a
    generator seeded from its name."""
    import zlib
    from singlecarrier_tpu_torch import DEFAULT_CONFIG
    for tag, fut in builds.items():
        t0 = time.perf_counter()
        gen.manual_seed(SEED + zlib.crc32(tag.encode()))
        cfg = DEFAULT_CONFIG.replace(**EDGE_GEOMETRIES[tag])
        _print_build("edge", tag, cfg, *fut.result(),
                     f"{BUILD_WORKERS} at once, queued at phase 2")
        # not (j)'s 5 x 3 rows, whose row count is the point there: at
        # 16 segments and 624 symbols every one of them may pass the gate,
        # whose check wants rows of both kinds
        global _packets_expected
        _packets_expected = tag not in EDGE_NO_PACKETS
        try:
            _, inputs = _numerology_kernels(torch, gen, dev, tag, cfg)
            _knob_phase(torch, gen, inputs, cfg, _bench_point(cfg),
                        f"{tag}: ")
        finally:
            _packets_expected = True
        print(f"[edge] {tag}: every kernel and knob variant equal to its "
              f"plain version, {time.perf_counter() - t0:.1f} s; "
              f"{smi_line}", flush=True)


# ---- (o) the CLI at a long geometry: ``ber`` through the one-kernel path

# 872 symbols a block and 24 taps.  The one-kernel and the two-kernel
# path take the same int16 PCM and bf16 planes: their detections, bit
# errors and false detects are equal.  The XLA path's detections and
# false detects equal theirs, and its bit errors lie inside the
# one-kernel path's Wilson interval and theirs inside its: the XLA path
# takes the channel's float PCM and the kernel paths its int16 cast
# (``ber.ber_run``), and the front-end rounds its operands to bf16, so at
# 6 dB, where 3 to 6% of the bits are wrong, marginal symbols decide
# apart (on a CPU draw 1169 against 1173 bit errors of 35,712 at 6 dB, 0
# against 6 at 10 dB).
CLI_LONG = {"eq_length": 24, "ns": 24}
CLI_ARGS = ("ber", "--eq-length", "24", "--ns", "24", "--snrs", "6")


def _cli_phase(build, smi_line: str) -> dict:
    """``python -m singlecarrier_tpu_torch ber --eq-length 24 --ns 24
    --snrs 6`` run in this process (the CLI's ``main``) with ``--path
    fused_rx``, ``--path batch_pallas`` and ``--path xla`` on the same
    seed, the launch counters at 0 just before each and read just after:
    the two kernel paths' detections, bit errors and false detects equal,
    the XLA path's detections and false detects equal to theirs and each
    one's bit errors inside the other's Wilson 95% interval; each kernel
    path through its three kernels and the XLA path through none.
    ``build`` is the geometry's library build, started with phase 2.
    Returns the fused path's launches."""
    import contextlib
    import io
    from singlecarrier_tpu_torch import cli
    from singlecarrier_tpu_torch.ops import _build
    sec, _ = build.result()
    line = " ".join(CLI_ARGS)
    got = {}
    for path in ("fused_rx", "batch_pallas", "xla"):
        buf = io.StringIO()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*CLI_ARGS, "--path", path])
        _require(rc == 0, f"cli {line} --path {path}: rc {rc}")
        got[path] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                     dict(_build.LAUNCHES), time.perf_counter() - t0)
    (fused, launches, t_f), (batch, b_launches, t_b), (xla, x_launches,
                                                        t_x) = got.values()
    keys = ("total_bits", "detection_rate", "false_detects")
    _require(all(fused[k] == batch[k] for k in ("err_bits", *keys)),
             f"cli {line}: fused_rx {fused} against batch_pallas {batch}")
    inside = (xla["ber_ci95"][0] <= fused["ber"] <= xla["ber_ci95"][1]
              and fused["ber_ci95"][0] <= xla["ber"] <= fused["ber_ci95"][1])
    _require(inside and all(fused[k] == xla[k] for k in keys),
             f"cli {line}: fused_rx {fused} against xla {xla}")

    def only(counts, kernels):
        return (all(counts[k] > 0 for k in kernels)
                and sum(counts.values()) == sum(counts[k] for k in kernels))
    _require(only(launches, ("frontend_decim", "hunt", "extract_decode"))
             and only(b_launches, ("frontend_rows", "hunt",
                                   "extract_decode"))
             and sum(x_launches.values()) == 0,
             f"cli {line}: launches fused_rx {launches}, batch_pallas "
             f"{b_launches}, xla {x_launches}")
    print(f"[cli] (o) {line} (geometry built in {sec:.1f} s): --path "
          f"fused_rx {json.dumps(fused)} in {t_f:.2f} s, launches "
          f"{launches}; --path batch_pallas {json.dumps(batch)} in "
          f"{t_b:.2f} s, launches {b_launches}; --path xla "
          f"{json.dumps(xla)} in {t_x:.2f} s; the kernel paths' detections,"
          f" bit errors and false detects equal, the XLA path's detections "
          f"and false detects equal to theirs, each one's bit errors inside "
          f"the other's interval; {smi_line}", flush=True)
    return launches


# ---- (k) the faithful receiver (modem/rx.py): plain PyTorch, no kernel

K_CH = 8192                  # channels of the C harness's stream
K_DELAYED = 32               # channels at delays 0..1879, against the CPU
K_BLOCK = 32                 # the blocked equalizer's block
K_NUM_CH = 128               # channels of each numerology's own TX
K_NUM_PACKETS = 4
K_TIME_CH = (8192, 65536)    # timed widths, each K_TIME_FRAMES chained
K_TIME_FRAMES = 8
# the numerologies other than the reference at which the JAX package's
# faithful rx_stream runs (seg4, seg16 and nfft1024 do not reach it)
K_NUMEROLOGIES = ("alt_9600", "tiny_payload", "mid_payload", "ns4", "eq7")
K_RECORDS = ("BENCH_FAITHFUL.json", "BENCH_FAITHFUL_BLOCKED.json")


def _host(out):
    """An RxOut of tensors -> the same of numpy arrays."""
    return type(out)(*(x.cpu().numpy() for x in out))


def _first(np, mask, *arrays) -> str:
    """The first few (frame, channel) pairs where ``mask`` holds, with the
    arrays' values there."""
    at = np.argwhere(mask)[:4]
    return f"{len(np.argwhere(mask))} at {at.tolist()}: " + " vs ".join(
        str(a[tuple(at.T)].tolist()) for a in arrays)


def _faithful_agree(np, got, want, what: str) -> int:
    """(k)'s criterion of a card run against the port's CPU run of the
    same channels ([frames, C] leaves): valid, max_index, matches and the
    bits of valid frames equal; max_value, mean and eof_cost within 1e-4
    of their scale.  Returns the bit rows of invalid frames that differ
    (the miss branch's slicing, reported)."""
    for name in ("valid", "max_index", "matches"):
        g, w = getattr(got, name), getattr(want, name)
        _require(np.array_equal(g, w), f"(k) {what}: {name} differs "
                 f"from the CPU run, " + _first(np, g != w, g, w))
    rows = (got.bits != want.bits).any(-1)
    _require(not (rows & want.valid).any(), f"(k) {what}: the bits of "
             f"valid frames differ, " + _first(np, rows & want.valid,
                                                want.matches))
    for name in ("max_value", "mean", "eof_cost"):
        g, w = getattr(got, name), getattr(want, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        _require(float(np.abs(g - w).max()) <= 1e-4 * scale,
                 f"(k) {what}: {name} off by {np.abs(g - w).max():.3e} at "
                 f"scale {scale:.3e}")
    return int(rows.sum())


def _faithful_vs_c(np, out, timing, golden, tag: str, what: str,
                   matches=None) -> None:
    """Every channel of ``out`` ([frames, C] numpy leaves) against the C
    fixture ``tag``: valid, max_index, the bits of valid frames and the
    final rx_timing equal; max_value and mean within rtol 1e-3; matches
    equal to ``matches`` (the C's by default)."""
    valid = golden[f"{tag}_valid"].astype(bool)
    want = {"valid": valid, "max_index": golden[f"{tag}_max_index"],
            "matches": golden[f"{tag}_matches"] if matches is None
            else matches}
    for name, w in want.items():
        g = getattr(out, name)
        _require((g == w[:, None]).all(), f"(k) {what}: {name} differs "
                 f"from {tag}_{name}, " + _first(
                     np, g != w[:, None], g, np.broadcast_to(
                         w[:, None], g.shape)))
    bits = golden[f"{tag}_bits"][valid]
    _require((out.bits[valid] == bits[:, None]).all(),
             f"(k) {what}: the bits of valid frames differ from {tag}")
    _require((timing == golden[f"{tag}_rx_timing"][-1]).all(),
             f"(k) {what}: final rx_timing {np.unique(timing).tolist()}, "
             f"the C {golden[f'{tag}_rx_timing'][-1]}")
    for name in ("max_value", "mean"):
        _require(np.allclose(getattr(out, name),
                             golden[f"{tag}_{name}"][:, None], rtol=1e-3,
                             atol=1e-3), f"(k) {what}: {name} off")


def _faithful_phase(torch, np, golden, dev, here: str, smi_line: str):
    """(k): the faithful RX on the card against the C fixtures and the
    port's CPU runs, then its rates."""
    from singlecarrier_tpu_torch import DEFAULT_CONFIG
    from singlecarrier_tpu_torch.modem import rx_init, rx_stream
    from singlecarrier_tpu_torch.ops import _build

    cfg = DEFAULT_CONFIG
    n = cfg.frame_size
    pcm = golden["tx_pcm"].astype(np.int16)
    nf = len(pcm) // n
    harness = torch.from_numpy(pcm[:nf * n].reshape(nf, 1, n)).to(dev)

    def run(cfg_, frames, C, device=dev, **kw):
        st, out = rx_stream(cfg_, rx_init(cfg_, (C,), device=device),
                            frames.to(device), **kw)
        return st.rx_timing.cpu().numpy(), _host(out)

    _build.reset_launches()
    t0 = time.perf_counter()
    # the C harness's stream on K_CH channels, at 0 Hz and at 20 Hz
    timing, out = run(cfg, harness.expand(-1, K_CH, -1), K_CH)
    _faithful_vs_c(np, out, timing, golden, "rxt", f"{K_CH} channels")
    _, cpu20 = run(cfg, harness.cpu(), 1, "cpu", freq_offset=20.0)
    timing, out = run(cfg, harness.expand(-1, K_CH, -1), K_CH,
                      freq_offset=20.0)
    _faithful_vs_c(np, out, timing, golden, "f20_rxt",
                   f"{K_CH} channels at 20 Hz", matches=cpu20.matches[:, 0])
    knife = np.nonzero(cpu20.matches[:, 0] != golden["f20_rxt_matches"])[0]
    print(f"[faithful] (k) tx_pcm on {K_CH} channels: every channel equals "
          f"rxt_* and f20_rxt_* (valid {int(out.valid[:, 0].sum())} of "
          f"{nf} frames at 20 Hz); matches at 20 Hz equal the port's CPU "
          f"run, which leaves the C at frames {knife.tolist()} "
          f"({cpu20.matches[knife, 0].tolist()} vs the C's "
          f"{golden['f20_rxt_matches'][knife].tolist()}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # delayed channels and the blocked equalizer, against the CPU
    tx = torch.from_numpy(pcm).to(dev)
    nb = -(-(len(pcm) + n) // n) + 1
    offsets = torch.arange(K_CH, device=dev) % n
    frames = _frames(_golden_stream(tx, K_CH, nb * n, offsets, dev),
                     nb, n)
    sub = frames[:, ::K_CH // K_DELAYED]            # delays 0, 235, ..
    _, got = run(cfg, sub, K_DELAYED)
    _, want = run(cfg, sub, K_DELAYED, "cpu")
    odd = _faithful_agree(np, got, want, f"{K_DELAYED} delayed channels")
    print(f"[faithful] (k) {K_DELAYED} channels at delays "
          f"{offsets[::K_CH // K_DELAYED][:3].tolist()}.. on {nb} frames: "
          f"the card equals the CPU ({int(want.valid.sum())} valid, "
          f"{odd} invalid frames' bit rows differ)", flush=True)
    _, got = run(cfg, frames, K_CH, blocked=K_BLOCK)
    _, want = run(cfg, frames, K_CH, "cpu", blocked=K_BLOCK)
    odd = _faithful_agree(np, got, want, f"blocked={K_BLOCK}, {K_CH} ch")
    print(f"[faithful] (k) blocked={K_BLOCK} on {K_CH} channels at delays "
          f"0..{n - 1}, {nb} frames: the card equals the CPU "
          f"({int(want.valid.sum())} valid, {odd} invalid frames' bit rows "
          f"differ)", flush=True)
    del frames, sub, got, want

    # the other numerologies, each on its own TX
    for tag in K_NUMEROLOGIES:
        ncfg = DEFAULT_CONFIG.replace(**_build.NUMEROLOGIES[tag])
        nn = ncfg.frame_size
        ntx = _numerology_tx(ncfg, dev, K_NUM_PACKETS)
        nbk = -(-(ntx.numel() + nn) // nn) + 1
        offs = (torch.arange(K_NUM_CH, device=dev) * nn) // K_NUM_CH
        nfr = _frames(_golden_stream(ntx, K_NUM_CH, nbk * nn, offs,
                                     dev), nbk, nn)
        _, got = run(ncfg, nfr, K_NUM_CH)
        _, want = run(ncfg, nfr, K_NUM_CH, "cpu")
        odd = _faithful_agree(np, got, want, tag)
        _require(want.valid.sum() >= K_NUM_CH, f"(k) {tag}: "
                 f"{int(want.valid.sum())} detections")
        print(f"[faithful] (k) {tag}: {K_NUM_CH} ch x {nbk} frames of "
              f"{K_NUM_PACKETS} packets: the card equals the CPU "
              f"({int(want.valid.sum())} valid, {odd} invalid frames' bit "
              f"rows differ)", flush=True)
    _require(not any(_build.LAUNCHES.values()),
             f"(k) the faithful path launched a kernel: {_build.LAUNCHES}")
    _faithful_timing(torch, np, cfg, dev, here, smi_line)


def _faithful_timing(torch, np, cfg, dev, here: str, smi_line: str):
    """(k)'s rates: K_TIME_FRAMES chained frames of full-scale noise at
    each width of K_TIME_CH, exact and blocked, one synchronize; the
    host's enqueue time; the launches of one frame; peak memory."""
    from singlecarrier_tpu_torch.modem import rx_frame, rx_init, rx_stream

    n = cfg.frame_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for C in K_TIME_CH:
        noise = torch.randint(-16384, 16384, (K_TIME_FRAMES, C, n),
                              generator=gen, device=dev, dtype=torch.int16)
        for blocked in (0, K_BLOCK):
            st, _ = rx_stream(cfg, rx_init(cfg, (C,)), noise[:1],
                              blocked=blocked)                 # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rx_stream(cfg, st, noise, blocked=blocked)
            enqueued = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rate = K_TIME_FRAMES * C * n / wall
            print(f"[timing] (k) faithful rx_stream"
                  f"{f' blocked={blocked}' if blocked else ''} {C} ch x "
                  f"{K_TIME_FRAMES} chained frames: {wall:.3f} s (the host "
                  f"had enqueued it after {enqueued:.3f} s), {rate:.4e} "
                  f"samples/s = {rate / cfg.fs:.1f} real-time channels; "
                  f"peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"{smi_line}", flush=True)
            if C == K_TIME_CH[0]:
                counts = _launches_of(torch, lambda: rx_frame(
                    cfg, st, noise[0], blocked=blocked))
                print(f"[timing] (k) one frame at {C} ch"
                      f"{f', blocked={blocked}' if blocked else ''}: "
                      f"{counts}; {smi_line}", flush=True)
        del noise, st
    for name in K_RECORDS:
        with open(os.path.join(here, name)) as f:
            rec = json.load(f)
        print(f"[timing] (k) TPU history, not a target: {name} "
              f"{rec['metric']} {rec['value']} samples/s on "
              f"{rec['detail']['device']} ({rec['detail']['channels']} ch x "
              f"{rec['detail']['blocks_per_iter']} blocks)", flush=True)


def _launches_of(torch, fn) -> str:
    """The kernel launches and the aten operations of one call of ``fn``
    (``torch.profiler`` and a dispatch counter), as a phrase."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            _Count.ops += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if "LaunchKernel" in e.key)
    on_card = [e for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = (f"{sum(e.count for e in on_card)} device kernels "
               f"({sum(e.self_device_time_total for e in on_card) / 1e3:.1f}"
               f" ms of device time)" if on_card else
               "device kernels not measured (the profiler recorded none)")
    return (f"{launches} kernel launches (the profiler's runtime calls), "
            f"{kernels}, {_Count.ops} aten operations dispatched (views "
            f"included)")


# ---- (l) the runtime layer: native ingest into the main path, the
# streaming demodulator, checkpoint, failover and checks, on the card

L_RATE_B = 16               # blocks a dispatch of the rate runs: 493 MB
L_RATE_DISP = 8             # dispatches of the end-to-end run
L_RING_CH = 64              # channels of the ring-mode run
MAIN_KERNELS = ("frontend_decim", "hunt", "extract_decode")
# The inflight=0 run: each copy waits L_COPY_DELAY SM cycles (0.15 s at
# 1980 MHz) behind a sleeping kernel on the side stream, and the consumer
# spends L_HOST_WAIT seconds on the host after each dispatch's launches
# (as one that reads its results would), so the producer is ahead and
# takes each buffer back the moment it is handed back, copy in flight.
L_COPY_DELAY = 300_000_000
L_HOST_WAIT = 0.1


def _slow_copies(torch, base):
    """``base`` (a ``PrefetchIngest``) whose every copy starts behind a
    kernel that sleeps ``L_COPY_DELAY`` cycles on the side stream: with a
    consumer slower than the producer, each buffer goes back to the
    producer while its copy is still in flight, and only the copy's event
    keeps the producer off it.  (Undelayed, a 154 MB copy takes 3 ms and
    has always finished before the producer's first write.)"""
    class SlowCopies(base):
        def put(self, host):
            with torch.cuda.stream(self._copy_stream):
                torch.cuda._sleep(L_COPY_DELAY)
            return super().put(host)
    return SlowCopies


def _outs_equal(torch, a, b, what: str) -> None:
    """Every output field equal to the bit."""
    for name, x, y in zip(a._fields, a, b):
        _require(x.dtype == y.dtype and torch.equal(x, y),
                 f"{what}: {name} differs")


def _runtime_phase(torch, np, cfg, default, frames, main_out, tx_bits,
                   drive, dev, here: str, smi_line: str) -> None:
    """(l): the runtime layer on the card (``singlecarrier_tpu_torch.
    runtime``).  ``frames`` [20, 8192, 1880] and ``main_out`` are phase 4's
    frames and outputs (two chained dispatches of 10 blocks)."""
    import shutil
    import tempfile

    from singlecarrier_tpu_torch.modem import (
        ProdRxOut, prod_rx_batch, prod_rx_frame, prod_rx_init,
        prod_rx_init_planes, prod_rx_stream)
    from singlecarrier_tpu_torch.runtime import (
        ElasticDemodulator, StreamDemodulator, checkify_step, log_compiles,
        restore_state, save_state, trace)
    from singlecarrier_tpu_torch.runtime import engine
    from singlecarrier_tpu_torch.runtime.ingest import (
        PcmDispatchSource, PrefetchIngest, feed)
    from singlecarrier_tpu_torch.tools import ingest_bench

    t_phase = time.perf_counter()
    n_blocks, C, n = frames.shape
    half = n_blocks // 2

    def cat(outs):
        return ProdRxOut(*(torch.cat(xs) for xs in zip(*outs)))

    # ---- 1. the engine: its own build, transposes at full width ----
    t0 = time.perf_counter()
    lib = engine.load_library()
    t_lib = time.perf_counter() - t0
    host = frames[0].cpu().numpy()
    t0 = time.perf_counter()
    inter = engine.interleave(host)
    t_i = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = engine.deinterleave(inter, C)
    t_d = time.perf_counter() - t0
    _require(np.array_equal(inter, host.T.reshape(-1))
             and np.array_equal(back, host),
             "the engine's transposes differ from numpy's")
    print(f"[runtime] engine {os.path.relpath(lib._name, here)} (built and "
          f"loaded in {t_lib:.2f} s): interleave and deinterleave of "
          f"{C} channels x {n} samples equal numpy's transposes "
          f"({host.nbytes / t_i / 1e9:.2f} and {host.nbytes / t_d / 1e9:.2f}"
          f" GB/s, one thread)", flush=True)
    del host, inter, back

    work = tempfile.mkdtemp(prefix="runtime_", dir=os.path.join(here,
                                                                "build"))
    try:
        # ---- 2. file -> ingest -> the main path, against phase 4 ----
        path = os.path.join(work, "golden.raw")
        frames.transpose(1, 2).contiguous().cpu().numpy().tofile(path)
        ring_path = os.path.join(work, "golden64.raw")
        ring_frames = frames[:, :L_RING_CH].contiguous()
        ring_frames.transpose(1, 2).contiguous().cpu().numpy().tofile(
            ring_path)

        def ingest_run(path_, C_, blocks, n_disp, *, mode="deinterleave",
                       workers=8, ingest_cls=PrefetchIngest, host_wait=0.0,
                       **kw):
            src = PcmDispatchSource(path_, C_, n, blocks, mode=mode,
                                    workers=workers)
            ingest = ingest_cls(src, n_disp, device=dev, **kw)
            outs = []

            def step(state, x):
                state, out = prod_rx_batch(cfg, state, x, descramble=False,
                                           fuse_frontend=True)
                outs.append(out)
                time.sleep(host_wait)
                return state, None

            state, _ = feed(ingest, ingest.put, step,
                            prod_rx_init_planes(cfg, C_))
            torch.cuda.synchronize()
            src.close()
            return state, outs

        def chained(parts, C_):
            state, outs = prod_rx_init_planes(cfg, C_), []
            for part in parts:
                state, out = prod_rx_batch(cfg, state, part,
                                           descramble=False,
                                           fuse_frontend=True)
                outs.append(out)
            return outs

        # one dispatch at this operating point and size first: the main
        # path's constant tables (uploads cached per config, which (i)'s
        # and (j)'s many configs evict) reach the card once, as at a
        # deployment's start, and not inside the profiled run
        prod_rx_batch(cfg, prod_rx_init_planes(cfg, C), frames[:half],
                      descramble=False, fuse_frontend=True)
        trace_dir = os.path.join(work, "trace")
        with log_compiles() as compiles:
            with trace(trace_dir):
                _, outs = drive("runtime ingest", lambda: ingest_run(
                    path, C, half, 2), MAIN_KERNELS)
            _outs_equal(torch, cat(outs), main_out,
                        "ingest (workers=8, depth=2, inflight=2) vs phase 4")
            seen = ingest_bench.h2d_in_trace(trace_dir,
                                             ingest_bench.MAIN_KERNELS)
            print(f"[runtime] file ({os.path.getsize(path) / 1e6:.0f} MB, "
                  f"{n_blocks} blocks x {C} channels interleaved) -> "
                  f"PcmDispatchSource(workers=8) -> PrefetchIngest(depth=2,"
                  f" inflight=2, pinned) -> feed -> prod_rx_batch("
                  f"fuse_frontend=True), 2 dispatches of {half} blocks: "
                  f"every output field equal to phase 4's, to the bit; "
                  f"the profiler: {seen}", flush=True)
            # one spare buffer, each handed back with its copy in flight:
            # 4 dispatches of 5 blocks through 2 buffers, against the main
            # path called directly on the same split
            quarter = n_blocks // 4
            _, outs = drive("runtime ingest inflight=0", lambda: ingest_run(
                path, C, quarter, 4, depth=1, inflight=0,
                ingest_cls=_slow_copies(torch, PrefetchIngest),
                host_wait=L_HOST_WAIT), MAIN_KERNELS)
            ref = chained([frames[k:k + quarter]
                           for k in range(0, n_blocks, quarter)], C)
            _outs_equal(torch, cat(outs), cat(ref),
                        "ingest (depth=1, inflight=0) vs the direct calls")
            _decisions_agree(cat(outs), main_out,
                             "ingest in 4 dispatches vs phase 4's 2")
            _, outs = drive("runtime ingest ring", lambda: ingest_run(
                ring_path, L_RING_CH, half, 2, mode="ring", workers=1),
                MAIN_KERNELS)
            sub = ProdRxOut(*(x[:, :L_RING_CH] for x in main_out))
            _outs_equal(torch, cat(outs), cat(chained(
                (ring_frames[:half], ring_frames[half:]), L_RING_CH)),
                "ring-mode ingest vs the direct calls")
            _outs_equal(torch, cat(outs), sub,
                        f"ring-mode ingest vs phase 4's first {L_RING_CH} "
                        f"channels")
        _require(not compiles, f"the ingest runs compiled: {compiles}")
        print(f"[runtime] depth=1, inflight=0 (2 host buffers, 4 dispatches "
              f"of {quarter} blocks; each copy held {L_COPY_DELAY:,} cycles "
              f"behind a sleeping kernel on the side stream and the "
              f"consumer {L_HOST_WAIT} s on the host a dispatch, so every "
              f"buffer goes back to a waiting producer with its copy in "
              f"flight and is refilled once the copy's event completes): "
              f"every field equal to the main path called "
              f"directly on the same split, decisions equal to phase 4's; "
              f"ring mode at {L_RING_CH} channels: every field equal to the "
              f"direct calls and to phase 4's first {L_RING_CH} channels; "
              f"log_compiles: none in the three runs", flush=True)
        del outs, ref, sub, ring_frames

        # ---- 3. StreamDemodulator (XLA path) against prod_rx_stream ----
        def stream_run():
            demod = StreamDemodulator(default, C, descramble=False)
            return demod, [demod.push(frames[k]) for k in range(n_blocks)]

        t0 = time.perf_counter()
        sd, sd_outs = drive("runtime stream", stream_run, ())
        t_sd = time.perf_counter() - t0
        _, xs = prod_rx_stream(default, prod_rx_init(default, (C,)), frames,
                               descramble=False)
        sd_cat = ProdRxOut(*(torch.stack(x) for x in zip(*sd_outs)))
        _decisions_agree(sd_cat, xs, "StreamDemodulator vs prod_rx_stream")
        bits_too = ("equal to the bit" if all(
            torch.equal(x, y) for x, y in zip(sd_cat, xs))
            else "not all equal to the bit")
        n_dup = _check_packets(torch, [sd_cat], tx_bits, default)
        s = sd.metrics.summary()
        print(f"[runtime] StreamDemodulator(library default) on {C} channels "
              f"x {n_blocks} blocks, pushed one at a time ({t_sd:.2f} s, "
              f"no kernel launched): 10/10 packets on every channel "
              f"({n_dup} seam repeats), decisions equal to prod_rx_stream's"
              f" on the same frames (every field {bits_too}); metrics: "
              f"{s['packets']} "
              f"packets, mean matches {s['mean_matches']:.3f}, mean cfo "
              f"{s['mean_cfo_hz']:.4f} Hz", flush=True)
        del xs, sd

        # ---- 4. checkpoint the plane state between the two dispatches ----
        ckpt = os.path.join(work, "planes.pt")

        def resumed():
            state, out0 = prod_rx_batch(cfg, prod_rx_init_planes(cfg, C),
                                        frames[:half], descramble=False,
                                        fuse_frontend=True)
            save_state(ckpt, state, step=1)
            state, step = restore_state(ckpt,
                                        like=prod_rx_init_planes(cfg, C))
            _require(step == 1 and state[4].dtype == torch.bfloat16
                     and state[4].device == frames.device,
                     "checkpoint: restored state")
            return [out0, prod_rx_batch(cfg, state, frames[half:],
                                        descramble=False,
                                        fuse_frontend=True)[1]]

        outs = drive("runtime checkpoint", resumed, MAIN_KERNELS)
        _outs_equal(torch, cat(outs), main_out, "checkpoint and resume")
        print(f"[runtime] checkpoint: the bf16 plane state at {C} channels "
              f"saved after dispatch 1 ({os.path.getsize(ckpt) / 1e6:.1f} MB,"
              f" torch.load(weights_only=True)), restored onto the card, "
              f"dispatch 2 run from it: every field equal to the unbroken "
              f"run's, to the bit", flush=True)
        del outs

        # ---- 5. ElasticDemodulator: a source fault and a NaN phase ----
        faulted = {"done": False}

        def source(i):
            if i == 5 and not faulted["done"]:
                faulted["done"] = True
                raise IOError("injected transient ingest fault")
            return frames[i]

        def elastic():
            ed = ElasticDemodulator(
                default, C, checkpoint_path=os.path.join(work, "ed.pt"),
                checkpoint_every=4, descramble=False)
            outs = []
            for i in range(n_blocks):
                if i == 9:
                    phase = ed.state.phase.clone()
                    phase[5] = complex(float("nan"), 0.0)
                    ed.state = ed.state._replace(phase=phase)
                outs.append(ed.step(source))
            return ed, outs

        t0 = time.perf_counter()
        ed, outs = drive("runtime elastic", elastic, ())
        t_ed = time.perf_counter() - t0
        _require(ed.recoveries >= 1, "elastic: no recovery")
        for k, (o, ref) in enumerate(zip(outs, sd_outs)):
            _outs_equal(torch, o, ref, f"ElasticDemodulator block {k}")
        print(f"[runtime] ElasticDemodulator on {C} channels x {n_blocks} "
              f"blocks, a source fault at block 5 and a NaN in channel 5's"
              f" phase before block 9: {ed.recoveries} recoveries, every "
              f"output field equal to the clean StreamDemodulator run's "
              f"({t_ed:.2f} s, checkpoints every 4 blocks)", flush=True)
        del ed, outs, sd_outs, sd_cat

        # ---- 6. checkify_step flags a NaN phase on the card ----
        step = checkify_step(lambda st, pcm: prod_rx_frame(
            default, st, pcm, descramble=False))
        st = prod_rx_init(default, (C,))
        step(st, frames[0])
        phase = st.phase.clone()
        phase[3] = complex(float("nan"), 0.0)
        try:
            step(st._replace(phase=phase), frames[0])
            flagged = ""
        except FloatingPointError as e:
            flagged = str(e)
        _require("phase" in flagged, f"checkify_step: {flagged!r}")
        print(f"[runtime] checkify_step on the card: a clean step passes, a "
              f"NaN phase raises '{flagged}'", flush=True)
        del st, phase

        # ---- 7. rates: a file of full-scale noise, looped ----
        ingest_bench.rates(cfg, work, C, L_RATE_B, L_RATE_DISP, dev,
                           smi_line, L_RING_CH)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[runtime] (l) {time.perf_counter() - t_phase:.1f} s; "
          f"{smi_line}", flush=True)


# ---- (m) the multi-device layer (singlecarrier_tpu_torch.parallel): a
# one-rank NCCL group, the time shards in one process, two gloo processes
# on the one card (NCCL takes one rank a card)

M_WORLD = 2             # (m) 3: gloo processes, both on card 0
M_SHARDS = (2, 4)       # (m) 2: time shards of phase 4's frames
M_RATE_SHARDS = 4       # (m) 4: time shards of the timed in-process grid
M_EXCHANGES = 10        # (m) 4: timed halo exchanges of the gloo run
M_PATH = ("frontend_decim", "hunt", "extract_decode")


def _parallel_phase(torch, cfg, frames, main_out, tx_bits, drive, dev,
                    here: str, smi_line: str) -> None:
    """(m) the multi-device layer on the one card (``frames`` [20, 8192,
    1880] and ``main_out`` are phase 4's): 1. a one-rank NCCL group, the
    fused sharded path, ``metrics_summary`` and the sharded checkpoint;
    2. the time shards in one process; 3. two gloo processes on card 0;
    4. the rates."""
    import shutil

    import torch.distributed as dist
    from singlecarrier_tpu_torch.modem import (ProdRxOut, prod_rx_batch,
                                               prod_rx_init_planes)
    from singlecarrier_tpu_torch.parallel import (make_fused_sharded_rx,
                                                  make_mesh, metrics_summary,
                                                  shard_plane_state)
    from singlecarrier_tpu_torch.runtime import restore_sharded, save_sharded
    from singlecarrier_tpu_torch.tools import scaling_bench
    from singlecarrier_tpu_torch.tools._measure import wall as timed
    t_phase = time.perf_counter()
    B, C = frames.shape[0] // 2, frames.shape[1]
    n = cfg.frame_size
    halves = (frames[:B], frames[B:])
    work = os.path.join(here, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(SEED + 13)
    noise = torch.randint(-16384, 16384, (B_TIME, C, n), generator=mgen,
                          device=dev, dtype=torch.int16)
    samples = ITERS * B_TIME * C * n
    try:
        # ---- 1. a one-rank NCCL group on a tcp://127.0.0.1 store ----
        mesh = make_mesh()
        try:
            _require(dist.get_backend() == "nccl"
                     and dist.get_world_size() == 1,
                     f"(m) make_mesh() made a {dist.get_backend()} group of "
                     f"{dist.get_world_size()}")
            fn = make_fused_sharded_rx(cfg, mesh, descramble=False)

            def chained_with(f, state, parts):
                outs = []
                for part in parts:
                    state, out = f(state, part)
                    outs.append(out)
                return state, outs

            _, outs = drive("(m) make_fused_sharded_rx, one NCCL rank",
                            lambda: chained_with(fn, shard_plane_state(
                                prod_rx_init_planes(cfg, C), mesh), halves),
                            M_PATH)
            sharded = scaling_bench.cat_outs(outs)
            _outs_equal(torch, sharded, main_out,
                        "(m) one-rank fused sharded path vs phase 4")
            print(f"[parallel] (m) 1. make_fused_sharded_rx on a one-rank "
                  f"NCCL group (tcp://127.0.0.1), {C} channels x 2 "
                  f"dispatches x {B} blocks: every output field equal to "
                  f"phase 4's, to the bit", flush=True)
            ffn = make_fused_sharded_rx(cfg, mesh, descramble=False,
                                        fuse_frontend=False)
            _, outs = drive(
                "(m) make_fused_sharded_rx(fuse_frontend=False), one NCCL "
                "rank", lambda: chained_with(ffn, shard_plane_state(
                    prod_rx_init_planes(cfg, C), mesh), halves),
                ("frontend_rows", "hunt", "extract_decode"))
            _decisions_agree(scaling_bench.cat_outs(outs), main_out,
                             "(m) one-rank two-kernel sharded path vs "
                             "phase 4")
            print(f"[parallel] (m) 1. make_fused_sharded_rx(fuse_frontend="
                  f"False), the same: decisions equal to phase 4's (valid, "
                  f"bits, lag, phase; |dcfo| < 0.5 Hz, |deq| < 2e-3)",
                  flush=True)

            m = metrics_summary(sharded, mesh.get_group("ch"))
            v = main_out.valid
            zero = torch.zeros((), device=dev)
            local = torch.stack([
                v.sum().double(),
                torch.where(v, main_out.cfo_hz, zero).double().sum(),
                torch.where(v, main_out.eq_error, zero).double().sum()])
            want = (int(local[0]), float(local[1] / local[0]),
                    float(local[2] / local[0]))
            got = (int(m["packets_detected"]), float(m["mean_cfo_hz"]),
                   float(m["mean_eq_error"]))
            _require(got == want, f"(m) metrics_summary {got} != the local "
                     f"reduction {want}")
            print(f"[parallel] (m) 1. metrics_summary through NCCL: "
                  f"{got[0]} packets, mean cfo {got[1]:.6e} Hz, mean "
                  f"eq_error {got[2]:.6e}: equal to the local reduction",
                  flush=True)

            st, first = fn(shard_plane_state(prod_rx_init_planes(cfg, C),
                                             mesh), halves[0])
            ck = os.path.join(work, "planes")
            ck_s = timed(lambda: save_sharded(ck, st, step=B))
            t0 = time.perf_counter()
            back, step = restore_sharded(ck, st)
            torch.cuda.synchronize()
            rs_s = time.perf_counter() - t0
            _require(step == B and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(back, st)), "(m) restore_sharded differs")
            _, second = fn(back, halves[1])
            _outs_equal(torch, scaling_bench.cat_outs([first, second]),
                        main_out, "(m) sharded checkpoint resume vs phase 4")
            ck_mb = sum(os.path.getsize(os.path.join(ck, f))
                        for f in os.listdir(ck)) / 1e6
            print(f"[parallel] (m) 1. save_sharded / restore_sharded of "
                  f"the plane state between the dispatches ({ck_mb:.1f} MB,"
                  f" saved in {ck_s:.2f} s, restored in {rs_s:.2f} s): "
                  f"resumed equal to phase 4 to the bit", flush=True)
            del sharded, outs, first, second, back, st

            # ---- 4a. the main path and the one-rank path, in turns ----
            tfn = make_fused_sharded_rx(cfg, mesh)

            def main_path():
                st_ = prod_rx_init_planes(cfg, C)
                for _ in range(ITERS):
                    st_, _ = prod_rx_batch(cfg, st_, noise,
                                           fuse_frontend=True)

            def one_rank():
                st_ = shard_plane_state(prod_rx_init_planes(cfg, C), mesh)
                for _ in range(ITERS):
                    st_, _ = tfn(st_, noise)

            prod_rx_batch(cfg, prod_rx_init_planes(cfg, C), noise,
                          fuse_frontend=True)                  # warm-up
            tfn(shard_plane_state(prod_rx_init_planes(cfg, C), mesh), noise)
            walls = {"main": [], "one": []}
            for tag, f in (("main", main_path), ("one", one_rank),
                           ("one", one_rank), ("main", main_path)):
                walls[tag].append(timed(f))
        finally:
            dist.destroy_process_group()
        _require(not dist.is_initialized(), "(m) a process group is left")
        r_main = [samples / w for w in walls["main"]]
        r_one = [samples / w for w in walls["one"]]
        print(f"[parallel] (m) 4. {C} ch x {B_TIME} blocks x {ITERS} chained "
              f"dispatches of noise, in the order main, sharded, sharded, "
              f"main: the main path {r_main[0]:.4e} / {r_main[1]:.4e}, the "
              f"one-rank make_fused_sharded_rx {r_one[0]:.4e} / "
              f"{r_one[1]:.4e} samples/s ({100 * sum(r_one) / sum(r_main):.1f}"
              f"% of the main path); {smi_line}", flush=True)

        # ---- 2. the time shards in one process ----
        grid2 = None
        for n_t in M_SHARDS:
            outs = drive(f"(m) _grid_shard x {n_t} in one process",
                         lambda: scaling_bench.grid(cfg, frames, n_t), M_PATH)
            g = scaling_bench.cat_outs(outs)
            _decisions_agree(g, main_out, f"(m) {n_t} time shards vs "
                             f"phase 4")
            n_dup = _check_packets(torch, outs, tx_bits, cfg)
            print(f"[parallel] (m) 2. _grid_shard for each of {n_t} time "
                  f"shards of phase 4's {2 * B} blocks, {C} channels, in one "
                  f"process: decisions equal to phase 4's across every seam "
                  f"(valid, bits, lag, phase; |dcfo| < 0.5 Hz, |deq| < "
                  f"2e-3), 10/10 golden packets on every channel ({n_dup} "
                  f"seam repeats)", flush=True)
            if n_t == M_WORLD:
                grid2 = g
            del outs, g

        # ---- 3. two gloo processes on card 0 ----
        t0 = time.perf_counter()
        ranks = scaling_bench.gloo_ranks(work, {
            "world": M_WORLD, "golden": os.path.join(
                here, "tests", "golden", "reference.npz"),
            "golden_channels": C, "golden_blocks": B,
            "rate_blocks": B_TIME, "rate_channels": C // M_WORLD,
            "iters": ITERS, "exchanges": M_EXCHANGES})
        c_half = C // M_WORLD
        for r, res in enumerate(ranks):
            want = ProdRxOut(*(x[r * B:(r + 1) * B, :c_half] for x in grid2))
            _outs_equal(torch, ProdRxOut(*(x.to(dev) for x in res["grid"])),
                        want, f"(m) gloo grid, rank {r}, vs (m) 2")
            want = ProdRxOut(*(x[:, r * c_half:(r + 1) * c_half]
                               for x in main_out))
            _outs_equal(torch, ProdRxOut(*(x.to(dev) for x in res["fused"])),
                        want, f"(m) gloo fused sharded, rank {r}, vs phase 4")
            lc = res["launches"]
            _require(all(lc[k] > 0 for k in M_PATH)
                     and all(v == 0 for k, v in lc.items()
                             if k not in M_PATH),
                     f"(m) gloo rank {r} launches: {lc}")
            print(f"[parallel] (m) 3. gloo rank {r} of {M_WORLD} on "
                  f"cuda:0: make_fused_grid_sharded_rx (ch=1, time=2) on "
                  f"{c_half} channels, its {B} blocks equal to (m) 2's to "
                  f"the bit; make_fused_sharded_rx (ch=2), its {c_half} "
                  f"channels equal to phase 4's to the bit; launches {lc}",
                  flush=True)
        wall = max(res["wall"] for res in ranks)
        gloo_rate = ITERS * B_TIME * c_half * n / wall
        xch = [res["exchange_s"] for res in ranks]
        print(f"[parallel] (m) 4. two gloo ranks on cuda:0, "
              f"make_fused_grid_sharded_rx (ch=1, time=2), {c_half} ch x "
              f"{B_TIME} blocks x {ITERS} dispatches of noise: "
              f"{gloo_rate:.4e} samples/s combined ({wall:.3f} s); the halo "
              f"exchange alone ({ranks[0]['exchange_bytes'] / 1e6:.1f} MB "
              f"through host buffers) {1e3 * xch[0]:.2f} ms sending, "
              f"{1e3 * xch[1]:.2f} ms receiving a dispatch; (m) 3 took "
              f"{time.perf_counter() - t0:.1f} s with the processes' start; "
              f"{smi_line}", flush=True)
        del ranks, grid2

        # ---- 4b. the in-process grid at M_RATE_SHARDS shards ----
        scaling_bench.grid(cfg, noise, M_RATE_SHARDS, True)       # warm-up
        w = timed(lambda: [scaling_bench.grid(cfg, noise, M_RATE_SHARDS,
                                              True) for _ in range(ITERS)])
        print(f"[parallel] (m) 4. _grid_shard x {M_RATE_SHARDS} in one "
              f"process (each shard {B_TIME // M_RATE_SHARDS} blocks + the "
              f"halo block), {C} ch x {B_TIME} blocks x {ITERS} dispatches "
              f"of noise: {samples / w:.4e} samples/s "
              f"({100 * samples / w / (sum(r_main) / 2):.1f}% of the main "
              f"path above); {smi_line}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[parallel] (m) {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- (n) the tools (singlecarrier_tpu_torch.tools): each one's main at a
# reduced size, its record checked

def _run_tool(module, argv) -> str:
    """``module.main(argv)`` in this process; it must return 0.  Returns
    what it printed (also echoed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    print(buf.getvalue(), end="", flush=True)
    _require(rc == 0, f"(n) {module.__name__} {' '.join(argv)}: rc {rc}")
    return buf.getvalue()


def _last_json(printed: str) -> dict:
    return json.loads(printed.strip().splitlines()[-1])


def _tools_phase(here: str, smi_line: str) -> None:
    """(n): ``parity`` (one config, 128 channels), ``detection`` (8192 x 16
    noise blocks, one Pd point), ``roofline`` (the ten kernels at 32,768
    rows), ``profile_stages`` (the one-kernel prefixes), both gated
    benches (8192 x 8), ``ingest_bench`` (two dispatches) and
    ``scaling_bench`` (the one-rank path and two shards), each writing
    into ``build/chip_smoke_tools``.  Each record must parse and name the
    card; every Wilson interval must hold its estimate; no share may
    exceed 100%; parity must report ok."""
    import shutil

    from singlecarrier_tpu_torch.tools import (
        detection, gated_decode_bench, gated_wrapper_bench, ingest_bench,
        parity, profile_stages, roofline, scaling_bench)
    t_phase = time.perf_counter()
    work = os.path.join(here, "build", "chip_smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def out(name):
        return os.path.join(work, name)

    def record(path):
        with open(path) as f:
            text = f.read()
        _require(smi_line in text, f"(n) {path} does not name the card "
                 f"({smi_line})")
        return json.loads(text) if path.endswith(".json") else text

    t0, took = time.perf_counter(), {}

    def lap(name):
        nonlocal t0
        took[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    try:
        _run_tool(parity, ["--channels", "128", "--out",
                           out("PARITY_GPU.json")])
        rec = record(out("PARITY_GPU.json"))
        _require(rec["ok"] and all(r["ok"] for r in rec["paths"].values()),
                 f"(n) parity: {rec}")
        lap("parity")
        _run_tool(detection, ["--noise-blocks", "16", "--snrs", "6",
                              "--cfos", "20", "--out", out("DETECTION.json"),
                              "--md", out("DETECTION.md")])
        rec = record(out("DETECTION.json"))
        record(out("DETECTION.md"))
        ests = [(r["pfa"], r["pfa_ci95"]) for rows in rec["pfa"].values()
                for r in rows.values()]
        ests += [(r["pd"], r["pd_ci95"]) for pts in rec["pd"].values()
                 for row in pts.values() for r in row.values()]
        _require(all(lo <= e <= hi for e, (lo, hi) in ests),
                 f"(n) detection: a Wilson interval misses its estimate")
        lap("detection")
        line = _last_json(_run_tool(roofline, [
            "--blocks", "4", "--out", out("ROOFLINE.md")]))
        md = record(out("ROOFLINE.md"))
        shares = [r["share"] for r in line["rows"]] + [
            line["main_path"]["share"]]
        _require(line["card"] == smi_line and len(line["rows"]) == 12
                 and all(0 < s <= 1.0 for s in shares)
                 and sum(r.startswith("| `")
                         for r in md.splitlines()) == 12,
                 f"(n) roofline: shares {shares}")
        lap("roofline")
        line = _last_json(_run_tool(profile_stages, [
            "--one-kernel", "--channels", "8192", "--blocks", "16",
            "--iters", "3"]))
        us = line["us_per_block_channel"]
        _require(line["card"] == smi_line
                 and 0 < us["fe"] < us["hunt"] < us["full"],
                 f"(n) profile_stages: {line}")
        lap("profile_stages")
        _run_tool(gated_decode_bench, [
            "--blocks", "8", "--iters", "3", "--subset-fracs", "0.01,1.0",
            "--out", out("GATED_DECODE.json")])
        rec = record(out("GATED_DECODE.json"))
        _require(rec["verify"]["mismatched"] == 0
                 and rec["t_gate_s"] < rec["t_full_s"],
                 f"(n) gated_decode_bench: {rec}")
        _run_tool(gated_wrapper_bench, [
            "--blocks", "8", "--iters", "3", "--out",
            out("GATED_WRAPPER.json")])
        rec = record(out("GATED_WRAPPER.json"))
        _require(all(c["wrapper_GSps"] > 0
                     for c in rec["capacities"].values()),
                 f"(n) gated_wrapper_bench: {rec}")
        lap("gated benches")
        _run_tool(ingest_bench, ["--dispatches", "2", "--out",
                                 out("BENCH_INGEST.json")])
        rec = record(out("BENCH_INGEST.json"))
        _require(rec["end_to_end_samples_per_sec"] > 0,
                 f"(n) ingest_bench: {rec}")
        lap("ingest_bench")
        line = _last_json(_run_tool(scaling_bench, [
            "--sizes", "8192x16", "--shards", "2", "--no-gloo", "--out",
            out("SCALING.md")]))
        record(out("SCALING.md"))
        rows = line["sizes"]["8192x16"]["rows"]
        _require(line["card"] == smi_line and len(rows) == 3
                 and line["more_than_one_card"].startswith("not measured"),
                 f"(n) scaling_bench: {line}")
        lap("scaling_bench")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[tools] (n) every tool ran on the card and its record names "
          f"it; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in
                                       took.items())
          + f"; (n) {time.perf_counter() - t_phase:.1f} s; {smi_line}",
          flush=True)


def main() -> int:
    t_script = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        if _INCOMPLETE is not None:
            raise _INCOMPLETE
        from singlecarrier_tpu_torch import DEFAULT_CONFIG
        from singlecarrier_tpu_torch.modem import (
            ProdRxOut, dibits_to_bits, prod_rx_batch, prod_rx_batch_gated,
            prod_rx_gated_init, prod_rx_init, prod_rx_init_planes,
            prod_rx_stream, prod_rx_stream_pallas)
        from singlecarrier_tpu_torch.modem.rx_gated import _pair_operands
        from singlecarrier_tpu_torch.modem.rx_production import (
            _extract_packet, _hunt, _train_and_decode, prod_rx_frame)
        from singlecarrier_tpu_torch.ops import _build
        from singlecarrier_tpu_torch.ops.decode import (
            extract_decode, extract_gate, fused_decode, hunt)
        from singlecarrier_tpu_torch.ops.frontend import (
            frontend_decim, frontend_full, frontend_rows, fused_frontend)
        from singlecarrier_tpu_torch.ops.fused_rx import fused_rx_block
        golden = np.load(os.path.join(here, "tests", "golden",
                                      "reference.npz"))
        _ber_record(os.path.join(here, BER_RECORD))
    except (ImportError, OSError) as e:
        print(f"chip_smoke: the repository is incomplete: {e}",
              file=sys.stderr)
        return 1
    # the plain versions' f32 matmuls must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}; "
          f"{smi_line}", flush=True)

    cfg = DEFAULT_CONFIG.replace(decim_dtype="bf16", hunt_dtype="int8",
                                 ls_refit_symbols=128)
    n = cfg.frame_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tx = torch.from_numpy(golden["tx_pcm"].astype(np.int16)).to(dev)
    tx_bits = torch.from_numpy(golden["tx_bits"].reshape(10, -1)).to(dev)

    # ---- 2. build ----
    # every library on one pool, the reference geometry's first, then
    # those of more than 7 taps (the slowest), the long and the wide
    # ones: (j)'s a named numerology, (o)'s and (p)'s, built while phases
    # 3 to (p) run
    t0 = time.perf_counter()
    num_cfgs = {tag: DEFAULT_CONFIG.replace(**kw) for tag, kw
                in _build.NUMEROLOGIES.items()}
    edge_cfgs = {tag: DEFAULT_CONFIG.replace(**kw) for tag, kw
                 in EDGE_GEOMETRIES.items()}
    cli_cfg = DEFAULT_CONFIG.replace(**CLI_LONG)
    ref_build = _start_builds({"ref": DEFAULT_CONFIG})["ref"]
    every = sorted([*num_cfgs.items(), *edge_cfgs.items(),
                    ("cli", cli_cfg)],
                   key=lambda kv: (kv[1].eq_length <= 7,
                                   not _build.is_long(kv[1]),
                                   not _build.is_wide(kv[1])))
    queued = _start_builds(dict(every))
    builds = {tag: queued[tag] for tag in num_cfgs}
    edge_builds = {tag: queued[tag] for tag in edge_cfgs}
    _, log = ref_build.result()
    path = _build.build()[0]
    _build.load()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s "
          f"({BUILD_WORKERS} libraries at once)", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build]   {line.strip()}")
    ptxas_full = _ptxas_of(log, "frontend_full_kernel")

    # ---- 3. kernels vs plain, on the card ----
    def _inputs(cfg_, C, B):
        return _kernel_inputs(gen, tx, cfg_, C, B, dev)

    default = DEFAULT_CONFIG
    _compare_kernels(torch, default, _inputs(default, C_CMP, B_CMP),
                     "library default")
    report = _compare_kernels(torch, cfg, _inputs(cfg, C_CMP, B_CMP),
                              "bench operating point")
    # a row count no block size divides: the last hunt block has three
    # of its four warps live, the last decode block seven of eight
    _compare_kernels(torch, cfg, _inputs(cfg, 5, 3),
                     "bench operating point, 5 channels x 3 blocks")
    # the decimating front-ends on the whole int16 range, both plane dtypes
    for what, cfg_ in (("library default", default),
                       ("bench operating point", cfg)):
        inputs = _inputs(cfg_, C_MAIN, B_KTIME)
        _compare_decimating(torch, cfg_, inputs, f"{what}, {C_MAIN} x "
                            f"{B_KTIME}", gen)
        _compare_full_on_noise(torch, cfg_, inputs, gen,
                               f"{what}, {C_MAIN} x {B_KTIME}")
        del inputs
    # the hunt on full-scale noise, where a reordered sum or a tie-rule
    # slip would show: every row's lag and phase
    for what, cfg_ in (("library default", default),
                       ("bench operating point", cfg),
                       ("int8 operand on f32 planes",
                        default.replace(hunt_dtype="int8"))):
        pcm, p0r, p0i, t0r, t0i, adv, dprev0 = _inputs(cfg_, C_MAIN, B_KTIME)
        pcm = torch.randint(-16384, 16384, pcm.shape, generator=gen,
                            device=dev, dtype=torch.int16)
        dk = frontend_decim(cfg_, pcm, p0r, p0i, t0r, t0i, adv)
        _compare_hunt(torch, cfg_, dk, dprev0,
                      f"{what}, {C_MAIN} x {B_KTIME} rows of noise")
        del pcm, dk, dprev0
    # the hunt on NaN windows (a corrupted or restored state), by the JAX
    # kernel's rule: every operand mode and statistic
    for what, cfg_ in (("bench operating point", cfg),
                       ("bench, hunt_norm none", cfg.replace(
                           hunt_norm="none")),
                       ("bench, hunt_norm energy", cfg.replace(
                           hunt_norm="energy")),
                       ("library default", default),
                       ("library default, hunt_norm none", default.replace(
                           hunt_norm="none")),
                       ("f32 operand", default.replace(hunt_dtype="f32"))):
        _compare_hunt_nan(torch, cfg_, _inputs(cfg_, C_CMP, B_CMP), what)

    # ---- 4. main path ----
    def _drive(what, fn, expect):
        """Run ``fn`` with the launch counters at 0 just before and read
        just after; every kernel in ``expect`` must have been launched."""
        _build.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        print(f"[{what}] launches: {counts}", flush=True)
        _require(all(counts[k] > 0 for k in expect),
                 f"{what}: a kernel of the path was never launched: "
                 f"{counts}")
        _require(all(v == 0 for k, v in counts.items() if k not in expect),
                 f"{what}: a kernel outside the path was launched: {counts}")
        for k, v in counts.items():
            path_launches[k] = path_launches.get(k, 0) + v
        return res

    def _chained(state, parts, cfg_=cfg, **kw):
        outs = []
        for part in parts:
            state, out = prod_rx_batch(cfg_, state, part, descramble=False,
                                       **kw)
            outs.append(out)
        return outs

    def _finite(outs, what):
        for o in outs:
            _require(bool(torch.isfinite(o.eq_error).all()
                          and torch.isfinite(o.cfo_hz).all()
                          and torch.isfinite(o.peak).all()),
                     f"{what}: non-finite outputs")

    def _cat(outs):
        return ProdRxOut(*(torch.cat(xs) for xs in zip(*outs)))

    path_launches = {}
    offsets = torch.arange(C_MAIN, device=dev) % n
    stream = _golden_stream(tx, C_MAIN, 2 * B_MAIN * n, offsets, dev)
    frames = _frames(stream, 2 * B_MAIN, n)
    halves = (frames[:B_MAIN], frames[B_MAIN:])
    outs = _drive("main", lambda: _chained(
        prod_rx_init_planes(cfg, C_MAIN), halves, fuse_frontend=True),
        ("frontend_decim", "hunt", "extract_decode"))
    _finite(outs, "main")
    n_dup = _check_packets(torch, outs, tx_bits, cfg)
    print(f"[main] {C_MAIN} channels x 2 dispatches x {B_MAIN} blocks: "
          f"10/10 packets on every channel, bits exact except the "
          f"TX-truncated last 10 of each packet; {n_dup} channels also "
          f"detect one packet twice across a block seam (the JAX "
          f"package's behaviour at those offsets)", flush=True)

    ref_state = prod_rx_init_planes(cfg, N_REF_CH, "cpu")
    for k, part in enumerate(halves):
        ref_state, ref = prod_rx_batch(
            cfg, ref_state, part[:, :N_REF_CH].cpu(), descramble=False,
            fuse_frontend=True)
        sub = type(outs[k])(*(x[:, :N_REF_CH].cpu() for x in outs[k]))
        _decisions_agree(sub, ref, f"main path vs CPU plain, dispatch {k}")
    print(f"[main] first {N_REF_CH} channels agree with the CPU plain "
          f"path (valid, bits, lag, phase; |dcfo| < 0.5 Hz, |deq| < 2e-3)",
          flush=True)
    main_out = _cat(outs)

    # ---- 5. the other paths, same frames, same width ----
    outs = _drive("paths a", lambda: _chained(
        prod_rx_init_planes(cfg, C_MAIN), halves),
        ("frontend_rows", "hunt", "extract_decode"))
    _finite(outs, "paths a")
    n_dup_a = _check_packets(torch, outs, tx_bits, cfg)
    out_a = _cat(outs)
    _decisions_agree(out_a, main_out, "two-kernel batch path vs main path")
    print(f"[paths] (a) prod_rx_batch(fuse_frontend=False), plane state, "
          f"{C_MAIN} channels x 2 dispatches x {B_MAIN} blocks: 10/10 "
          f"packets on every channel ({n_dup_a} seam repeats), decisions "
          f"equal to the main path's (valid, bits, lag, phase; |dcfo| < "
          f"0.5 Hz, |deq| < 2e-3)", flush=True)
    # host PCM with the state on the card runs on the card
    _, host_out = prod_rx_batch(cfg, prod_rx_init_planes(cfg, N_REF_CH),
                                frames[:2, :N_REF_CH].cpu(),
                                descramble=False)
    _require(host_out.valid.is_cuda and torch.equal(
        host_out.valid, out_a.valid[:2, :N_REF_CH]),
        "host PCM with a state on the card did not run on the card")

    st_b, out_b = _drive("paths b", lambda: prod_rx_stream_pallas(
        cfg, prod_rx_init(cfg, (C_MAIN,)), frames, descramble=False),
        ("frontend_rows", "hunt", "extract_decode"))
    _finite([out_b], "paths b")
    _require(st_b.decim_prev.dtype == torch.complex64
             and st_b.phase.is_cuda, "paths b: bad final state")
    n_dup_b = _check_packets(torch, [out_b], tx_bits, cfg)
    _decisions_agree(out_b, out_a, "streaming path vs two-kernel batch path")
    print(f"[paths] (b) prod_rx_stream_pallas, ProdRxState, {C_MAIN} "
          f"channels x {2 * B_MAIN} blocks one at a time: 10/10 packets on "
          f"every channel ({n_dup_b} seam repeats), decisions equal to "
          f"(a)'s", flush=True)

    few = frames[:B_UNFUSED]
    _, out_x = _drive("paths c1", lambda: prod_rx_batch(
        cfg, prod_rx_init(cfg, (C_MAIN,)), few, descramble=False,
        fuse_hunt=False), ("frontend_rows", "decode_extract"))
    _, out_u = _drive("paths c2", lambda: prod_rx_batch(
        cfg, prod_rx_init(cfg, (C_MAIN,)), few, descramble=False,
        fuse_hunt=False, fuse_extract=False),
        ("frontend_rows", "decode_packets"))
    _finite([out_x, out_u], "paths c")
    _decisions_agree(out_x, out_u, "fuse_hunt=False vs fuse_extract=False")
    sub_a = ProdRxOut(*(x[:B_UNFUSED] for x in out_a))
    _decisions_agree(out_x, sub_a, "unfused paths vs two-kernel batch path",
                     stats=False)
    print(f"[paths] (c) fuse_hunt=False and fuse_extract=False, "
          f"ProdRxState, {C_MAIN} channels x {B_UNFUSED} blocks: "
          f"{int(out_x.valid.sum())} packets, decisions equal to each "
          f"other and (valid, bits; lag and phase on detected blocks) to "
          f"(a)'s, which reads bf16 planes where these read f32",
          flush=True)
    # ---- (d) both batch paths with the mixer folded ----
    fold = cfg.replace(mixer_fold=True)
    for tag, fuse, kern in (("d1", True, "frontend_decim_folded"),
                            ("d2", False, "frontend_rows_folded")):
        outs = _drive(f"paths {tag}", lambda: _chained(
            prod_rx_init_planes(fold, C_MAIN), halves, fold,
            fuse_frontend=fuse), (kern, "hunt", "extract_decode"))
        _finite(outs, f"paths {tag}")
        n_dup_d = _check_packets(torch, outs, tx_bits, cfg)
        _decisions_agree(_cat(outs), main_out, f"mixer_fold=True, "
                         f"fuse_frontend={fuse} vs the premix main path")
        print(f"[paths] (d) prod_rx_batch(fuse_frontend={fuse}) with "
              f"mixer_fold=True, {C_MAIN} channels x 2 dispatches x "
              f"{B_MAIN} blocks: 10/10 packets on every channel "
              f"({n_dup_d} seam repeats), decisions equal to the premix "
              f"main path's (valid, bits, lag, phase; |dcfo| < 0.5 Hz, "
              f"|deq| < 2e-3)", flush=True)

    # ---- (e) the gated two-phase RX against the full path ----
    golden_ch = torch.arange(C_MAIN, device=dev) % GOLDEN_EVERY == 0
    gframes = torch.randint(-16384, 16384, frames.shape, generator=gen,
                            device=dev, dtype=torch.int16)
    gframes = torch.where(golden_ch[None, :, None], frames, gframes)
    ghalves = (gframes[:B_MAIN], gframes[B_MAIN:])
    st = prod_rx_init_planes(cfg, C_MAIN)
    full_decs = []
    for part in ghalves:            # the full path, with its gate column
        dec, dlast, fin = fused_rx_block(cfg, part, *st, descramble=False)
        st = (fin[0], fin[1], fin[2], fin[3], dlast)
        full_decs.append(dec)

    def _gated(K, parts):
        gst, outs = prod_rx_gated_init(cfg, C_MAIN), []
        for part in parts:
            gst, out = prod_rx_batch_gated(cfg, gst, part, max_detections=K,
                                           descramble=False)
            outs.append(out)
        return outs

    gouts = _drive("paths e", lambda: _gated(K_GATED, ghalves),
                   ("frontend_decim", "hunt", "extract_gate",
                    "extract_decode"))
    n_rows = 0
    for k, (out, dec) in enumerate(zip(gouts, full_decs)):
        hits = torch.nonzero(dec["gated"])[:, 0]
        count = int(out["count"])
        _require(count == hits.numel() and 0 < count <= K_GATED,
                 f"paths e, dispatch {k}: count {count}, the full path "
                 f"gates {hits.numel()} rows (capacity {K_GATED})")
        flat = (out["block_idx"].long() * C_MAIN
                + out["channel_idx"].long())[:count]
        _require(torch.equal(flat, hits), f"paths e, dispatch {k}: the "
                 f"compacted rows are not the gated rows in stream order")
        fvalid = dec["gated"] & (dec["matches"] > cfg.match_threshold)
        _require(torch.equal(out["valid"][:count], fvalid[flat])
                 and not bool(out["valid"][count:].any()),
                 f"paths e, dispatch {k}: valid differs from the full path")
        v = out["valid"][:count]
        rows_ = flat[v]
        _require(torch.equal(out["bits"][:count][v],
                             dibits_to_bits(dec["dibits"][rows_]))
                 and torch.equal(out["lag"][:count][v], dec["lag"][rows_])
                 and torch.equal(out["timing_phase"][:count][v],
                                 dec["phase_idx"][rows_]),
                 f"paths e, dispatch {k}: bits, lag or phase of a "
                 f"compacted row differ from the full path's")
        n_rows += int(v.sum())
    seam = gouts[1]["valid"] & (gouts[1]["block_idx"] == 0)
    _require(bool(seam.any()), "paths e: no detection in block 0 of the "
             "second dispatch")
    n_golden = int(golden_ch.sum())
    _require(n_rows >= 10 * n_golden, f"paths e: {n_rows} packets on "
             f"{n_golden} golden channels")
    print(f"[paths] (e) prod_rx_batch_gated, {C_MAIN} channels ({n_golden} "
          f"golden, the rest full-scale noise) x 2 dispatches x {B_MAIN} "
          f"blocks, max_detections={K_GATED}: counts "
          f"{[int(o['count']) for o in gouts]} equal to the full path's "
          f"gated rows, compacted in stream order; {n_rows} valid rows "
          f"with bits, lag and phase equal to the full path's, "
          f"{int(seam.sum())} of them in block 0 of the second dispatch",
          flush=True)
    small = _gated(K_SMALL, ghalves[:1])[0]
    _require(int(small["count"]) == int(gouts[0]["count"]) > K_SMALL
             and int(small["valid"].sum()) <= K_SMALL
             and torch.equal(small["valid"], gouts[0]["valid"][:K_SMALL]),
             f"paths e: capacity {K_SMALL} did not report its overflow")
    print(f"[paths] (e) max_detections={K_SMALL}: count "
          f"{int(small['count'])} > capacity, the first {K_SMALL} rows as "
          f"before", flush=True)
    del gframes, ghalves, full_decs, gouts, small, st, dec, dlast

    # ---- (f) the fractional-timing streaming RX ----
    fcfg = cfg.replace(frac_timing=True)
    st_f, out_f = _drive("paths f", lambda: prod_rx_stream_pallas(
        fcfg, prod_rx_init(fcfg, (C_MAIN,)), frames, descramble=False),
        ("frontend_full", "decode_packets"))
    _finite([out_f], "paths f")
    _require(st_f.decim_prev.dtype == torch.complex64
             and st_f.phase.is_cuda, "paths f: bad final state")
    n_dup_f = _check_packets(torch, [out_f], tx_bits, cfg)
    _, ref_f = prod_rx_stream_pallas(
        fcfg, prod_rx_init(fcfg, (N_REF_CH,), "cpu"),
        frames[:, :N_REF_CH].cpu(), descramble=False)
    sub = ProdRxOut(*(x[:, :N_REF_CH].cpu() for x in out_f))
    _decisions_agree(sub, ref_f, "frac streaming path vs CPU plain")
    # frac itself: the hunt on the same windows, card against CPU
    sub_st = prod_rx_init(fcfg, (N_REF_CH,))
    dfrac, n_det = 0.0, 0
    for b in range(4):
        pcm_b = frames[b, :N_REF_CH].contiguous()
        fr_, fi_, tr_, ti_, pr_, pi_ = fused_frontend(
            fcfg, pcm_b, sub_st.phase.real.contiguous(),
            sub_st.phase.imag.contiguous(),
            sub_st.fir_tail.real.contiguous(),
            sub_st.fir_tail.imag.contiguous())
        dcur = torch.complex(fr_, fi_).reshape(
            -1, cfg.symbols_per_block, cfg.cycles).transpose(-1, -2)
        wins = torch.cat([sub_st.decim_prev, dcur], -1)
        frac_k = _hunt(fcfg, wins)[3].cpu()
        frac_c = _hunt(fcfg, wins.cpu())[3]
        det = sub.valid[b]
        if bool(det.any()):
            dfrac = max(dfrac, float((frac_k - frac_c)[det].abs().max()))
            n_det += int(det.sum())
        sub_st = type(sub_st)(torch.complex(pr_, pi_),
                              torch.complex(tr_, ti_), dcur)
    _require(n_det > 0 and dfrac < 1e-3,
             f"paths f: frac differs by {dfrac} on {n_det} detected rows")
    print(f"[paths] (f) prod_rx_stream_pallas(frac_timing=True), "
          f"ProdRxState, {C_MAIN} channels x {2 * B_MAIN} blocks one at a "
          f"time: 10/10 packets on every channel ({n_dup_f} seam repeats); "
          f"first {N_REF_CH} channels agree with the CPU plain path by "
          f"decisions, frac within {dfrac:.3e} on {n_det} detected rows "
          f"(tolerance 1e-3)", flush=True)
    del st_f, out_f, ref_f, sub, sub_st, wins, dcur

    # ---- (g) loopback parity, (h) BER: the XLA path as the oracle ----
    t0 = time.perf_counter()
    parity_launches = _parity_phase(torch, default, _drive, dev, SEED)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ber_phase(torch, cfg, _drive, dev, SEED,
               _ber_record(os.path.join(here, BER_RECORD)))
    print(f"[paths] (g) parity {t_g:.1f} s, (h) BER "
          f"{time.perf_counter() - t0:.1f} s, at {_at()}; {smi_line}",
          flush=True)
    # ---- (i) every knob value's kernels against their plain versions ----
    t0 = time.perf_counter()
    knob_errs = _knob_phase(torch, gen, _inputs, default, cfg)
    print(f"[knobs] (i) {len(KNOB_VALUES)} knob values x 2 operating "
          f"points: {time.perf_counter() - t0:.1f} s; {smi_line}",
          flush=True)

    # ---- (j) the named numerologies ----
    t0 = time.perf_counter()
    geometries = _numerology_phase(torch, np, dev, builds, _drive,
                                   smi_line)
    print(f"[numerology] (j) {len(_build.NUMEROLOGIES)} numerologies: "
          f"{time.perf_counter() - t0:.1f} s, at {_at()}; {smi_line}",
          flush=True)

    # ---- (o) the CLI at 24 taps and 872 symbols a block ----
    t0 = time.perf_counter()
    _cli_phase(queued["cli"], smi_line)
    print(f"[cli] (o) {time.perf_counter() - t0:.1f} s, at {_at()}",
          flush=True)

    # ---- (p) the edge geometries, the last libraries to land ----
    t0 = time.perf_counter()
    _edge_phase(torch, gen, dev, edge_builds, smi_line)
    print(f"[edge] (p) {len(EDGE_GEOMETRIES)} geometries: "
          f"{time.perf_counter() - t0:.1f} s, at {_at()}; {smi_line}",
          flush=True)
    # every library is built: the phases below, host-bound and timed,
    # share the CPU with no nvcc, and (l) sees no build
    _build_pool[0].shutdown(wait=True)
    # (p)'s plain decodes of 1616 symbols on 32,768 rows leave most of
    # the card cached in this process: (m)'s and (n)'s gloo ranks,
    # spawned on the same card, need it back
    torch.cuda.empty_cache()

    # ---- (k) the faithful receiver ----
    t0 = time.perf_counter()
    _faithful_phase(torch, np, golden, dev, here, smi_line)
    print(f"[faithful] (k) {time.perf_counter() - t0:.1f} s, at {_at()}; "
          f"{smi_line}", flush=True)

    # ---- (l) the runtime layer ----
    _runtime_phase(torch, np, cfg, default, frames, main_out, tx_bits,
                   _drive, dev, here, smi_line)

    # ---- (m) the multi-device layer ----
    _parallel_phase(torch, cfg, frames, main_out, tx_bits, _drive, dev,
                    here, smi_line)

    # ---- (n) the tools, each main in-process at a reduced size ----
    _tools_phase(here, smi_line)
    print(f"[runtime] the script so far: "
          f"{time.perf_counter() - t_script:.1f} s", flush=True)

    _require(all(path_launches.get(k, 0) > 0 for k in KERNELS),
             f"a kernel was launched on no path: {path_launches}")
    print(f"[paths] launches over the driven paths: {path_launches}",
          flush=True)
    del frames, stream, outs, halves, few, main_out, out_a, out_b, out_x
    del out_u, sub_a, st_b

    noise = torch.randint(-16384, 16384, (B_TIME, C_MAIN, n), generator=gen,
                          device=dev, dtype=torch.int16)
    state = prod_rx_init_planes(cfg, C_MAIN)
    state, out = prod_rx_batch(cfg, state, noise, fuse_frontend=True)
    fa = int(out.valid.sum())
    print(f"[main] noise-only dispatch {C_MAIN} x {B_TIME}: {fa} false "
          f"detects in {C_MAIN * B_TIME} blocks", flush=True)
    del out

    # ---- 6. timing ----
    def _rate(what, fn, blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rate = blocks * C_MAIN * n / wall
        print(f"[timing] {what}: {wall:.3f} s (the host had enqueued it "
              f"after {enqueued:.3f} s), {rate:.4e} samples/s = "
              f"{rate / cfg.fs:.1f} real-time channels; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"{smi_line}", flush=True)
        return rate

    def _dispatches(state, cfg_=cfg, **kw):
        for _ in range(ITERS):
            state, _ = prod_rx_batch(cfg_, state, noise, **kw)

    torch.cuda.reset_peak_memory_stats()     # from here, not (j)'s peak
    main_rate = _rate(f"main path {C_MAIN} ch x {B_TIME} blocks x {ITERS} "
                      f"chained dispatches",
                      lambda: _dispatches(state, fuse_frontend=True),
                      ITERS * B_TIME)
    del state
    state = prod_rx_init_planes(fold, C_MAIN)
    state, _ = prod_rx_batch(fold, state, noise, fuse_frontend=True)
    _rate(f"(d1) main path with mixer_fold=True {C_MAIN} ch x {B_TIME} "
          f"blocks x {ITERS} chained dispatches",
          lambda: _dispatches(state, fold, fuse_frontend=True),
          ITERS * B_TIME)
    del state

    def _gated_dispatches(gstate, k):
        for _ in range(ITERS):
            gstate, _ = prod_rx_batch_gated(cfg, gstate, noise,
                                            max_detections=k)

    for k in K_TIME:
        gstate = prod_rx_gated_init(cfg, C_MAIN)
        gstate, gout = prod_rx_batch_gated(cfg, gstate, noise,
                                           max_detections=k)
        count = int(gout["count"])
        print(f"[timing] gated RX on noise, max_detections={k}: {count} of "
              f"{C_MAIN * B_TIME} rows pass the energy gate, phase 2 "
              f"decodes {min(count, k)} of them (capacity "
              f"{'overflowed' if count > k else 'holds them'}), "
              f"{int(gout['valid'].sum())} valid", flush=True)
        _rate(f"(e) gated RX, max_detections={k} (capacity "
              f"{'overflowed' if count > k else 'holds the gated rows'}), "
              f"{C_MAIN} ch x {B_TIME} blocks x {ITERS} chained dispatches",
              lambda: _gated_dispatches(gstate, k), ITERS * B_TIME)
        del gstate, gout
    state = prod_rx_init_planes(cfg, C_MAIN)
    state, _ = prod_rx_batch(cfg, state, noise)                  # warm-up
    _rate(f"(a) two-kernel batch path {C_MAIN} ch x {B_TIME} blocks x "
          f"{ITERS} chained dispatches", lambda: _dispatches(state),
          ITERS * B_TIME)
    del state
    state = prod_rx_init_planes(fold, C_MAIN)
    state, _ = prod_rx_batch(fold, state, noise)                 # warm-up
    _rate(f"(d2) two-kernel batch path with mixer_fold=True {C_MAIN} ch x "
          f"{B_TIME} blocks x {ITERS} chained dispatches",
          lambda: _dispatches(state, fold), ITERS * B_TIME)
    del state
    cstate = prod_rx_init(cfg, (C_MAIN,))
    cstate, _ = prod_rx_stream_pallas(cfg, cstate, noise[:2])    # warm-up
    _rate(f"(b) streaming path {C_MAIN} ch x {B_TIME} blocks one at a "
          f"time", lambda: prod_rx_stream_pallas(cfg, cstate, noise),
          B_TIME)
    cstate, _ = prod_rx_stream_pallas(fcfg, cstate, noise[:2])   # warm-up
    _rate(f"(f) frac streaming path {C_MAIN} ch x {B_TIME} blocks one at a "
          f"time", lambda: prod_rx_stream_pallas(fcfg, cstate, noise),
          B_TIME)
    # the XLA path (plain PyTorch, no kernel) and the CLI's loopback
    xstate = prod_rx_init(cfg, (C_MAIN,))
    xstate, _ = prod_rx_stream(cfg, xstate, noise[:1])            # warm-up
    _rate(f"XLA path prod_rx_stream {C_MAIN} ch x {B_XLA} blocks one at a "
          f"time", lambda: prod_rx_stream(cfg, xstate, noise[:B_XLA]),
          B_XLA)
    dprev = xstate.decim_prev
    wins = torch.cat([dprev, dprev], -1)
    hl, hp, hq, hf = _hunt(cfg, wins)
    pkt = _extract_packet(cfg, wins, hl, hp, hf)
    stages = {
        "prod_rx_frame (all of a block)":
            lambda: prod_rx_frame(cfg, xstate, noise[0]),
        "plain hunt (torch.matmul)": lambda: _hunt(cfg, wins),
        "_train_and_decode (LS fit, refits, refinement)":
            lambda: _train_and_decode(cfg, pkt),
    }
    print(f"[timing] XLA path stages on one {C_MAIN}-row block (CUDA events "
          f"around the host's issue): " + ", ".join(
              f"{k} {_time_cuda(fn, 3):.3f} ms" for k, fn in stages.items())
          + f"; {smi_line}", flush=True)
    del xstate, dprev, wins, pkt, stages
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "singlecarrier_tpu_torch",
                          "loopback"], cwd=here, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    _require(res.returncode == 0, f"cli loopback: rc {res.returncode}: "
             f"{res.stderr[-2000:]}")
    lb = json.loads(res.stdout.strip().splitlines()[-1])
    _require(lb["packets_detected"] == lb["packets_sent"] == 10
             and lb["ber"] == 0.0, f"cli loopback: {lb}")
    print(f"[timing] python -m singlecarrier_tpu_torch loopback: {wall:.2f} s "
          f"wall (a new process: start-up, CUDA context, 10 packets through "
          f"TX and the XLA path); {json.dumps(lb)}; {smi_line}", flush=True)

    # (f)'s stages on one 8192-row block
    planes_f = [t.contiguous() for t in (
        cstate.phase.real, cstate.phase.imag, cstate.fir_tail.real,
        cstate.fir_tail.imag)]
    fr_, fi_ = fused_frontend(fcfg, noise[2], *planes_f)[:2]
    wins = torch.cat([cstate.decim_prev, torch.complex(fr_, fi_).reshape(
        -1, cfg.symbols_per_block, cfg.cycles).transpose(-1, -2)], -1)
    hl, hp, hq, hf = _hunt(fcfg, wins)
    pkt = _extract_packet(fcfg, wins, hl, hp, hf)
    pkt_r, pkt_i = pkt.real.contiguous(), pkt.imag.contiguous()
    stages = {
        "fused_frontend (frontend_full + state glue)":
            lambda: fused_frontend(fcfg, noise[2], *planes_f),
        "plain hunt with frac (torch.matmul)": lambda: _hunt(fcfg, wins),
        "blended extraction (gathers)":
            lambda: _extract_packet(fcfg, wins, hl, hp, hf),
        "fused_decode (decode_packets)":
            lambda: fused_decode(fcfg, pkt_r, pkt_i, hq),
    }
    print(f"[timing] (f) stages on one {C_MAIN}-row block: " + ", ".join(
        f"{k} {_time_cuda(fn, 5):.3f} ms" for k, fn in stages.items())
        + f"; {smi_line}", flush=True)
    del cstate, wins, pkt, pkt_r, pkt_i, stages, planes_f, fr_, fi_

    # (e)'s stages at the full dispatch
    gplanes = prod_rx_init_planes(cfg, C_MAIN)
    gprev = torch.zeros((C_MAIN, n), dtype=torch.int16, device=dev)
    gdec = fused_rx_block(cfg, noise, *gplanes, stage="gate")[0]
    stages = {
        "phase 1 (fused_rx_block, stage='gate')":
            lambda: fused_rx_block(cfg, noise, *gplanes, stage="gate"),
    }
    for k in K_TIME:
        def _pairs(k=k):
            return _pair_operands(cfg, gdec["gated"], noise, gplanes[0],
                                  gplanes[1], k, gprev, gprev[:, :48])
        pairs_ = _pairs()
        dp0 = torch.zeros((cfg.cycles, 2, k, cfg.symbols_per_block),
                          dtype=torch.bfloat16, device=dev)
        stages[f"compaction to {k} (stable argsort + gathers)"] = _pairs
        stages[f"phase 2 (fused_rx_block on 2 x {k} rows)"] = (
            lambda pairs_=pairs_, dp0=dp0: fused_rx_block(
                cfg, *pairs_[:5], dp0))
    print(f"[timing] (e) stages at {C_MAIN} ch x {B_TIME} blocks: "
          + ", ".join(f"{k} {_time_cuda(fn, 3):.3f} ms"
                      for k, fn in stages.items()) + f"; {smi_line}",
          flush=True)
    del gplanes, gprev, gdec, pairs_, dp0, stages

    # the batch paths' kernels at the full dispatch size, with their bounds
    p0r, p0i, t0r, t0i, dprev0 = prod_rx_init_planes(cfg, C_MAIN)
    advs = np.exp(-2j * np.pi * cfg.center / cfg.fs * n
                  * np.arange(B_TIME)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag])).to(dev)
    rows = _row_inputs(cfg, noise, p0r, p0i, t0r, t0i, adv)
    dk = frontend_decim(cfg, noise, p0r, p0i, t0r, t0i, adv)
    lk, pk_, qk = hunt(cfg, dk, dprev0)
    full = {
        "frontend_decim": lambda: frontend_decim(cfg, noise, p0r, p0i, t0r,
                                                 t0i, adv),
        "frontend_rows": lambda: frontend_rows(cfg, *rows, transposed=True),
        "hunt": lambda: hunt(cfg, dk, dprev0),
        "extract_decode": lambda: extract_decode(cfg, dk, dprev0, lk, pk_,
                                                 qk),
        "frontend_decim_folded": lambda: frontend_decim(
            cfg, noise, p0r, p0i, t0r, t0i, adv, mixer_fold=True),
        "frontend_rows_folded": lambda: frontend_rows(
            cfg, *rows, transposed=True, mixer_fold=True),
        "extract_gate": lambda: extract_gate(cfg, dk, dprev0, lk, pk_, qk),
        "frontend_full": lambda: frontend_full(cfg, *rows),
    }
    bounds = _kernel_bounds(cfg, C_MAIN * B_TIME, C_MAIN)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = {}

    for name, kern in full.items():
        ms = _time_cuda(kern, 3)
        note = ""
        if name.startswith("frontend"):
            # the clock the card holds under this kernel
            mhz = clock[name] = _sm_clock_under(kern)
            f_ms, f_what = _fp32_floor(cfg, name, C_MAIN * B_TIME, mhz, sms)
            note = (f"; SM clock under this kernel {mhz:.0f} MHz, at which "
                    f"its multiply-adds alone take {f_ms:.3f} ms on {sms} "
                    f"SMs ({f_what})")
        if name == "frontend_full":
            note += f"; ptxas: {ptxas_full}"
        print(f"[timing] {name} at {C_MAIN} ch x {B_TIME} blocks "
              f"({C_MAIN * B_TIME} rows): kernel {ms:.3f} ms, bound "
              f"{bounds[name][0]:.3f} ms ({bounds[name][1]}){note}; "
              f"{smi_line}", flush=True)
    del rows, dk, lk, pk_, qk, full
    # the main path under each knob value (peak memory counted from here)
    knob_launches = _knob_main_paths(torch, np, cfg, noise, _rate,
                                     _dispatches, main_rate, smi_line)
    del noise

    kinputs = _inputs(cfg, C_MAIN, B_KTIME)
    _, _, _, _, _, _, dprev0 = kinputs
    dk = frontend_decim(cfg, *kinputs[:6])
    calls = _kernel_calls(cfg, kinputs, C_MAIN)
    dk32 = dk.float()
    dprev32 = dprev0.float()
    for what, cfg_ in (("bf16 operand, f32 planes (the library default)",
                        default),
                       ("int8 operand, f32 planes",
                        default.replace(hunt_dtype="int8"))):
        b_ms, b_by = _kernel_bounds(cfg_, C_MAIN * B_KTIME, C_MAIN)["hunt"]
        print(f"[timing] hunt, {what}, at {C_MAIN} ch x {B_KTIME} blocks: "
              f"kernel {_time_cuda(lambda: hunt(cfg_, dk32, dprev32), 10):.3f}"
              f" ms, bound {b_ms:.4f} ms ({b_by}); {smi_line}", flush=True)
    del dk32, dprev32
    bounds = _kernel_bounds(cfg, C_MAIN * B_KTIME, C_MAIN)
    for name, (kern, plain) in calls.items():
        report[name]["ms"] = _time_cuda(kern, 10)
        report[name]["plain_ms"] = _time_cuda(plain, 3)
        bound_ms, bound_by = bounds[name]
        floor = ""
        if name in clock:
            f_ms, f_what = _fp32_floor(cfg, name, C_MAIN * B_KTIME,
                                       clock[name], sms)
            floor = f", {f_what} {f_ms:.4f} ms at {clock[name]:.0f} MHz"
        if name == "frontend_full":
            floor += f", ptxas: {ptxas_full}"
        print(f"[timing] {name} at {C_MAIN} ch x {B_KTIME} blocks: kernel "
              f"{report[name]['ms']:.3f} ms, plain "
              f"{report[name]['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}){floor}, no single PyTorch call computes it; "
              f"{smi_line}", flush=True)

    variants = {name: [] for name in KERNELS}
    for knob, value, names in KNOB_VALUES:
        kcfg = cfg.replace(**{knob: value})
        kcalls = _kernel_calls(kcfg, kinputs, C_MAIN)
        kbounds = _kernel_bounds(kcfg, C_MAIN * B_KTIME, C_MAIN)
        key = f"{knob}={value}"
        # (g) runs the CFO knob as its pinned record's config
        gkey = "cfo bf16" if knob == "cfo_dtype" else key
        for name in names:
            kern, plain = kcalls[name]
            v = {"knob": key, "max_abs_err": knob_errs[key][name],
                 "ms": _time_cuda(kern, 10), "plain_ms": _time_cuda(plain, 3),
                 "bound_ms": kbounds[name][0], "bound_by": kbounds[name][1],
                 "launches": knob_launches[key].get(name, 0),
                 "launches_parity": parity_launches[gkey].get(name, 0)}
            variants[name].append(v)
            print(f"[timing] {name} with {key} at {C_MAIN} ch x {B_KTIME} "
                  f"blocks: kernel {v['ms']:.3f} ms (the default "
                  f"instantiation {report[name]['ms']:.3f} ms above), plain "
                  f"{v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
                  f"({v['bound_by']}); launches {v['launches']} on the runs "
                  f"of the paths under the knob, {v['launches_parity']} on "
                  f"its (g) run; {smi_line}", flush=True)
        del kcalls
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "stands_for": note,
                "launches": path_launches[name],
                "max_abs_err": report[name]["max_abs_err"],
                "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"],
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": None, "variants": variants[name],
                "geometries": geometries[name]}
               for name, (src, rep, note) in KERNELS.items()]
    print(f"[script] {time.perf_counter() - t_script:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 2
    sys.exit(code)
