"""The detector's operating point on the card: Pfa and Pd over gates.

Counterpart of ``tools/detection_curves.py``::

    python3 -m singlecarrier_tpu_torch.tools.detection
        [--noise-channels 8192] [--noise-blocks 128] [--pd-channels 256]
        [--pd-packets 6] [--snrs 2,3,4,5,6,8] [--cfos 0,20,40]
        [--path fused|two-kernel] [--hunt-norm NORM] [--segments 4,8,16]
        [--save-false-detects PATH] [--device cpu]

* **Pfa**, the false-alarm probability per block: full-scale noise of
  +-16384 (``bench.py``'s convention, drawn from a ``torch.Generator`` on
  the device) through ``prod_rx_batch`` at the bench operating point,
  in dispatches of at most 8192 x 128 rows with the plane state carried,
  for ``hunt_dtype`` bf16 and int8, at every gate of ``GATES``, each
  with a Wilson 95% interval.
* **Pd**, the detection probability on real packets: the port's
  ``tx_stream`` and ``channel`` at SNR x CFO (``--snrs`` x ``--cfos``)
  on ``--pd-channels`` channels x ``--pd-packets`` packets, detections
  matched to packets by stream position (``ber.assign_detections``).

The kernels return the raw statistics, so one run per (stream, hunt
dtype) evaluates every gate on the host with the in-kernel criterion
``valid = (peak > energy * gate) & (matches > match_threshold)``; at
``cfg.effective_peak_gate`` it must reproduce the path's own ``valid``
on every row.  ``--segments`` adds a ``corr_segments`` sweep at high CFO
(within ``ops/_build.kernel_limits``: 1, 2, 4, 8 or 16; 32 is refused,
as the kernel wrappers refuse it).  ``--save-false-detects PATH`` keeps up to 16
false detects of the int8 run at the configured gate, each with what a
replay needs (the pair's plane state, as ``gated`` phase 2 rebuilds it,
and the two raw blocks the hunt window reads) and its rows on the card.

Writes ``DETECTION_GPU.json`` and ``DETECTION_GPU.md`` (``DETECTION.md``'s
layout) with the card's name and power limit.  ``--device cpu`` runs the
plain versions (the tests): the record then says ``"device": "cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from .. import DEFAULT_CONFIG
from ..ber import _wilson_ci, assign_detections
from ..interop import planes_to_numpy
from ..modem import prod_rx_batch, prod_rx_init_planes
from ..modem.rx_gated import _pair_operands
from ..ops import _build
from . import parity
from ._measure import SEED, bench_point, card_line, head, require, tool_device

GATES = [3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 10.0]
DISPATCH_ROWS = 8192 * 128        # rows of the largest dispatch
MAX_SAVED = 16                    # false detects kept for a replay


def wilson(k: int, n: int, z: float = 1.96):
    """Wilson score interval of k events in n trials (``ber._wilson_ci``,
    the records' one definition)."""
    return _wilson_ci(k, n, z)


def criterion(peak, energy, matches, gate: float, threshold: int):
    """The in-kernel detection criterion at ``gate``, on the host."""
    return (peak > energy * gate) & (matches > threshold)


class FalseDetects:
    """Up to ``limit`` false detects with their replay operands."""

    def __init__(self, limit: int = MAX_SAVED):
        self.limit, self.parts = limit, []

    @property
    def count(self) -> int:
        return sum(p["coords"].shape[0] for p in self.parts)

    def take(self, cfg, out, noise, entry, pcm_prev, prev2_tail,
             dispatch: int, fused: bool) -> None:
        """Keep this dispatch's first false detects (stream order): each
        one's pair as ``prod_rx_batch_gated`` phase 2 rebuilds it (blocks
        b-1 and b, the mixer phase entering b-1, the FIR tail of b-2's
        halo, zero planes), its rows here and the pair's own rows
        through the same path (block 1 of the pair)."""
        k = min(self.limit - self.count, int(out.valid.sum()))
        if k <= 0:
            return
        mask = out.valid.reshape(-1).clone()
        mask[torch.nonzero(mask)[k:, 0]] = False
        pairs, pr, pi, tl_r, tl_i, order, b_idx, c_idx = _pair_operands(
            cfg, mask.reshape(out.valid.shape), noise, entry[0], entry[1],
            k, pcm_prev, prev2_tail)
        dp0 = torch.zeros((cfg.cycles, 2, k, cfg.symbols_per_block),
                          dtype=entry[4].dtype, device=noise.device)
        planes = (pr, pi, tl_r, tl_i, dp0)
        _, rep = prod_rx_batch(cfg, planes, pairs, fuse_frontend=fused)
        p0r, p0i, t0r, t0i, dprev = planes_to_numpy(
            (pr, pi, tl_r, tl_i, dp0.float()))
        flat = [x.reshape(-1)[order].cpu().numpy() for x in
                (out.valid, out.lag, out.timing_phase, out.peak,
                 out.energy, out.matches)]
        again = [x[1].cpu().numpy() for x in
                 (rep.valid, rep.lag, rep.timing_phase, rep.peak,
                  rep.energy, rep.matches)]
        self.parts.append(dict(
            coords=np.stack([np.full(k, dispatch), b_idx.cpu().numpy(),
                             c_idx.cpu().numpy()], 1),
            p0r=p0r, p0i=p0i, t0r=t0r, t0i=t0i, dprev=dprev,
            pcm=pairs.cpu().numpy(),
            **{f"run_{f}": v for f, v in zip(_ROW_FIELDS, flat)},
            **{f"replay_{f}": v for f, v in zip(_ROW_FIELDS, again)}))

    def save(self, path: str, cfg, line: str) -> None:
        axis = {"pcm": 1, "dprev": 2}
        arrays = {key: np.concatenate([p[key] for p in self.parts],
                                      axis.get(key, 0))
                  for key in self.parts[0]}
        np.savez_compressed(
            path, config=json.dumps(dataclasses.asdict(cfg)), card=line,
            **arrays)


_ROW_FIELDS = ("valid", "lag", "timing_phase", "peak", "energy", "matches")


def pfa(cfg, C: int, blocks: int, dev, seed: int, fused: bool, gates,
        keep: FalseDetects | None = None) -> dict:
    """False alarms at every gate on ``blocks`` x ``C`` blocks of noise,
    in dispatches of at most ``DISPATCH_ROWS`` rows, the state carried."""
    n, halo = cfg.frame_size, cfg.ntaps - 1
    per = max(1, min(blocks, DISPATCH_ROWS // C))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = prod_rx_init_planes(cfg, C, dev)
    pcm_prev = torch.zeros((C, n), dtype=torch.int16, device=dev)
    prev2_tail = torch.zeros((C, halo), dtype=torch.int16, device=dev)
    counts = torch.zeros(len(gates), dtype=torch.int64, device=dev)
    done = dispatch = 0
    while done < blocks:
        b = min(per, blocks - done)
        noise = torch.randint(-16384, 16384, (b, C, n), generator=gen,
                              device=dev, dtype=torch.int16)
        entry = state
        state, out = prod_rx_batch(cfg, state, noise, fuse_frontend=fused)
        for i, g in enumerate(gates):
            counts[i] += criterion(out.peak, out.energy, out.matches, g,
                                   cfg.match_threshold).sum()
        own = criterion(out.peak, out.energy, out.matches,
                        cfg.effective_peak_gate, cfg.match_threshold)
        require(torch.equal(own, out.valid),
                f"the host criterion at gate {cfg.effective_peak_gate} "
                f"differs from the path's valid on "
                f"{int((own != out.valid).sum())} rows")
        if keep is not None:
            keep.take(cfg, out, noise, entry, pcm_prev, prev2_tail,
                      dispatch, fused)
        prev2_tail = (noise[-2, :, n - halo:] if b >= 2
                      else pcm_prev[:, n - halo:]).clone()
        pcm_prev = noise[-1].clone()
        done += b
        dispatch += 1
    total = blocks * C
    row = {}
    for g, k in zip(gates, counts.tolist()):
        lo, hi = wilson(k, total)
        row[str(float(g))] = {"false_alarms": k, "blocks": total,
                              "pfa": k / total, "pfa_ci95": [lo, hi]}
    return row


def pd_point(cfg, frames, ref, gates, fused: bool) -> dict:
    """Position-matched detections at every gate on one packet stream."""
    C, P = ref.shape[0], ref.shape[1]
    _, out = prod_rx_batch(cfg, prod_rx_init_planes(cfg, C, frames.device),
                           frames, fuse_frontend=fused)
    peak, energy, matches, lag, ph = (
        x.transpose(0, 1).cpu().numpy() for x in
        (out.peak, out.energy, out.matches, out.lag, out.timing_phase))
    row = {}
    for g in gates:
        valid = criterion(peak, energy, matches, g, cfg.match_threshold)
        det = spur = 0
        for c in range(C):
            assigned, f = assign_detections(cfg, valid[c], lag[c], ph[c], P)
            det += len(assigned)
            spur += f
        lo, hi = wilson(det, C * P)
        row[str(float(g))] = {"detected": det, "expected": C * P,
                              "pd": det / (C * P), "pd_ci95": [lo, hi],
                              "spurious": spur}
    return row


def _floats(text: str) -> list:
    return [float(v) for v in text.split(",") if v]


def markdown(rep: dict, args) -> str:
    """``DETECTION.md``'s layout, with the card's line."""
    gates = rep["gates"]
    where = (f"Card: {rep['card']} (`nvidia-smi`)" if rep["card"]
             else "Device: the CPU (plain versions; no rate)")
    lines = [
        "# Detector operating point (measured on the "
        + ("card)" if rep["card"] else "CPU)"), "",
        f"{where}.  Written by `python3 -m singlecarrier_tpu_torch.tools."
        f"detection`.  Measured through `prod_rx_batch(fuse_frontend="
        f"{rep['path'] == 'fused'})` at the bench operating point, "
        f"`hunt_norm=\"{rep['hunt_norm']}\"`, `corr_segments="
        f"{rep['corr_segments']}`.  Criterion: `valid = (corr_peak > gate "
        f"* window_energy) & (matches > {rep['match_threshold']})`, the "
        f"kernels' own (checked against the path's `valid` on every row at "
        f"the configured gate).  One run per (stream, hunt dtype) "
        f"evaluates every gate from the returned statistics.", "",
        f"## False-alarm probability per block (full-scale noise, "
        f"{rep['noise']['total_blocks']} blocks in dispatches of "
        f"{rep['noise']['dispatch_blocks']} x {rep['noise']['channels']}, "
        f"the state carried; torch.Generator seed {rep['seed']}; Wilson "
        f"95% CI)", "",
        "| gate | " + " | ".join(f"Pfa {hd}" for hd in rep["pfa"]) + " |",
        "|---|" + "---|" * len(rep["pfa"]),
    ]
    for g in gates:
        cells = []
        for hd in rep["pfa"]:
            r = rep["pfa"][hd][str(g)]
            lo, hi = r["pfa_ci95"]
            cells.append(f"{r['pfa']:.2e} ({r['false_alarms']}; "
                         f"CI {lo:.1e}-{hi:.1e})")
        lines.append(f"| {g} | " + " | ".join(cells) + " |")
    lines += ["", "## Detection probability (position-matched true "
              f"packets, {args.pd_channels * args.pd_packets} "
              f"packets/point)", ""]
    for hd, points in rep["pd"].items():
        lines += [f"### hunt_dtype = {hd}", "",
                  "| SNR dB | CFO Hz | " + " | ".join(
                      f"g={g}" for g in gates) + " |",
                  "|---|---|" + "---|" * len(gates)]
        for key, row in points.items():
            snr, cfo = key[3:].split("_cfo")
            lines.append(f"| {snr} | {cfo} | " + " | ".join(
                f"{row[str(g)]['pd']:.3f}" for g in gates) + " |")
        lines.append("")
    if "segment_sweep" in rep:
        ss = rep["segment_sweep"]
        lines += [
            "## corr_segments sweep at high CFO (hunt int8, the gate "
            "segment-normalized: `config.effective_peak_gate`; Wilson 95% "
            "CI)", "",
            "Noise Pfa at each segment count's effective gate: " + ", ".join(
                f"n_seg={s}: {r['pfa']:.2e} ({r['false_alarms']}/"
                f"{r['blocks']}, gate {r['effective_gate']:g})"
                for s, r in ss["pfa"].items()) + ".", "",
            "| SNR dB | CFO Hz | " + " | ".join(
                f"n_seg={s}" for s in ss["segments"]) + " |",
            "|---|---|" + "---|" * len(ss["segments"])]
        for snr in ss["snrs"]:
            for f in ss["cfos"]:
                lines.append(f"| {snr} | {f} | " + " | ".join(
                    f"{ss['pd'][f'seg{s}_snr{snr}_cfo{f}']['pd']:.3f}"
                    for s in ss["segments"]) + " |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--noise-channels", type=int, default=8192)
    ap.add_argument("--noise-blocks", type=int, default=128,
                    help="blocks a channel; dispatches of at most "
                    f"{DISPATCH_ROWS} rows carry the state")
    ap.add_argument("--pd-channels", type=int, default=256)
    ap.add_argument("--pd-packets", type=int, default=6)
    ap.add_argument("--snrs", default="2,3,4,5,6,8")
    ap.add_argument("--cfos", default="0,20,40")
    ap.add_argument("--path", default="fused", choices=["fused", "two-kernel"],
                    help="prod_rx_batch(fuse_frontend=True) or False")
    ap.add_argument("--hunt-norm", choices=["energy", "espan", "none"])
    ap.add_argument("--segments", default=None,
                    help="corr_segments values of a sweep at high CFO")
    ap.add_argument("--seg-cfos", default="30,40,50")
    ap.add_argument("--seg-snrs", default="2,4,6")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--save-false-detects", metavar="PATH", default=None,
                    help="an .npz of up to 16 false detects of the int8 "
                    "run at the configured gate, for a replay")
    ap.add_argument("--out", default="DETECTION_GPU.json")
    ap.add_argument("--md", default="DETECTION_GPU.md")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tool_device(args.device, "detection", timing=False)
    base = bench_point(DEFAULT_CONFIG)
    if args.hunt_norm:
        base = base.replace(hunt_norm=args.hunt_norm)
    segs = [int(s) for s in args.segments.split(",")] if args.segments else []
    for s in segs:                       # refused as the wrappers refuse it
        _build.kernel_limits(base.replace(corr_segments=s))
    fused = args.path == "fused"
    line = card_line(dev)
    C = args.noise_channels
    rep = {**head(dev), "match_threshold": base.match_threshold,
           "path": args.path, "hunt_norm": base.hunt_norm,
           "corr_segments": base.corr_segments,
           "effective_peak_gate": base.effective_peak_gate,
           "config": "bench operating point", "seed": args.seed,
           "gates": GATES,
           "noise": {"channels": C, "blocks": args.noise_blocks,
                     "dispatch_blocks": max(1, min(args.noise_blocks,
                                                   DISPATCH_ROWS // C)),
                     "total_blocks": C * args.noise_blocks},
           "pfa": {}, "pd": {}}
    keep = FalseDetects() if args.save_false_detects else None
    cfgs = {hd: base.replace(hunt_dtype=hd) for hd in ("bf16", "int8")}
    for hd, cfg in cfgs.items():
        rep["pfa"][hd] = pfa(cfg, C, args.noise_blocks, dev, args.seed,
                             fused, GATES, keep if hd == "int8" else None)
        print(f"[pfa] {hd}: " + ", ".join(
            f"g={g} {r['false_alarms']}/{r['blocks']} "
            f"[{r['pfa_ci95'][0]:.2e}, {r['pfa_ci95'][1]:.2e}]"
            for g, r in rep["pfa"][hd].items()) + f"; {line}", flush=True)

    bits, ref = parity.payload(DEFAULT_CONFIG, args.pd_channels,
                               args.pd_packets, args.seed, dev)
    for hd in cfgs:
        rep["pd"][hd] = {}
    for snr in _floats(args.snrs):
        for f in _floats(args.cfos):
            frames = parity.stream(DEFAULT_CONFIG, bits, args.seed + 1, dev,
                                   snr, f)
            for hd, cfg in cfgs.items():
                row = pd_point(cfg, frames, ref, GATES, fused)
                rep["pd"][hd][f"snr{snr}_cfo{f}"] = row
                print(f"[pd] {hd} {snr} dB {f} Hz: " + ", ".join(
                    f"g={g} {r['pd']:.4f}" for g, r in row.items())
                    + f"; {line}", flush=True)

    if segs:
        ss = rep["segment_sweep"] = {
            "segments": segs, "snrs": _floats(args.seg_snrs),
            "cfos": _floats(args.seg_cfos), "hunt_dtype": "int8",
            "gate": base.peak_gate, "pd": {}, "pfa": {}}
        for s in segs:
            scfg = cfgs["int8"].replace(corr_segments=s)
            g = scfg.effective_peak_gate
            r = pfa(scfg, C, max(2, args.noise_blocks // 4), dev, args.seed,
                    fused, [g])[str(float(g))]
            ss["pfa"][str(s)] = {**r, "effective_gate": g}
            for snr in ss["snrs"]:
                for f in ss["cfos"]:
                    frames = parity.stream(DEFAULT_CONFIG, bits,
                                           args.seed + 1, dev, snr, f)
                    ss["pd"][f"seg{s}_snr{snr}_cfo{f}"] = pd_point(
                        scfg, frames, ref, [g], fused)[str(float(g))]
            print(f"[segments] n_seg={s}: Pfa {r['false_alarms']}/"
                  f"{r['blocks']} at gate {g:g}; {line}", flush=True)

    if keep is not None:
        require(keep.count > 0, "no false detect to save")
        keep.save(args.save_false_detects, cfgs["int8"], line)
        print(f"[false detects] {keep.count} saved to "
              f"{args.save_false_detects}; {line}", flush=True)
    with open(args.out, "w") as fo:
        json.dump(rep, fo, indent=1)
    with open(args.md, "w") as fo:
        fo.write(markdown(rep, args))
    g7 = str(float(base.effective_peak_gate))
    print(json.dumps({"record": args.out, "card": rep["card"],
                      "pfa_at_gate": {hd: rep["pfa"][hd][g7]
                                      for hd in rep["pfa"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
