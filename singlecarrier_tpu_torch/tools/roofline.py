"""Every CUDA kernel's time on the card beside its bound, from one call.

Counterpart of ``tools/roofline.py``::

    python3 -m singlecarrier_tpu_torch.tools.roofline [--channels 8192]
        [--blocks 128] [--iters 2 6] [--plain-blocks 4]
        [--config NAME] [--out ROOFLINE_GPU.md]

At the bench operating point (of the reference numerology, or with
``--config`` of a named one, ``ops/_build.NUMEROLOGIES``), on full-scale
noise of ``--channels`` x ``--blocks`` rows (8192 x 128 = 1,048,576 by
default: every launch over 5 ms), each of the ten kernels
(``frontend_decim`` and its folded form, ``frontend_rows`` and its
folded form in both output layouts,
``frontend_full``, ``hunt``, ``extract_decode``, ``extract_gate``,
``decode_extract``, ``decode_packets``) and one dispatch of the main path
``prod_rx_batch(fuse_frontend=True)`` is timed as the slope over two
chain lengths (``--iters``) of CUDA-event-timed launches, which cancels
what is fixed per measurement.  Beside each: the bound
(``_measure.kernel_bounds`` at the shape timed: each input read once,
each output written once, operations at the peak of their type, the
larger of the two) and what binds, the share bound / time, the
front-ends' FP32 floor at the SM clock read under each, the kernel and
its plain PyTorch version at ``--plain-blocks`` x ``--channels`` rows
(32,768 by default; mean of CUDA-event-timed calls), and the launches
of a main-path dispatch.  No single PyTorch call computes any of these
kernels: library "none".  A share over 100% is an error (exit 1), not a
row.  Writes ``ROOFLINE_GPU.md`` (``PERF.md`` section 6's columns) and
prints one JSON line, each with the card's name and power limit.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import DEFAULT_CONFIG
from ..modem import prod_rx_batch, prod_rx_init_planes
from ..ops import _build
from ..ops.decode import (extract_decode, extract_gate, fused_decode,
                          fused_decode_extract, hunt)
from ..ops.frontend import frontend_decim, frontend_full, frontend_rows
from ..ops.fused_rx import _advances
from ._measure import (KERNELS, SEED, bench_point, card, fp32_floor, head,
                       hunt_windows, kernel_bounds, kernel_calls, row_inputs,
                       slope_cuda, sm_clock_under, time_cuda, tool_device)

CHUNK_BLOCKS = 4                  # blocks a chunk of the decode operands


def decode_operands(cfg, rows, C: int, chunk_blocks: int = CHUNK_BLOCKS):
    """``hunt_windows`` of every row, built a chunk of ``chunk_blocks`` x
    ``C`` rows at a time (each chunk with the C rows before it as its
    previous block): the padded windows, the plain hunt's (lag, phase,
    peak) and the packet planes, for the decode kernels that read
    windows or packets.  The whole windows array holds 30 KB a row."""
    N = rows[0].shape[0]
    step = chunk_blocks * C
    out = None
    for i in range(0, N, step):
        lo, hi = max(0, i - C), min(N, i + step)
        drow = frontend_rows(cfg, *(t[lo:hi] for t in rows),
                             transposed=False)
        part = [x[i - lo:] for x in hunt_windows(cfg, drow, C)]
        if out is None:
            out = tuple(x.new_empty((N, *x.shape[1:])) for x in part)
        for o, x in zip(out, part):
            o[i:i + x.shape[0]] = x
        del drow, part
    return out


def measure(cfg, C: int, B: int, k1: int, k2: int, plain_blocks: int, dev):
    """The rows of the table: {kernel, layout, rows, ms, bound_ms,
    bound_by, share, ...} and the main path's."""
    n = cfg.frame_size
    N = C * B
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    noise = torch.randint(-16384, 16384, (B, C, n), generator=gen,
                          device=dev, dtype=torch.int16)
    p0r, p0i, t0r, t0i, dprev0 = prod_rx_init_planes(cfg, C, dev)
    adv = _advances(cfg, B, dev)[1]
    batch = (noise, p0r, p0i, t0r, t0i, adv)
    rows = row_inputs(cfg, *batch)
    bounds = kernel_bounds(cfg, N, C)
    # the row-major layout writes f32 planes whatever decim_dtype says
    f32_rows = kernel_bounds(cfg.replace(decim_dtype="f32"), N, C)
    sms = card(dev).sms

    _build.reset_launches()
    prod_rx_batch(cfg, (p0r, p0i, t0r, t0i, dprev0), noise,
                  fuse_frontend=True)
    torch.cuda.synchronize()
    main_launches = dict(_build.LAUNCHES)

    # the plain versions (and the kernels again) at the smaller shape
    Bp = min(plain_blocks, B)
    small = kernel_calls(cfg, (noise[:Bp], p0r, p0i, t0r, t0i,
                               adv[:, :Bp].contiguous(), dprev0), C)
    small_bounds = kernel_bounds(cfg, Bp * C, C)
    small_f32 = kernel_bounds(cfg.replace(decim_dtype="f32"), Bp * C, C)
    plain = {name: time_cuda(p, 3) for name, (_, p) in small.items()}
    at_small = {name: time_cuda(k, 10) for name, (k, _) in small.items()}
    del small

    out = []

    def row(name, layout, fn, bnd, small_bnd, kernel_small=None):
        ms = slope_cuda(fn, k1, k2)
        r = {"kernel": name, "layout": layout, "rows": N, "ms": ms,
             "bound_ms": bnd[0], "bound_by": bnd[1], "share": bnd[0] / ms,
             "replaces": KERNELS[name][1], "source": KERNELS[name][0],
             "route": "cuda",
             "small_rows": Bp * C,
             "small_ms": (at_small[name] if kernel_small is None
                          else time_cuda(kernel_small, 10)),
             "small_bound_ms": small_bnd[0], "plain_ms": plain[name],
             "library_ms": None,
             "launches_main_dispatch": main_launches.get(name, 0)}
        r["small_share"] = r["small_bound_ms"] / r["small_ms"]
        if name.startswith("frontend"):
            mhz = sm_clock_under(fn)
            r["fp32_floor_ms"], r["floor_counts"] = fp32_floor(
                cfg, name, N, mhz, sms)
            r["sm_mhz"] = mhz
        out.append(r)
        print(f"[roofline] {name} ({layout}) at {N} rows: {ms:.3f} ms, "
              f"bound {bnd[0]:.3f} ms ({bnd[1]}), share "
              f"{100 * r['share']:.1f}%", flush=True)

    small_rows = [t[:Bp * C] for t in rows]
    for fold in (False, True):
        nm = "frontend_decim_folded" if fold else "frontend_decim"
        row(nm, "transposed bf16 planes",
            lambda: frontend_decim(cfg, *batch, mixer_fold=fold),
            bounds[nm], small_bounds[nm])
        nm = "frontend_rows_folded" if fold else "frontend_rows"
        row(nm, "transposed bf16 planes",
            lambda: frontend_rows(cfg, *rows, transposed=True,
                                  mixer_fold=fold),
            bounds[nm], small_bounds[nm])
        row(nm, "row-major f32 planes",
            lambda: frontend_rows(cfg, *rows, transposed=False,
                                  mixer_fold=fold),
            f32_rows[nm], small_f32[nm],
            lambda: frontend_rows(cfg, *small_rows, transposed=False,
                                  mixer_fold=fold))
    row("frontend_full", "row-major f32", lambda: frontend_full(cfg, *rows),
        bounds["frontend_full"], small_bounds["frontend_full"])
    dk = frontend_decim(cfg, *batch)
    lag, ph, peak = hunt(cfg, dk, dprev0)
    row("hunt", "int8 operand, espan", lambda: hunt(cfg, dk, dprev0),
        bounds["hunt"], small_bounds["hunt"])
    row("extract_decode", "bf16 planes",
        lambda: extract_decode(cfg, dk, dprev0, lag, ph, peak),
        bounds["extract_decode"], small_bounds["extract_decode"])
    row("extract_gate", "bf16 planes",
        lambda: extract_gate(cfg, dk, dprev0, lag, ph, peak),
        bounds["extract_gate"], small_bounds["extract_gate"])
    del dk, lag, ph, peak
    wins, wl, wph, wpk, pkt_r, pkt_i = decode_operands(cfg, rows, C)
    row("decode_extract", "f32 windows",
        lambda: fused_decode_extract(cfg, wins, wl, wph, wpk),
        bounds["decode_extract"], small_bounds["decode_extract"])
    del wins
    row("decode_packets", "f32 packets",
        lambda: fused_decode(cfg, pkt_r, pkt_i, wpk),
        bounds["decode_packets"], small_bounds["decode_packets"])
    del pkt_r, pkt_i, wl, wph, wpk

    main_ms = slope_cuda(lambda: prod_rx_batch(
        cfg, (p0r, p0i, t0r, t0i, dprev0), noise, fuse_frontend=True),
        k1, k2)
    path = [k for k, v in main_launches.items() if v]
    main_bound = sum(bounds[k][0] for k in path)
    main = {"kernel": "main path", "layout": "prod_rx_batch(fuse_frontend="
            "True), one dispatch", "rows": N, "ms": main_ms,
            "bound_ms": main_bound, "bound_by": "the sum of its kernels'",
            "share": main_bound / main_ms,
            "samples_per_sec": N * n / main_ms * 1e3,
            "launches_main_dispatch": sum(main_launches.values()),
            "kernels": path}
    return out, main


def markdown(rows, main, line: str, cfg, k1: int, k2: int) -> str:
    lines = [
        "# Per-kernel roofline on the card", "",
        f"Card: {line} (`nvidia-smi`); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}.  Written by `python3 -m "
        f"singlecarrier_tpu_torch.tools.roofline`, every number from this "
        f"one call.  Config: the bench operating point ({cfg.frame_size} "
        f"samples, {cfg.cycles} cycles and {cfg.symbols_per_block} symbols "
        f"a block, {cfg.eq_length} taps; decim "
        f"{cfg.decim_dtype}, hunt {cfg.hunt_dtype} {cfg.hunt_norm}, gram "
        f"{cfg.ls_gram}, refit window {cfg.ls_refit_symbols}) on full-scale "
        f"noise.  Time: the slope over chains of {k1} and {k2} launches, "
        f"CUDA events.  Bound: the larger of bytes over 3.35 TB/s (each "
        f"input read once, each output written once) and operations over "
        f"the peak of their type (int8 1,979 TOP/s, bf16 989 TFLOP/s, f32 "
        f"67 TFLOP/s), at the shape timed; share = bound / time.  FP32 "
        f"floor: the front-ends' multiply-adds on the SMs' 128 FP32 lanes "
        f"at the SM clock read under the kernel.  No single PyTorch call "
        f"computes any of these kernels: library none.  Launches: per "
        f"dispatch of the main path.", "",
        "| kernel (layout) | TPU kernel it replaces | route, source | rows "
        "| ms | bound ms (binds) | share | FP32 floor ms (MHz) | ms at "
        f"{rows[0]['small_rows']} rows | bound ms there | plain ms there | "
        "library | launches |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        floor = (f"{r['fp32_floor_ms']:.3f} ({r['sm_mhz']:.0f})"
                 if "fp32_floor_ms" in r else "—")
        lines.append(
            f"| `{r['kernel']}` ({r['layout']}) | `{r['replaces']}` | "
            f"CUDA `{r['source']}` | {r['rows']} | {r['ms']:.3f} | "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) | "
            f"{100 * r['share']:.1f}% | {floor} | {r['small_ms']:.3f} | "
            f"{r['small_bound_ms']:.4f} | {r['plain_ms']:.2f} | none | "
            f"{r['launches_main_dispatch']} |")
    lines.append(
        f"| **main path** ({main['layout']}: "
        f"{', '.join(main['kernels'])}) | — | — | {main['rows']} | "
        f"{main['ms']:.3f} | {main['bound_ms']:.4f} ({main['bound_by']}) | "
        f"{100 * main['share']:.1f}% | — | — | — | — | — | "
        f"{main['launches_main_dispatch']} |")
    lines += ["", f"The main path: {main['samples_per_sec']:.4e} samples/s "
              f"for one dispatch of {main['rows']} rows.", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=8192)
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--iters", type=int, nargs=2, default=(2, 6),
                    metavar=("K1", "K2"), help="chain lengths of the slope")
    ap.add_argument("--plain-blocks", type=int, default=4,
                    help="blocks of the plain versions' shape")
    ap.add_argument("--out", default="ROOFLINE_GPU.md")
    ap.add_argument("--config", choices=sorted(_build.NUMEROLOGIES),
                    help="a named numerology's bench operating point in "
                    "place of the reference one")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tool_device(args.device, "roofline", timing=True)
    cfg = bench_point(DEFAULT_CONFIG.replace(
        **_build.NUMEROLOGIES.get(args.config, {})))
    line = card(dev).line
    k1, k2 = args.iters
    rows, main_row = measure(cfg, args.channels, args.blocks, k1, k2,
                             args.plain_blocks, dev)
    over = [f"{r['kernel']} ({r['layout']}): {100 * r[key]:.1f}%"
            for r in rows + [main_row] for key in ("share", "small_share")
            if r.get(key, 0) > 1.0]
    if over:
        print(f"roofline: a share over 100% means a bound or a timing is "
              f"wrong: {over}; {line}", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        f.write(markdown(rows, main_row, line, cfg, k1, k2))
    print(json.dumps({"metric": "kernel_roofline", **head(dev),
                      "config": f"{args.config or 'reference'} bench "
                      "operating point", "rows": rows,
                      "main_path": main_row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
