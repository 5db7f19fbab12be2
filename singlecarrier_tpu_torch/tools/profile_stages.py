"""Cumulative stage prefixes of the RX paths on the card.

Counterpart of ``tools/profile_stages.py``::

    python3 -m singlecarrier_tpu_torch.tools.profile_stages
        [--batch | --fused | --one-kernel] [--channels 4096] [--blocks 16]
        [--iters 4] [--warmup 2] [--stages a,b,...] [knob overrides]
        [--decode-stages]

Each stage runs a prefix of a path's work over ``--blocks`` x
``--channels`` blocks of full-scale noise, timed by CUDA events over
``--iters`` calls after ``--warmup``; differences between consecutive
rows are the stages' costs, in microseconds per block-channel (1880
samples):

* default, the plane body of ``prod_rx_stream_pallas`` (one block at a
  time, the state carried): ``frontend`` (``fused_frontend_decim``,
  transposed planes), ``hunt`` (+ K2 ``hunt``), ``extract`` (+
  ``extract_gate``: extraction and the energy gate, the decode tail not
  run), ``full`` (``extract_decode`` in its place);
* ``--batch``, the unfused batch path ``prod_rx_batch(fuse_hunt=False,
  fuse_extract=False)``: ``frontend`` (the per-row phases and tails and
  ``fused_frontend_decim``, row-major f32 planes), ``hunt`` (+ the plain
  ``_hunt_planes``), ``extract`` (+ ``_extract_packet_planes``), ``full``
  (+ ``fused_decode``);
* ``--fused``, the two-kernel batch path ``prod_rx_batch(fuse_frontend=
  False)``: ``frontend`` (transposed planes), ``hunt``, ``extract``
  (``extract_gate``), ``full`` (``extract_decode``);
* ``--one-kernel``, the main path ``prod_rx_batch(fuse_frontend=True)``:
  ``fe`` (K1 ``frontend_decim``), ``hunt`` (K1 + K2), ``full`` (K1 + K2
  + K3 ``extract_decode``).

``--decode-stages`` runs ``kernel_ab --stages`` (K3's ``clock64()``
stage split and the front-ends' staging / tap-sum split) at 8192 x
``--blocks``.  The TPU tool's ``--fe-block`` and ``--decode-block`` size
Pallas blocks and have no counterpart.  Prints the table and one JSON
line with the card's name and power limit.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import DEFAULT_CONFIG
from ..modem import prod_rx_init_planes
from ..modem.rx_production import _extract_packet_planes, _hunt_planes
from ..ops.decode import extract_decode, extract_gate, fused_decode, hunt
from ..ops.frontend import frontend_decim, fused_frontend_decim
from ..ops.fused_rx import _advances
from ._measure import SEED, card, head, row_inputs, time_cuda, tool_device

MODES = {"scan": ("frontend", "hunt", "extract", "full"),
         "batch": ("frontend", "hunt", "extract", "full"),
         "fused": ("frontend", "hunt", "extract", "full"),
         "one-kernel": ("fe", "hunt", "full")}


def _tail(cfg, stage, decim_t, dprev_t, lag, ph, peak):
    """The stage after the hunt on transposed planes: the gate stage
    (``extract``) or the decode (``full``)."""
    if stage == "extract":
        return extract_gate(cfg, decim_t, dprev_t, lag, ph, peak)
    return extract_decode(cfg, decim_t, dprev_t, lag, ph, peak)


def step(mode: str, stage: str, cfg, noise, planes):
    """A call that runs ``mode``'s prefix up to ``stage`` over ``noise``
    [B, C, n] from the plane state ``planes``."""
    B, C, n = noise.shape
    p0r, p0i, t0r, t0i, dprev0 = planes
    adv = _advances(cfg, B, noise.device)[1]
    order = MODES[mode]
    upto = order.index(stage)

    if mode == "scan":
        def run():
            pr, pi_, tr, ti, dprev_t = p0r, p0i, t0r, t0i, dprev0
            for pcm in noise:
                dcur_t, tr, ti, pr, pi_ = fused_frontend_decim(
                    cfg, pcm, pr, pi_, tr, ti, transposed=True)
                if upto >= 1:
                    lag, ph, peak = hunt(cfg, dcur_t, dprev_t)
                if upto >= 2:
                    _tail(cfg, stage, dcur_t, dprev_t, lag, ph, peak)
                dprev_t = dcur_t
        return run

    if mode == "one-kernel":
        def run():
            dk = frontend_decim(cfg, noise, p0r, p0i, t0r, t0i, adv)
            if upto >= 1:
                lag, ph, peak = hunt(cfg, dk, dprev0)
            if upto >= 2:
                extract_decode(cfg, dk, dprev0, lag, ph, peak)
        return run

    if mode == "fused":
        def run():
            rows = row_inputs(cfg, noise, p0r, p0i, t0r, t0i, adv)
            dcur_t = fused_frontend_decim(cfg, *rows, transposed=True)[0]
            if upto >= 1:
                lag, ph, peak = hunt(cfg, dcur_t, dprev0)
            if upto >= 2:
                _tail(cfg, stage, dcur_t, dprev0, lag, ph, peak)
        return run

    # batch: row-major f32 planes, the plain hunt and extraction
    n_sym = cfg.symbols_per_block
    dprev_rows = dprev0.float().permute(2, 0, 1, 3)[None]    # [1, C, ...]

    def run():
        rows = row_inputs(cfg, noise, p0r, p0i, t0r, t0i, adv)
        dcur = fused_frontend_decim(cfg, *rows)[0]
        if upto < 1:
            return
        decim = dcur.reshape(B, C, cfg.cycles, 2, n_sym)
        dprev = torch.cat([dprev_rows, decim[:-1]], 0)
        windows = torch.cat([dprev, decim], -1).reshape(
            B * C, cfg.cycles, 2, 2 * n_sym)
        lag, ph, peak = _hunt_planes(cfg, windows)
        if upto < 2:
            return
        pkt = _extract_packet_planes(cfg, windows, lag, ph)
        if upto < 3:
            return
        fused_decode(cfg, pkt[:, 0].contiguous(), pkt[:, 1].contiguous(),
                     peak)
    return run


_OVERRIDES = ("frontend_dtype", "decim_dtype", "cfo_dtype", "hunt_dtype",
              "ls_gram", "hunt_norm", "ls_refit_symbols")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=4096)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--stages", default="",
                    help="comma-separated prefixes (default: all)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--batch", action="store_true")
    mode.add_argument("--fused", action="store_true")
    mode.add_argument("--one-kernel", action="store_true")
    ap.add_argument("--decode-stages", action="store_true",
                    help="kernel_ab --stages at 8192 x --blocks")
    ap.add_argument("--frontend-dtype", choices=["bf16", "f32"])
    ap.add_argument("--decim-dtype", choices=["f32", "bf16"])
    ap.add_argument("--cfo-dtype", choices=["f32", "bf16"])
    ap.add_argument("--hunt-dtype", choices=["bf16", "f32", "int8"])
    ap.add_argument("--ls-gram", choices=["direct", "sliding"])
    ap.add_argument("--hunt-norm", choices=["energy", "espan", "none"])
    ap.add_argument("--refit-symbols", dest="ls_refit_symbols", type=int)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tool_device(args.device, "profile_stages", timing=True)
    line = card(dev).line
    if args.decode_stages:
        from .. import kernel_ab
        return kernel_ab.main(["--stages", "--blocks", str(args.blocks)])
    cfg = DEFAULT_CONFIG.replace(**{k: getattr(args, k) for k in _OVERRIDES
                                    if getattr(args, k) is not None})
    mode_name = ("batch" if args.batch else "fused" if args.fused
                 else "one-kernel" if args.one_kernel else "scan")
    stages = (args.stages.split(",") if args.stages
              else list(MODES[mode_name]))
    C, B = args.channels, args.blocks
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    noise = torch.randint(-16384, 16384, (B, C, cfg.frame_size),
                          generator=gen, device=dev, dtype=torch.int16)
    planes = prod_rx_init_planes(cfg, C, dev)
    ms = {s: time_cuda(step(mode_name, s, cfg, noise, planes), args.iters,
                       args.warmup) for s in stages}
    print(f"[profile_stages] {mode_name}, {C} channels x {B} blocks; "
          f"{line}")
    print(f"{'stage':>10} {'ms':>9} {'us/blk-ch':>10} {'delta_us':>9} "
          f"{'GS/s':>7}")
    prev, us = 0.0, {}
    for s in stages:
        us[s] = ms[s] * 1e3 / (C * B)
        print(f"{s:>10} {ms[s]:9.3f} {us[s]:10.4f} {us[s] - prev:9.4f} "
              f"{C * B * cfg.frame_size / ms[s] / 1e6:7.3f}")
        prev = us[s]
    print(json.dumps({"metric": "stage_prefixes", **head(dev),
                      "mode": mode_name, "channels": C, "blocks": B,
                      "iters": args.iters, "ms": ms,
                      "us_per_block_channel": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
