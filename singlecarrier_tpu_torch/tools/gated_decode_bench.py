"""The gated two-phase decode's constituents on the card, and its
break-even detection density.

Counterpart of ``tools/gated_decode_bench.py``::

    python3 -m singlecarrier_tpu_torch.tools.gated_decode_bench
        [--channels 8192] [--blocks 128] [--iters 8]
        [--subset-fracs 0.001,0.1,0.33,0.67,1.0] [--skip-verify]
        [--out GATED_DECODE_GPU.json]

Phase 1 is ``fused_rx_block(stage="gate")`` (K1, K2 and the gate stage:
front-end, hunt, extraction and energy gate, the decode tail not run);
the compaction is ``modem/rx_gated._pair_operands`` (a stable argsort of
the gate flags and the gathers of each row's (prev, cur) PCM pair with
its closed-form phase and FIR-tail seeds); phase 2 is ``fused_rx_block``
over the compacted [2, K] pairs, whose block-1 rows are the decode.

First the verify step: on a packet stream (16 payloads tiled over
``--verify-channels`` channels, 8 blocks), phase 2 at full capacity must
give every gated row of the full path with the same dibits and matches,
and every valid row the same lag and phase; a mismatch exits 1 before
any timing.  Then, on full-scale noise at ``--channels`` x ``--blocks``,
the full path and phase 1 chained with the state carried (T_full,
T_gate), and at each subset fraction K = fraction x rows (at least 128):
the compaction alone (T_compact) and with phase 2 (T_phase2(K)), all by
CUDA events; the two-phase time T_gate + T_phase2(K), its rate and its
speedup over the full path, and the break-even fraction where the two
meet.  Writes ``GATED_DECODE_GPU.json`` with the card's name and power
limit.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import DEFAULT_CONFIG
from ..modem import prod_rx_init_planes
from ..modem.rx_gated import _pair_operands
from ..modem.tx import tx_stream
from ..ops.fused_rx import fused_rx_block
from ._measure import SEED, bench_point, card_line, head, require, time_cuda
from ._measure import tool_device


def phase2(cfg, pairs, pr, pi, tl_r, tl_i, K: int) -> dict:
    """``fused_rx_block`` over the [2, K] pairs from zero planes: the
    block-1 rows, the decode of the compacted detections."""
    dp0 = torch.zeros((cfg.cycles, 2, K, cfg.symbols_per_block),
                      dtype=(torch.bfloat16 if cfg.decim_dtype == "bf16"
                             else torch.float32), device=pairs.device)
    dec, _, _ = fused_rx_block(cfg, pairs, pr, pi, tl_r, tl_i, dp0)
    return {k: v[K:] for k, v in dec.items()}


def verify(cfg, C: int, B: int, dev) -> dict:
    """Phase 2 at full capacity against the full path on a packet stream
    of ``C`` channels x ``B`` blocks: every gated row's dibits and
    matches equal, every valid row's lag and phase equal."""
    n = cfg.frame_size
    rng = np.random.default_rng(SEED)
    bits = rng.integers(0, 2, (min(C, 16), 4, cfg.ns, 2 * cfg.data_symbols),
                        dtype=np.uint8)
    pcm = tx_stream(cfg, bits, flush_gap=True, scramble=True, device=dev)
    pcm = torch.nn.functional.pad(pcm, (0, max(0, B * n - pcm.shape[-1])))
    pcm = pcm[:, :B * n].repeat(-(-C // pcm.shape[0]), 1)[:C]
    frames = pcm.reshape(C, B, n).transpose(0, 1).contiguous()
    st = prod_rx_init_planes(cfg, C, dev)
    full, _, _ = fused_rx_block(cfg, frames, *st)
    gate, _, _ = fused_rx_block(cfg, frames, *st, stage="gate")
    K = B * C
    zeros = torch.zeros((C, n), dtype=torch.int16, device=dev)
    pairs, pr, pi, tl_r, tl_i, order, _, _ = _pair_operands(
        cfg, gate["gated"].reshape(B, C), frames, st[0], st[1], K, zeros,
        zeros[:, :cfg.ntaps - 1])
    dec2 = phase2(cfg, pairs, pr, pi, tl_r, tl_i, K)
    nk = int(gate["gated"].sum())
    j = order[:nk]
    same = ((dec2["dibits"][:nk] == full["dibits"][j]).all(1)
            & (dec2["matches"][:nk] == full["matches"][j])
            & full["gated"][j])
    valid = full["gated"][j] & (full["matches"][j] > cfg.match_threshold)
    where = (dec2["lag"][:nk] == full["lag"][j]) & (
        dec2["phase_idx"][:nk] == full["phase_idx"][j])
    rep = {"channels": C, "blocks": B, "detections": nk,
           "bit_identical": int(same.sum()),
           "mismatched": int((~same).sum()),
           "valid": int(valid.sum()),
           "valid_lag_phase_equal": int((where & valid).sum())}
    require(nk > 0 and rep["mismatched"] == 0
            and rep["valid_lag_phase_equal"] == rep["valid"]
            and torch.equal(gate["gated"], full["gated"]),
            f"verify: phase 2 differs from the full path: {rep}")
    return rep


def break_even(t_full: float, t_gate: float, phase2_rows: dict):
    """The subset fraction at which T_gate + T_phase2 reaches T_full, by
    linear interpolation between the measured fractions (None if the two
    phases stay faster, or are slower already at the smallest)."""
    pts = sorted((float(f), r["t_compact_decode_s"])
                 for f, r in phase2_rows.items())
    for (f0, t0), (f1, t1) in zip(pts, pts[1:]):
        a, b = t_gate + t0 - t_full, t_gate + t1 - t_full
        if a <= 0 < b:
            return f0 + (f1 - f0) * (-a) / (b - a)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=8192)
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--subset-fracs", default="0.001,0.1,0.33,0.67,1.0")
    ap.add_argument("--verify-channels", type=int, default=128)
    ap.add_argument("--skip-verify", action="store_true")
    ap.add_argument("--out", default="GATED_DECODE_GPU.json")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tool_device(args.device, "gated_decode_bench", timing=True)
    line = card_line(dev)
    cfg = bench_point(DEFAULT_CONFIG)
    C, B = args.channels, args.blocks
    n, N = cfg.frame_size, args.channels * args.blocks
    rep = {**head(dev), "config": "bench operating point", "channels": C,
           "blocks": B, "iters": args.iters}
    if not args.skip_verify:
        rep["verify"] = verify(cfg, args.verify_channels, 8, dev)
        print(f"[gated] verify: {rep['verify']}; {line}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pcm = torch.randint(-16384, 16384, (B, C, n), generator=gen,
                        device=dev, dtype=torch.int16)

    def chained(stage):
        state = [prod_rx_init_planes(cfg, C, dev)]

        def one():
            dec, dlast, fin = fused_rx_block(cfg, pcm, *state[0],
                                             stage=stage)
            state[0] = (*fin, dlast)
        return one

    t_full = time_cuda(chained("full"), args.iters, warmup=2) / 1e3
    t_gate = time_cuda(chained("gate"), args.iters, warmup=2) / 1e3
    rep.update(t_full_s=t_full, t_gate_s=t_gate,
               full_GSps=N * n / t_full / 1e9,
               gate_GSps=N * n / t_gate / 1e9)
    print(f"[gated] {C} x {B} noise: full {t_full * 1e3:.3f} ms "
          f"({rep['full_GSps']:.3f} GS/s), gate only {t_gate * 1e3:.3f} ms "
          f"({rep['gate_GSps']:.3f} GS/s); {line}", flush=True)

    st0 = prod_rx_init_planes(cfg, C, dev)
    gated = fused_rx_block(cfg, pcm, *st0, stage="gate")[0]["gated"]
    rep["noise_gated_rows"] = int(gated.sum())
    gated = gated.reshape(B, C)
    zeros = torch.zeros((C, n), dtype=torch.int16, device=dev)
    tails = zeros[:, :cfg.ntaps - 1]
    rep["phase2"] = {}
    for frac in (float(f) for f in args.subset_fracs.split(",")):
        K = max(128, int(N * frac) // 128 * 128)

        def compact():
            return _pair_operands(cfg, gated, pcm, st0[0], st0[1], K, zeros,
                                  tails)

        def compact_decode():
            return phase2(cfg, *compact()[:5], K)

        t_c = time_cuda(compact, args.iters) / 1e3
        t_cd = time_cuda(compact_decode, args.iters) / 1e3
        two = t_gate + t_cd
        rep["phase2"][str(frac)] = {
            "K": K, "t_compact_s": t_c, "t_compact_decode_s": t_cd,
            "t_two_phase_s": two, "two_phase_GSps": N * n / two / 1e9,
            "speedup_vs_full": t_full / two}
        print(f"[gated] fraction {frac}: K={K} compact {t_c * 1e3:.3f} ms, "
              f"compact + phase 2 {t_cd * 1e3:.3f} ms, two-phase "
              f"{N * n / two / 1e9:.3f} GS/s ({t_full / two:.3f}x the full "
              f"path); {line}", flush=True)
    rep["break_even_fraction"] = break_even(t_full, t_gate, rep["phase2"])
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps({"record": args.out, "card": rep["card"],
                      "break_even_fraction": rep["break_even_fraction"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
