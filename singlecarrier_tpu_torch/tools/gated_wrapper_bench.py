"""``prod_rx_batch_gated`` against the full path, on the card.

Counterpart of ``tools/gated_wrapper_bench.py``::

    python3 -m singlecarrier_tpu_torch.tools.gated_wrapper_bench
        [--channels 8192] [--blocks 128] [--iters 8]
        [--max-detections 1024,8192] [--out GATED_WRAPPER_GPU.json]

The shipped wrapper, its state carried across ``--iters`` chained
dispatches of full-scale noise, against the main path
``prod_rx_batch(fuse_frontend=True)`` at the same geometry, both timed by
CUDA events after two warm-up dispatches.  For each capacity K
(``--max-detections``) the record gives the gate hits a dispatch
(``out["count"]``) and, where they exceed K, the overflow: the rows past
K are not decoded, so such a rate is of a truncated result.  Writes
``GATED_WRAPPER_GPU.json`` with the card's name and power limit.  Needs
the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import DEFAULT_CONFIG
from ..modem import (prod_rx_batch, prod_rx_batch_gated, prod_rx_gated_init,
                     prod_rx_init_planes)
from ._measure import SEED, bench_point, card_line, head, time_cuda
from ._measure import tool_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=8192)
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--max-detections", default="1024,8192",
                    help="capacities K, comma-separated")
    ap.add_argument("--out", default="GATED_WRAPPER_GPU.json")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tool_device(args.device, "gated_wrapper_bench", timing=True)
    line = card_line(dev)
    cfg = bench_point(DEFAULT_CONFIG)
    C, B = args.channels, args.blocks
    n, N = cfg.frame_size, C * B
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pcm = torch.randint(-16384, 16384, (B, C, n), generator=gen,
                        device=dev, dtype=torch.int16)

    state = [prod_rx_init_planes(cfg, C, dev)]

    def full():
        state[0], _ = prod_rx_batch(cfg, state[0], pcm, fuse_frontend=True)

    t_full = time_cuda(full, args.iters, warmup=2) / 1e3
    rep = {**head(dev), "config": "bench operating point", "channels": C,
           "blocks": B, "iters": args.iters, "t_full_s": t_full,
           "full_GSps": N * n / t_full / 1e9, "capacities": {}}
    print(f"[gated wrapper] full path {C} x {B}: {t_full * 1e3:.3f} ms a "
          f"dispatch, {rep['full_GSps']:.3f} GS/s; {line}", flush=True)
    for K in (int(k) for k in args.max_detections.split(",")):
        gstate, counts = [prod_rx_gated_init(cfg, C, dev)], []

        def wrapper():
            gstate[0], out = prod_rx_batch_gated(cfg, gstate[0], pcm,
                                                 max_detections=K)
            counts.append(out["count"])

        t = time_cuda(wrapper, args.iters, warmup=2) / 1e3
        hits = [int(c) for c in counts]
        over = max(0, max(hits) - K)
        rep["capacities"][str(K)] = {
            "max_detections": K, "t_wrapper_s": t,
            "wrapper_GSps": N * n / t / 1e9, "speedup_vs_full": t_full / t,
            "gate_hits_per_dispatch": hits, "overflowed": over > 0,
            "overflow_rows": over}
        print(f"[gated wrapper] max_detections={K}: {t * 1e3:.3f} ms a "
              f"dispatch, {N * n / t / 1e9:.3f} GS/s ({t_full / t:.3f}x the "
              f"full path); gate hits a dispatch {sorted(set(hits))}"
              + (f", OVERFLOWED by up to {over} rows (not decoded)"
                 if over else ", capacity holds them") + f"; {line}",
              flush=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps({"record": args.out, "card": rep["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
