"""Partitioning overhead on one card: the same work unpartitioned and
partitioned.

Counterpart of ``tools/scaling_bench.py``::

    python3 -m singlecarrier_tpu_torch.tools.scaling_bench
        [--sizes 512x8,8192x128] [--iters 3] [--shards 2,4] [--no-gloo]
        [--out SCALING_GPU.md]

For each size (channels x blocks a dispatch, ``--iters`` chained
dispatches of full-scale noise at the bench operating point, one
``synchronize``) the same work runs as the main path
``prod_rx_batch(fuse_frontend=True)`` (unpartitioned) and partitioned:
``make_fused_sharded_rx`` on a one-rank NCCL group; ``_grid_shard`` for
every time shard in one process (``--shards``, each shard rebuilding its
carry from its halo block); and two gloo processes on the one card,
``make_fused_grid_sharded_rx`` at (ch=1, time=2), whose halos go through
host buffers (NCCL takes one rank a card).  The overhead column is the
partitioned wall over the unpartitioned one, less 1.  More than one card
is not measured: this card is the only one.  Writes ``SCALING_GPU.md``
and prints one JSON line; needs the card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from .. import DEFAULT_CONFIG
from ..modem import ProdRxOut, prod_rx_batch, prod_rx_init_planes
from ._measure import (SEED, bench_point, card_line, frames, golden_stream,
                       head, require, tool_device, wall)


def cat_outs(outs, dim=0) -> ProdRxOut:
    """Outputs of consecutive calls, joined along ``dim``."""
    return ProdRxOut(*(torch.cat(xs, dim) for xs in zip(*outs)))


def grid(cfg, frames_, n_t: int, descramble: bool = False) -> list:
    """``_grid_shard`` for every time shard of ``frames_`` [B, C, n] in one
    process, each halo cut from the frames themselves: the shards'
    outputs in order."""
    from ..parallel.sharded_rx import _grid_shard
    b = frames_.shape[0] // n_t
    halo = cfg.ntaps - 1
    outs = []
    for t in range(n_t):
        prev = frames_[t * b - 1] if t else torch.zeros_like(frames_[0])
        pre = (frames_[t * b - 2, :, -halo:] if t
               else torch.zeros_like(frames_[0, :, :halo]))
        outs.append(_grid_shard(cfg, frames_[t * b:(t + 1) * b], prev, pre,
                                t, n_t, descramble=descramble))
    return outs


def gloo_rank(rank: int, init: str, work: str, opts: dict) -> None:
    """One of ``opts["world"]`` gloo processes on card 0.  With
    ``opts["golden"]`` (the golden fixture's path): the golden stream at
    every delay on ``opts["golden_channels"]`` channels x 2 dispatches of
    ``opts["golden_blocks"]``, through ``make_fused_grid_sharded_rx`` at
    (ch=1, time=world) on the first 1/world of the channels and
    ``make_fused_sharded_rx`` at ch=world on all of them.  Then the
    grid's wall on ``opts["rate_blocks"]`` x ``opts["rate_channels"]``
    blocks of noise, ``opts["iters"]`` chained dispatches, and the halo
    exchange alone.  Everything is saved to ``work`` for the parent."""
    import torch.distributed as dist

    from ..ops import _build
    from ..parallel import (make_fused_grid_sharded_rx, make_fused_sharded_rx,
                            make_mesh, multihost, shard_plane_state)
    from ..parallel.mesh import shift_right
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = opts["world"]
    multihost.initialize(init, world, rank, backend="gloo")
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        cfg = bench_point(DEFAULT_CONFIG)
        n = cfg.frame_size
        mesh_t = make_mesh(ch=1, time=world)
        res = {}
        if opts.get("golden"):
            golden = np.load(opts["golden"])
            tx = torch.from_numpy(golden["tx_pcm"].astype(np.int16)).to(dev)
            C, B = opts["golden_channels"], opts["golden_blocks"]
            offsets = torch.arange(C, device=dev) % n
            gframes = frames(golden_stream(tx, C, 2 * B * n, offsets, dev),
                             2 * B, n)
            _build.reset_launches()
            g = make_fused_grid_sharded_rx(cfg, mesh_t, descramble=False)(
                gframes[:, :C // world])
            mesh_c = make_mesh(ch=world)
            fn = make_fused_sharded_rx(cfg, mesh_c, descramble=False)
            st = shard_plane_state(prod_rx_init_planes(cfg, C), mesh_c)
            outs = []
            for part in (gframes[:B], gframes[B:]):
                st, out = fn(st, part)
                outs.append(out)
            torch.cuda.synchronize()
            res.update(grid=tuple(x.cpu() for x in g),
                       fused=tuple(x.cpu() for x in cat_outs(outs)),
                       launches=dict(_build.LAUNCHES))
            del gframes, g, outs, st

        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 17)
        noise = torch.randint(-16384, 16384, (opts["rate_blocks"],
                                              opts["rate_channels"], n),
                              generator=gen, device=dev, dtype=torch.int16)
        gfn = make_fused_grid_sharded_rx(cfg, mesh_t)
        gfn(noise)                                          # warm-up
        dist.barrier()
        res["wall"] = wall(lambda: [gfn(noise)
                                    for _ in range(opts["iters"])])
        halo = cfg.ntaps - 1
        sent = torch.cat([noise[-2, :, n - halo:], noise[-1]], -1)
        shift_right(sent, mesh_t)
        dist.barrier()
        xch = wall(lambda: [shift_right(sent, mesh_t)
                            for _ in range(opts["exchanges"])])
        res.update(exchange_s=xch / opts["exchanges"],
                   exchange_bytes=sent.numel() * sent.element_size())
        torch.save(res, os.path.join(work, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def gloo_ranks(work: str, opts: dict) -> list:
    """Run :func:`gloo_rank` in ``opts["world"]`` spawned processes joined
    by a gloo group on a ``tcp://127.0.0.1`` store; every one must exit
    0.  Returns their saved results."""
    from ..parallel.mesh import _free_port
    init = f"127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank, args=(r, init, work, opts))
             for r in range(opts["world"])]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    require(all(c == 0 for c in codes),
            f"the gloo processes exited with {codes}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), map_location="cpu",
                       weights_only=False) for r in range(opts["world"])]


def measure(cfg, C: int, B: int, iters: int, shards, gloo: bool, dev,
            work: str) -> dict:
    """The same work (``iters`` chained dispatches of ``B`` x ``C`` blocks
    of noise) unpartitioned and partitioned: {rows, per-path walls}."""
    import torch.distributed as dist

    from ..parallel import make_fused_sharded_rx, make_mesh, shard_plane_state
    n = cfg.frame_size
    samples = iters * B * C * n
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    noise = torch.randint(-16384, 16384, (B, C, n), generator=gen,
                          device=dev, dtype=torch.int16)

    def main_path():
        st = prod_rx_init_planes(cfg, C, dev)
        for _ in range(iters):
            st, _ = prod_rx_batch(cfg, st, noise, fuse_frontend=True)

    rows = []
    mesh = make_mesh(device=dev)
    try:
        fn = make_fused_sharded_rx(cfg, mesh)

        def one_rank():
            st = shard_plane_state(prod_rx_init_planes(cfg, C, dev), mesh)
            for _ in range(iters):
                st, _ = fn(st, noise)

        main_path()                                   # warm-ups
        one_rank()
        walls = {"main": [], "one": []}
        for tag, f in (("main", main_path), ("one", one_rank),
                       ("one", one_rank), ("main", main_path)):
            walls[tag].append(wall(f))
    finally:
        dist.destroy_process_group()
    base = min(walls["main"])
    rows.append(("unpartitioned: prod_rx_batch(fuse_frontend=True)", 1,
                 base, walls["main"]))
    rows.append(("make_fused_sharded_rx, one NCCL rank", 1,
                 min(walls["one"]), walls["one"]))
    for n_t in shards:
        if B % n_t:
            continue
        grid(cfg, noise, n_t, True)                   # warm-up
        w = wall(lambda: [grid(cfg, noise, n_t, True)
                          for _ in range(iters)])
        rows.append((f"_grid_shard x {n_t} time shards, one process "
                     f"({B // n_t} blocks + the halo block each)", n_t, w,
                     [w]))
    xch = None
    if gloo and B % 2 == 0:
        ranks = gloo_ranks(work, {"world": 2, "rate_blocks": B,
                                  "rate_channels": C, "iters": iters,
                                  "exchanges": 10})
        w = max(r["wall"] for r in ranks)
        rows.append(("two gloo processes on card 0, "
                     "make_fused_grid_sharded_rx (ch=1, time=2)", 2, w,
                     [r["wall"] for r in ranks]))
        xch = {"bytes": ranks[0]["exchange_bytes"],
               "ms_sending": 1e3 * ranks[0]["exchange_s"],
               "ms_receiving": 1e3 * ranks[1]["exchange_s"]}
    out = [{"path": p, "shards": k, "channels": C, "blocks": B,
            "iters": iters, "wall_s": w, "walls_s": ws,
            "samples_per_sec": samples / w,
            "overhead_pct": 100.0 * (w / base - 1.0)}
           for p, k, w, ws in rows]
    return {"rows": out, "halo_exchange": xch}


def table(rows) -> str:
    lines = ["| path | shards | channels x blocks x dispatches | wall s | "
             "samples/s | overhead vs unpartitioned |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['path']} | {r['shards']} | {r['channels']} x "
                     f"{r['blocks']} x {r['iters']} | {r['wall_s']:.4f} | "
                     f"{r['samples_per_sec']:.4e} | "
                     f"{r['overhead_pct']:+.1f}% |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="512x8,8192x128",
                    help="channels x blocks a dispatch, comma-separated")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--shards", default="2,4")
    ap.add_argument("--no-gloo", action="store_true",
                    help="leave out the two gloo processes")
    ap.add_argument("--out", default="SCALING_GPU.md")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tool_device(args.device, "scaling_bench", timing=True)
    line = card_line(dev)
    cfg = bench_point(DEFAULT_CONFIG)
    shards = [int(s) for s in args.shards.split(",") if s]
    work = tempfile.mkdtemp(prefix="scaling_bench_")
    results = {}
    try:
        for size in args.sizes.split(","):
            C, B = (int(v) for v in size.lower().split("x"))
            results[size] = measure(cfg, C, B, args.iters, shards,
                                    not args.no_gloo, dev, work)
            print(f"[scaling] {size}\n{table(results[size]['rows'])}\n"
                  f"halo exchange: {results[size]['halo_exchange']}; "
                  f"{line}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = {"metric": "partitioning_overhead", **head(dev),
           "config": "bench operating point", "sizes": results,
           "cards_measured": 1,
           "more_than_one_card": "not measured: one card"}
    print(json.dumps(rec), flush=True)
    md = ["# Scaling on one card (the same work unpartitioned and "
          "partitioned)", "",
          f"Card: {line} (`nvidia-smi`); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}.  Written by `python3 -m "
          f"singlecarrier_tpu_torch.tools.scaling_bench`.  Full-scale noise "
          f"at the bench operating point, chained dispatches and one "
          f"`synchronize` per measurement; the unpartitioned and the "
          f"one-rank runs in the order main, sharded, sharded, main (the "
          f"faster of each pair kept).  Overhead: partitioned wall over "
          f"unpartitioned wall, less 1.  NCCL takes one rank a card, so "
          f"two ranks on this card run under gloo, their halos through "
          f"host buffers.  **More than one card is not measured**: NCCL "
          f"between cards and halos over NVLink need a machine with "
          f"them.", ""]
    for size, res in results.items():
        md += [f"## {size} (channels x blocks a dispatch)", "",
               table(res["rows"]), ""]
        if res["halo_exchange"]:
            x = res["halo_exchange"]
            md += [f"Halo exchange alone on the gloo run: "
                   f"{x['bytes'] / 1e6:.1f} MB a dispatch, "
                   f"{x['ms_sending']:.2f} ms sending, "
                   f"{x['ms_receiving']:.2f} ms receiving (D2H, gloo over "
                   f"loopback TCP, H2D).", ""]
    with open(args.out, "w") as f:
        f.write("\n".join(md))
    return 0


if __name__ == "__main__":
    sys.exit(main())
