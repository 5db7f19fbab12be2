"""Multi-process runner utilities.

Counterpart of ``singlecarrier_tpu/parallel/multihost.py``.  The
reference is a single process (SURVEY.md: zero distributed code);
scaling past one card runs one process per card, wired into one
``torch.distributed`` group, with the global mesh over all of its
ranks.  Each process feeds the channels whose shard it owns
(:func:`host_local_channels`) and keeps them on its own device.

Launch, one command per process (or ``torchrun``, which sets the
rank, world size and store itself)::

    python -m singlecarrier_tpu_torch.parallel.multihost \\
        --coordinator=10.0.0.1:8476 --num-processes=4 --process-id=$ID

The card of process ``ID`` is ``ID % torch.cuda.device_count()``;
``--device cpu`` runs the ranks on the host with gloo.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import backend_for, local_device, make_mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               backend: str | None = None) -> None:
    """Join the process group at ``coordinator`` (``host:port``, a TCP
    store on process 0); a no-op without one (single process).

    ``device``: the card unless it says otherwise (``"cpu"``), which
    raises where there is no card; on the card this process takes card
    ``process_id % torch.cuda.device_count()`` first.  ``backend``
    follows the device (NCCL for the card, gloo for the CPU) unless
    given: gloo with CUDA tensors keeps them on the card and moves the
    halos through host buffers.
    """
    if coordinator is None:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend or backend_for(dev),
                            init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)


def global_mesh(time: int = 1, *, device=None):
    """The ``(ch, time)`` mesh over every process's rank."""
    return make_mesh(time=time, device=device)


def host_local_channels(n_channels_global: int) -> slice:
    """The contiguous channel range this process feeds (channel-major
    over the ranks of the default group; all of them without one)."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    per = n_channels_global // count
    return slice(index * per, (index + 1) * per)


def make_global_pcm(mesh, pcm_local) -> torch.Tensor:
    """This process's channel block of the global [channels, ...] PCM
    (numpy or a tensor) on its device: its shard of the array JAX
    assembles from every process's block."""
    return torch.as_tensor(pcm_local).to(local_device(mesh))


def main(argv=None) -> int:
    """Multi-process end-to-end check: every process feeds its channel
    block of a real modulated packet stream into the channel-sharded RX,
    then verifies the decoded payload bits of its own channels against
    the (seed-shared) sent bits.

    Exit code 0 = every local channel decoded every packet error-free.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None,
                    help="global channel count (default: 1 per rank)")
    ap.add_argument("--packets", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cpu to run the ranks on the host (gloo); the "
                         "card by default (NCCL)")
    args = ap.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id,
               device=args.device)
    from ..config import DEFAULT_CONFIG as cfg
    from ..modem.rx_production import prod_rx_init
    from ..modem.tx import tx_stream
    from .mesh import device_count
    from .sharded_rx import make_channel_sharded_rx, shard_channel_state

    dev = resolve_device(args.device)
    mesh = global_mesh(device=dev)
    try:
        n_channels = args.channels or device_count()
        fn = make_channel_sharded_rx(cfg, mesh, descramble=False)

        # deterministic payload, identical on every process (shared seed)
        rng = np.random.default_rng(42)
        bits = rng.integers(0, 2, (args.packets, cfg.ns,
                                   cfg.data_symbols * 2), dtype=np.uint8)
        stream = tx_stream(cfg, bits, flush_gap=True, device="cpu").numpy()
        n_blocks = -(-len(stream) // cfg.frame_size)
        buf = np.zeros(n_blocks * cfg.frame_size, np.int16)
        buf[:len(stream)] = stream
        blocks = buf.reshape(n_blocks, cfg.frame_size)

        sl = host_local_channels(n_channels)
        local = np.broadcast_to(
            blocks[None], (sl.stop - sl.start, n_blocks, cfg.frame_size)
        ).copy()
        pcm = make_global_pcm(mesh, local)
        state = shard_channel_state(
            prod_rx_init(cfg, (n_channels,), device=dev), mesh)
        state, out = fn(state, pcm)

        # verify this process's channels: each must decode every packet
        # bit-exactly (clean loopback channel)
        ref = bits.reshape(args.packets, cfg.bits_per_frame)
        valid, got = out.valid.cpu().numpy(), out.bits.cpu().numpy()
        ok = True
        for c in range(valid.shape[0]):
            vidx = np.nonzero(valid[c])[0]
            if len(vidx) != args.packets:
                ok = False
                continue
            for i, fr in enumerate(vidx):
                if not np.array_equal(got[c, fr], ref[i]):
                    ok = False
        rank, world = dist.get_rank(), dist.get_world_size()
        print(f"[process {rank}/{world}] "
              f"{'VERIFIED' if ok else 'MISMATCH'}: {valid.shape[0]} local "
              f"channels x {args.packets} packets over {world} ranks "
              f"({dev})", flush=True)
        # re-align before exit: the verification takes its own time on
        # each process, and a rank that leaves early would tear down the
        # store under the others
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
