"""Failure detection and elastic recovery.

Counterpart of ``singlecarrier_tpu/runtime/failover.py``.  The reference
has no failure handling of any kind -- a fault kills the process and
all demodulator state with it (static globals throughout; SURVEY.md
section 5).  Here the per-channel state is an explicit structure of
tensors that is checkpointed between streaming blocks
(runtime/checkpoint.py), which makes recovery a replay problem: restore
the last good state, re-feed the blocks since, continue.  The pieces:

 * ``health_check`` -- a device-side count of the non-finite values in
   every floating leaf of a state (a diverged fit or a memory fault
   shows up as inf/nan in the carried state long before the bits), one
   scalar to the host.
 * ``Heartbeat`` / ``monitor_heartbeats`` -- file-based liveness for
   multi-process runs: every process stamps a beat each block; a stale
   stamp marks the process failed so a supervisor can restart it and
   resume from the checkpoint.
 * ``ElasticDemodulator`` -- a supervisor around the streaming demod
   loop: periodic checkpoints, per-block health verdicts, and restore
   and replay when a block raises or corrupts the state.

Recovery is exact: the demod step is ``(state, pcm) -> (state, out)``
with no hidden state, so replaying blocks ``k..n`` from checkpoint ``k``
reproduces the original outputs bit for bit.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import ModemConfig
from ..modem.rx_production import ProdRxOut, prod_rx_frame, prod_rx_init
from .checkpoint import restore_state, save_state
from .validate import _leaves


# --------------------------------------------------------------------- health

def health_check(state) -> int:
    """Non-finite scalar count in ``state`` (0 == healthy).

    Every floating leaf (complex ones by parts, bf16 included) is
    counted on its device and the counts summed there; the one
    ``.item()`` is the only transfer.  Integer leaves count 0.
    """
    counts = [(~torch.isfinite(x)).sum() for _, x in _leaves(state)
              if x.is_floating_point() or x.is_complex()]
    if not counts:
        return 0
    return int(torch.stack(counts).sum().item())


# ------------------------------------------------------------------ heartbeat

def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Heartbeat:
    """File-based per-process liveness stamp.

    Each process writes ``<dir>/hb_<process_id>.json`` once per block (an
    atomic rename, safe on shared filesystems).  Any observer calls
    ``monitor_heartbeats`` to list stale processes.  ``process_id``
    defaults to the ``torch.distributed`` rank when a process group is
    initialized, else 0.
    """

    def __init__(self, directory: str, process_id: Optional[int] = None):
        self.directory = directory
        self.process_id = (_process_index()
                           if process_id is None else process_id)
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"hb_{self.process_id}.json")
        self._beats = 0

    def beat(self, *, step: int = 0, extra: Optional[dict] = None) -> None:
        payload = {"process_id": self.process_id, "time": time.time(),
                   "step": step, "beats": self._beats}
        if extra:
            payload.update(extra)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)
        self._beats += 1


def monitor_heartbeats(directory: str, *,
                       timeout_s: float = 30.0) -> Dict[int, dict]:
    """Read every heartbeat in ``directory``; mark each ``stale`` if its
    stamp is older than ``timeout_s``.  Returns {process_id: record}."""
    now = time.time()
    out: Dict[int, dict] = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("hb_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        rec["age_s"] = now - rec.get("time", 0.0)
        rec["stale"] = rec["age_s"] > timeout_s
        out[int(rec.get("process_id", -1))] = rec
    return out


def failed_processes(directory: str, *, timeout_s: float = 30.0) -> list:
    """Process ids whose heartbeat is stale (candidates for restart)."""
    return sorted(pid for pid, rec in
                  monitor_heartbeats(directory, timeout_s=timeout_s).items()
                  if rec["stale"])


# ----------------------------------------------------------------- supervisor

class ElasticDemodulator:
    """Streaming demod loop with checkpoints and automatic recovery.

    Wraps the batched XLA-path RX (the same step as runtime/stream.py)
    in a supervisor that

     * checkpoints state + stream position every ``checkpoint_every``
       blocks,
     * health-checks the carried state every ``health_every`` blocks,
     * on a raised exception OR a corrupt state, restores the last
       checkpoint and replays forward from its stream position.

    The block source is offset-addressed (``source(block_idx) ->
    [n_channels, frame_size] int16``, numpy or tensor) so replay is
    possible; a live capture front-end gets this from a ring buffer
    ``checkpoint_every`` blocks deep.  The state is made on the card
    unless ``device`` says otherwise.

    Example::

        ed = ElasticDemodulator(cfg, n_channels=512,
                                checkpoint_path="ckpt/demod.pt")
        outs = ed.run(source, n_blocks=100)
    """

    def __init__(self, cfg: ModemConfig, n_channels: int, *,
                 checkpoint_path: str,
                 checkpoint_every: int = 16,
                 health_every: int = 1,
                 max_retries: int = 2,
                 descramble: bool = True,
                 heartbeat_dir: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.n_channels = n_channels
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.health_every = health_every
        self.max_retries = max_retries
        self.descramble = descramble
        self.state = prod_rx_init(cfg, (n_channels,), device=device)
        self.block_idx = 0
        self.recoveries = 0
        self.heartbeat = (Heartbeat(heartbeat_dir)
                          if heartbeat_dir else None)
        # block 0 checkpoint: always restorable, even if the first
        # block faults.
        save_state(self.checkpoint_path, self.state, step=0)

    # -- internals ----------------------------------------------------------

    def _restore(self) -> None:
        self.state, self.block_idx = restore_state(
            self.checkpoint_path, like=self.state)
        self.recoveries += 1

    def _advance(self, pcm) -> ProdRxOut:
        state, out = prod_rx_frame(self.cfg, self.state,
                                   torch.as_tensor(pcm),
                                   descramble=self.descramble)
        if self.health_every and self.block_idx % self.health_every == 0:
            bad = health_check(state)
            if bad:
                raise RuntimeError(
                    f"state corrupt after block {self.block_idx}: "
                    f"{bad} non-finite values")
        self.state = state
        self.block_idx += 1
        return out

    # -- public -------------------------------------------------------------

    def step(self, source: Callable[[int], np.ndarray]) -> ProdRxOut:
        """Process the next block from ``source`` with recovery.

        On failure, restores the last checkpoint and replays every
        block from its position up to and including the current one;
        returns the current block's output.  Raises after
        ``max_retries`` consecutive failed recoveries (a deterministic
        fault that replay cannot clear -- e.g. poisoned input -- needs
        operator attention, not a retry loop).
        """
        target = self.block_idx
        for attempt in range(self.max_retries + 1):
            try:
                out = None
                while self.block_idx <= target:
                    out = self._advance(source(self.block_idx))
                if self.heartbeat is not None:
                    self.heartbeat.beat(step=self.block_idx)
                if (self.checkpoint_every
                        and self.block_idx % self.checkpoint_every == 0):
                    self.checkpoint()
                return out
            except Exception:
                if attempt == self.max_retries:
                    raise
                self._restore()
        raise AssertionError("unreachable")

    def run(self, source: Callable[[int], np.ndarray],
            n_blocks: int) -> list:
        return [self.step(source) for _ in range(n_blocks)]

    def checkpoint(self) -> None:
        save_state(self.checkpoint_path, self.state, step=self.block_idx)
