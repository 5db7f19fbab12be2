"""PyTorch port: the sharded checkpoint (``runtime.save_sharded`` /
``restore_sharded``, over ``torch.distributed.checkpoint``) on two gloo
ranks on the CPU.

Counterpart of ``tests/test_checkpoint_sharded.py``: each rank writes
and reads back only its own shard, complex leaves as real and imaginary
planes, bf16 planes as bf16.  Held: the round trip of a non-trivial
``ProdRxState`` and of the plane tuple, every leaf to the bit on its
rank's device; restore and replay, on the XLA path and on the main
path's plane state, equal to the uninterrupted sharded run to the bit;
a ``like`` of the wrong shape or dtype raises ``ValueError``.  The
stream is the port's own TX (three packets, seed 33, 8 channels); no JAX
call.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from singlecarrier_tpu_torch.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu_torch.modem import (ProdRxOut, prod_rx_init,
                                           prod_rx_init_planes, tx_stream)
from singlecarrier_tpu_torch.parallel import (make_channel_sharded_rx,
                                              make_fused_sharded_rx,
                                              make_mesh, shard_channel_state,
                                              shard_plane_state)
from singlecarrier_tpu_torch.runtime import restore_sharded, save_sharded

BENCH = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                    ls_refit_symbols=128)
N_CH, WORLD = 8, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    in several worker processes at once, and its spawned ranks take
    cores of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream() -> np.ndarray:
    """[channels, frames, frame_size] int16: three packets on every
    channel."""
    rng = np.random.default_rng(33)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = tx_stream(CFG, bits, flush_gap=True, device="cpu").numpy()
    n_blocks = -(-len(pcm) // CFG.frame_size)
    buf = np.zeros(n_blocks * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    return np.broadcast_to(buf.reshape(1, n_blocks, CFG.frame_size),
                           (N_CH, n_blocks, CFG.frame_size)).copy()


def _cat(a, b, dim):
    return ProdRxOut(*(torch.cat([x, y], dim) for x, y in zip(a, b)))


def _rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(device="cpu")
        ck = os.path.join(out_dir, "ckpt")
        res = {}

        # round trips: a non-trivial ProdRxState and the bf16 plane tuple
        st = shard_channel_state(prod_rx_init(CFG, (N_CH,), device="cpu"),
                                 mesh)
        st = st._replace(
            phase=torch.polar(torch.ones(st.phase.shape),
                              torch.arange(st.phase.numel()) + 0.5 * rank),
            decim_prev=st.decim_prev + (1.0 + 2.0j))
        save_sharded(ck + "_state", st, step=7)
        res["state"] = (st, restore_sharded(ck + "_state", st))
        planes = list(shard_plane_state(
            prod_rx_init_planes(BENCH, N_CH, device="cpu"), mesh))
        planes[4] = planes[4] + torch.arange(
            planes[4].shape[-1]).to(torch.bfloat16) * (rank + 1)
        planes = tuple(planes)
        save_sharded(ck + "_planes", planes, step=3)
        res["planes"] = (planes, restore_sharded(ck + "_planes", planes))

        # a like of the wrong shape, then of the wrong dtype
        errs = []
        for bad in (shard_channel_state(
                        prod_rx_init(CFG, (2 * N_CH,), device="cpu"), mesh),
                    planes[:4] + (planes[4].float(),)):
            try:
                restore_sharded(ck + "_state" if len(bad) == 3
                                else ck + "_planes", bad)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        res["errors"] = errs

        # restore and replay: the XLA path, half the stream, a checkpoint
        by_ch = torch.from_numpy(_stream())
        cut = by_ch.shape[1] // 2
        fn = make_channel_sharded_rx(CFG, mesh, descramble=False)
        st0 = shard_channel_state(prod_rx_init(CFG, (N_CH,), device="cpu"),
                                  mesh)
        _, full = fn(st0, by_ch)
        half, _ = fn(st0, by_ch[:, :cut])
        save_sharded(ck + "_mid", half, step=cut)
        back, step = restore_sharded(ck + "_mid", st0)
        _, rest = fn(back, by_ch[:, cut:])
        res["replay_xla"] = (full, rest, step, cut)

        # the main path's plane state, checkpointed between dispatches
        pcm = by_ch.transpose(0, 1).contiguous()
        fn = make_fused_sharded_rx(BENCH, mesh, descramble=False)
        p0 = shard_plane_state(prod_rx_init_planes(BENCH, N_CH, "cpu"),
                               mesh)
        _, full = fn(p0, pcm)
        p1, a = fn(p0, pcm[:cut])
        save_sharded(ck + "_pmid", p1, step=cut)
        p1r, _ = restore_sharded(ck + "_pmid", p0)
        _, b = fn(p1r, pcm[cut:])
        _, b_ = fn(p1, pcm[cut:])
        res["replay_fused"] = (_cat(a, b, 0), _cat(a, b_, 0), full)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_ranks")
    mp.start_processes(_rank_main, args=(WORLD, str(d / "store"), str(d)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _equal(a, b) -> None:
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("what, step", [("state", 7), ("planes", 3)])
def test_sharded_save_restore_roundtrip(ranks, what, step):
    for res in ranks:
        saved, (restored, got_step) = res[what]
        assert got_step == step
        _equal(restored, saved)
        assert all(x.is_contiguous() for x in restored)
    # each rank read its own shard back, not another's
    assert not all(torch.equal(x, y) for x, y in
                   zip(ranks[0][what][1][0], ranks[1][what][1][0]))


def test_sharded_restore_of_a_wrong_like_raises(ranks):
    for res in ranks:
        shape_err, dtype_err = res["errors"]
        assert shape_err is not None and "(16," in shape_err, shape_err
        assert dtype_err is not None and "bfloat16" in dtype_err, dtype_err


def test_sharded_restore_and_replay_bit_identical(ranks):
    """Half the stream on the XLA path, the sharded state checkpointed,
    restored, the rest replayed: the rest equals the uninterrupted
    sharded run's, every field to the bit."""
    for res in ranks:
        full, rest, step, cut = res["replay_xla"]
        assert step == cut
        _equal(rest, ProdRxOut(*(x[:, cut:] for x in full)))


def test_plane_state_checkpoint_resume_main_path(ranks):
    """The main path's plane state saved between two dispatches and
    restored: equal to the uninterrupted pair of dispatches to the bit,
    and by decisions to one dispatch over the whole stream."""
    valid = 0
    for res in ranks:
        resumed, straight, one = res["replay_fused"]
        _equal(resumed, straight)
        assert torch.equal(resumed.valid, one.valid)
        assert torch.equal(resumed.bits[one.valid], one.bits[one.valid])
        valid += int(resumed.valid.sum())
    assert valid == 3 * N_CH
