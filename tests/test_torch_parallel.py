"""PyTorch port: the multi-device layer (``singlecarrier_tpu_torch.
parallel``) on the CPU, gloo, against the JAX package's ``parallel``.

The stream is ``tests/test_sharding.py``'s: ten packets of JAX's TX from
``numpy.random.default_rng(11)`` bits, 16 frames, on every channel.  One
group of four gloo ranks (spawned processes that import no JAX) runs, on
a (ch=4, time=1) and a (ch=2, time=2) mesh: the channel-sharded XLA path
and ``metrics_summary`` at 4 ranks; ``make_fused_sharded_rx`` at 4 and 2
channel ranks, both ``fuse_frontend`` values, the state carried across
two calls; ``time_sharded_rx`` at 2 time ranks; ``grid_sharded_rx`` and
``make_fused_grid_sharded_rx`` at (2, 2); the sharded checkpoint on the
(2, 2) mesh.  Each rank writes its shard;
the tests gather them and hold them:

  * to JAX by the North star's criterion (identical valid, bits on valid
    blocks, lag and phase on detected blocks, |dcfo| < 0.5 Hz,
    |deq_error| < 2e-3; ``metrics_summary``: the count exact, the means
    within 1e-6 relative): the XLA paths and one interpret-mode
    ``make_fused_grid_sharded_rx`` (ch=4, time=2);
  * to the port's unsharded paths to the bit (``torch.equal`` on every
    field): the channel-sharded paths do per-channel work only;
  * at the time seams, by decisions to the unsharded fused path and all
    10 packets on every channel: ``_grid_shard`` for every shard in one
    process at time = 2 and 4, and the gloo grid equal to that
    in-process run to the bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.config import DEFAULT_CONFIG as TCFG
from singlecarrier_tpu_torch.modem import (ProdRxOut, prod_rx_batch,
                                           prod_rx_init, prod_rx_init_planes,
                                           prod_rx_stream)
from singlecarrier_tpu_torch.parallel import (
    grid_sharded_rx, make_channel_sharded_rx, make_fused_grid_sharded_rx,
    make_fused_sharded_rx, make_mesh, metrics_summary, shard_channel_state,
    shard_plane_state, time_sharded_rx)
from singlecarrier_tpu_torch.parallel import multihost
from singlecarrier_tpu_torch.parallel.sharded_rx import _grid_shard
from singlecarrier_tpu_torch.runtime import restore_sharded, save_sharded

# the bench operating point, the main path's
TBENCH = TCFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                      ls_refit_symbols=128)
N_CH, N_BLK, WORLD = 8, 16, 4
GRID_CH = 4                     # channels of the XLA grid run


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    in several worker processes at once, and its spawned ranks take
    cores of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cat(outs, dim=0):
    return ProdRxOut(*(torch.cat(xs, dim) for xs in zip(*outs)))


def _rank_main(rank: int, world: int, store: str, frames: np.ndarray,
               out_dir: str) -> None:
    """One gloo rank: every sharded path of the module, its shards saved
    to ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        n = TCFG.frame_size
        mesh4 = make_mesh(ch=4, device="cpu")
        mesh22 = make_mesh(ch=2, time=2, device="cpu")
        by_ch = torch.from_numpy(np.broadcast_to(
            frames[None], (N_CH, N_BLK, n)).copy())  # [ch, frames, n]
        pcm = by_ch.transpose(0, 1).contiguous()    # [frames, ch, n]
        res = {}

        fn = make_channel_sharded_rx(TCFG, mesh4, descramble=False)
        st = shard_channel_state(prod_rx_init(TCFG, (N_CH,), device="cpu"),
                                 mesh4)
        _, out = fn(st, by_ch)
        res["channel"] = out
        res["metrics"] = metrics_summary(out, mesh4.get_group("ch"))

        for tag, mesh in (("ch4", mesh4), ("ch2", mesh22)):
            for ff in (True, False):
                fn = make_fused_sharded_rx(TBENCH, mesh, descramble=False,
                                           fuse_frontend=ff)
                st = shard_plane_state(
                    prod_rx_init_planes(TBENCH, N_CH, device="cpu"), mesh)
                st, a = fn(st, pcm[:N_BLK // 2])
                st, b = fn(st, pcm[N_BLK // 2:])
                res[f"fused_{tag}_{ff}"] = (_cat([a, b]), st)

        res["time"] = time_sharded_rx(TCFG, torch.from_numpy(frames),
                                      mesh22, descramble=False)
        res["grid"] = grid_sharded_rx(TCFG, by_ch[:GRID_CH], mesh22,
                                      descramble=False)
        res["fused_grid"] = make_fused_grid_sharded_rx(
            TBENCH, mesh22, descramble=False)(pcm)

        # the sharded checkpoint on the (2, 2) mesh: channels sharded on
        # 'ch', each shard held by both ranks of its 'time' pair
        st = res["fused_ch2_True"][1]
        st = (st[0] + 100.0 * mesh22.get_local_rank("ch"),) + st[1:]
        ck = os.path.join(out_dir, "ckpt22")
        save_sharded(ck, st, step=5, mesh=mesh22)
        res["ckpt22"] = (st, restore_sharded(ck, st, mesh=mesh22))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def stream():
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
    from singlecarrier_tpu.modem import tx_stream
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (10, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    buf = np.zeros(N_BLK * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    return (bits.reshape(10, CFG.bits_per_frame),
            buf.reshape(N_BLK, CFG.frame_size))


@pytest.fixture(scope="module")
def ranks(stream, tmp_path_factory):
    """The four ranks' results, rank by rank."""
    d = tmp_path_factory.mktemp("ranks")
    mp.start_processes(_rank_main, args=(WORLD, str(d / "store"), stream[1],
                                         str(d)),
                       nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def pcm(stream):
    """[frames, channels, n] int16, every channel the stream."""
    return torch.from_numpy(np.broadcast_to(
        stream[1][:, None], (N_BLK, N_CH, TCFG.frame_size)).copy())


@pytest.fixture(scope="module")
def fused_ref(pcm):
    """The unsharded main path over the whole stream, one call."""
    return prod_rx_batch(TBENCH, prod_rx_init_planes(TBENCH, N_CH, "cpu"),
                         pcm, descramble=False, fuse_frontend=True)[1]


def _agree(t: ProdRxOut, j) -> None:
    """The North star's criterion: port output ``t`` against JAX's ``j``,
    on every block."""
    v = np.asarray(j.valid)
    assert np.array_equal(t.valid.numpy(), v)
    for name in ("bits", "lag", "timing_phase"):
        assert np.array_equal(getattr(t, name).numpy()[v],
                              np.asarray(getattr(j, name))[v]), name
    if v.any():
        assert np.abs(t.cfo_hz.numpy()[v]
                      - np.asarray(j.cfo_hz)[v]).max() < 0.5
        assert np.abs(t.eq_error.numpy()[v]
                      - np.asarray(j.eq_error)[v]).max() < 2e-3


def _decisions_equal(a: ProdRxOut, b: ProdRxOut) -> None:
    """Valid, lag and phase everywhere; bits on valid blocks."""
    assert torch.equal(a.valid, b.valid)
    assert torch.equal(a.bits[b.valid], b.bits[b.valid])
    assert torch.equal(a.lag, b.lag)
    assert torch.equal(a.timing_phase, b.timing_phase)


def _all_packets(out: ProdRxOut, bits: np.ndarray, ch_dim: int) -> None:
    """Every channel decodes all 10 packets, bit for bit."""
    for c in range(out.valid.shape[ch_dim]):
        v = out.valid.select(ch_dim, c)
        assert int(v.sum()) == 10
        assert np.array_equal(out.bits.select(ch_dim, c)[v].numpy(), bits)


def _equal(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _in_process_grid(pcm, n_t: int) -> ProdRxOut:
    """``_grid_shard`` for every time shard in one process, the halos
    cut from the stream itself."""
    b = pcm.shape[0] // n_t
    halo = TBENCH.ntaps - 1
    outs = []
    for t in range(n_t):
        prev = pcm[t * b - 1] if t else torch.zeros_like(pcm[0])
        pre = (pcm[t * b - 2, :, -halo:] if t
               else torch.zeros_like(pcm[0, :, :halo]))
        outs.append(_grid_shard(TBENCH, pcm[t * b:(t + 1) * b], prev, pre,
                                t, n_t, descramble=False))
    return _cat(outs)


def test_channel_sharded_xla_path_matches_jax_and_unsharded(ranks, stream):
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
    from singlecarrier_tpu.modem import prod_rx_init as jinit
    from singlecarrier_tpu.parallel import make_channel_sharded_rx as jfn
    from singlecarrier_tpu.parallel import make_mesh as jmesh
    from singlecarrier_tpu.parallel import shard_channel_state as jshard

    got = _cat([r["channel"] for r in ranks])       # [ch, frames, ...]
    frames = stream[1]
    mesh = jmesh(ch=8, time=1)
    batch = np.broadcast_to(frames, (N_CH, *frames.shape)).copy()
    _, jout = jfn(CFG, mesh, descramble=False)(jshard(jinit(CFG, (N_CH,)),
                                                      mesh),
                                               jnp.asarray(batch))
    jout = jax.tree.map(np.asarray, jout)
    _agree(got, jout)
    assert int(got.valid.sum()) == 10 * N_CH

    # the unsharded XLA path: every field to the bit but eq_error, which
    # the LS fit's batched CPU products round by how many channels share
    # a call (one ulp on this stream); on each rank's own channels, every
    # field to the bit
    def unsharded(c0, c1):
        _, ref = prod_rx_stream(
            TCFG, prod_rx_init(TCFG, (c1 - c0,), "cpu"),
            torch.from_numpy(batch[c0:c1]).transpose(0, 1),
            descramble=False)
        return ProdRxOut(*(x.transpose(0, 1) for x in ref))

    ref = unsharded(0, N_CH)
    _equal(got[:-1], ref[:-1])
    assert (got.eq_error - ref.eq_error).abs().max() <= 6e-8
    per = N_CH // WORLD
    for r, res in enumerate(ranks):
        _equal(res["channel"], unsharded(r * per, (r + 1) * per))


def test_metrics_summary_matches_jax(ranks):
    import jax.numpy as jnp

    from singlecarrier_tpu.modem.rx_production import ProdRxOut as JOut
    from singlecarrier_tpu.parallel import metrics_summary as jsummary

    got = _cat([r["channel"] for r in ranks])
    want = jsummary(JOut(*(jnp.asarray(x.numpy()) for x in got)))
    for r in ranks:                                  # every rank agrees
        m = r["metrics"]
        assert int(m["packets_detected"]) == int(want["packets_detected"])
        for key in ("mean_cfo_hz", "mean_eq_error"):
            assert np.isclose(float(m[key]), float(want[key]), rtol=1e-6,
                              atol=0.0), key
    # the local reduction, where no group is initialized
    local = metrics_summary(got)
    assert int(local["packets_detected"]) == 10 * N_CH


@pytest.mark.parametrize("mesh_tag, ranks_per", [("ch4", 1), ("ch2", 2)],
                         ids=["4_ranks", "2_ranks"])
@pytest.mark.parametrize("fuse_frontend", [True, False],
                         ids=["one_kernel", "two_kernel"])
def test_fused_sharded_rx_equals_unsharded(ranks, pcm, mesh_tag, ranks_per,
                                           fuse_frontend):
    """Two chained sharded calls per rank, gathered over the channel
    axis, against the unsharded path's two calls: every output field and
    every state plane equal to the bit.  On the (2, 2) mesh the ranks of
    a ``time`` pair hold the same channels: every ``ranks_per``-th."""
    key = f"fused_{mesh_tag}_{fuse_frontend}"
    for r in range(0, WORLD, ranks_per):          # the time replicas agree
        for k in range(1, ranks_per):
            _equal(ranks[r + k][key][0], ranks[r][key][0])
    shards = [r[key] for r in ranks[::ranks_per]]
    got = _cat([s[0] for s in shards], dim=1)
    st = tuple(torch.cat(xs, dim=d)
               for xs, d in zip(zip(*(s[1] for s in shards)),
                                (0, 0, 0, 0, 2)))
    ref_st = prod_rx_init_planes(TBENCH, N_CH, "cpu")
    outs = []
    for part in (pcm[:N_BLK // 2], pcm[N_BLK // 2:]):
        ref_st, o = prod_rx_batch(TBENCH, ref_st, part, descramble=False,
                                  fuse_frontend=fuse_frontend)
        outs.append(o)
    _equal(got, _cat(outs))
    _equal(st, ref_st)


def test_sharded_checkpoint_on_a_grid_mesh(ranks):
    """``save_sharded`` / ``restore_sharded`` with ``mesh`` on the (2, 2)
    mesh: each rank reads back its own channel shard, the replicas of a
    'time' pair alike."""
    for res in ranks:
        saved, (restored, step) = res["ckpt22"]
        assert step == 5
        _equal(restored, saved)
    _equal(ranks[1]["ckpt22"][1][0], ranks[0]["ckpt22"][1][0])
    assert not torch.equal(ranks[0]["ckpt22"][1][0][0],
                           ranks[2]["ckpt22"][1][0][0])


def test_time_sharded_two_ranks_matches_jax(ranks, stream):
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
    from singlecarrier_tpu.parallel import make_mesh as jmesh
    from singlecarrier_tpu.parallel import make_time_sharded_rx as jfn

    bits, frames = stream
    # ranks 0 and 1 are the time pair of channel row 0; 2 and 3 repeat it
    got = _cat([ranks[0]["time"], ranks[1]["time"]])
    _equal(_cat([ranks[2]["time"], ranks[3]["time"]]), got)
    mesh = jmesh(ch=1, time=2, devices=jax.devices()[:2])
    jout = jax.tree.map(np.asarray, jfn(CFG, mesh, descramble=False)(
        jnp.asarray(frames)))
    _agree(got, jout)
    assert int(got.valid.sum()) == 10
    assert np.array_equal(got.bits[got.valid].numpy(), bits)


def test_grid_sharded_xla_path_matches_jax(ranks, stream):
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
    from singlecarrier_tpu.parallel import grid_sharded_rx as jgrid
    from singlecarrier_tpu.parallel import make_mesh as jmesh

    bits, frames = stream
    # rank = 2 ch + t: [ch, time] shards of [channels, blocks]
    rows = [_cat([ranks[2 * i]["grid"], ranks[2 * i + 1]["grid"]], dim=1)
            for i in range(2)]
    got = _cat(rows)
    mesh = jmesh(ch=2, time=2, devices=jax.devices()[:4])
    batch = jnp.asarray(np.broadcast_to(
        frames, (GRID_CH, *frames.shape)).copy())
    jout = jax.tree.map(np.asarray, jax.jit(
        lambda p: jgrid(CFG, p, mesh, descramble=False))(batch))
    _agree(got, jout)
    _all_packets(got, bits, 0)


@pytest.mark.parametrize("n_t", [2, 4])
def test_grid_shards_in_process_keep_decisions_at_the_seams(pcm, fused_ref,
                                                            stream, n_t):
    got = _in_process_grid(pcm, n_t)
    _decisions_equal(got, fused_ref)
    _all_packets(got, stream[0], 1)


def test_fused_grid_over_gloo_equals_in_process(ranks, pcm, stream):
    # rank = 2 ch + t: blocks [t half], channels [ch half]
    halves = [_cat([ranks[t]["fused_grid"], ranks[2 + t]["fused_grid"]],
                   dim=1) for t in range(2)]
    got = _cat(halves)
    _equal(got, _in_process_grid(pcm, 2))
    _all_packets(got, stream[0], 1)


def test_fused_grid_matches_jax_interpret(pcm, stream):
    """JAX's ``make_fused_grid_sharded_rx`` at (ch=4, time=2) in
    interpret mode on 8 channels, against the port's in-process grid at
    2 time shards (its channel split does per-channel work only): by
    decisions."""
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
    from singlecarrier_tpu.parallel import make_fused_grid_sharded_rx as jfn
    from singlecarrier_tpu.parallel import make_mesh as jmesh

    bench = CFG.replace(decim_dtype="bf16", hunt_dtype="int8",
                        ls_refit_symbols=128)
    assert interop.config_from_dict(dataclasses.asdict(bench)) == TBENCH
    jout = jax.tree.map(np.asarray, jfn(
        bench, jmesh(ch=4, time=2), descramble=False,
        decode_block_channels=2, interpret=True)(jnp.asarray(pcm.numpy())))
    _agree(_in_process_grid(pcm, 2), jout)


def test_device_rule_without_a_card():
    """Without a card the entry points refuse the default device; the
    CPU must be asked for.  Nothing is left initialized."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        make_mesh(ch=2, device="cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")                  # a one-rank group
    try:
        cuda_mesh = DeviceMesh("cuda", torch.tensor([[0]]),
                               mesh_dim_names=("ch", "time"),
                               _init_backend=False)
        state = prod_rx_init(TCFG, (4,), device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_channel_state(state, cuda_mesh)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_plane_state(prod_rx_init_planes(TCFG, 4, "cpu"),
                              cuda_mesh)
        local = shard_channel_state(state, mesh)
        assert local.phase.device.type == "cpu"
        with pytest.raises(ValueError, match=">= 2 blocks per shard"):
            make_fused_grid_sharded_rx(TBENCH, mesh)(
                torch.zeros((1, 4, TCFG.frame_size), dtype=torch.int16))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_exports_match_the_jax_package():
    import singlecarrier_tpu.parallel as jpar
    import singlecarrier_tpu_torch.parallel as tpar

    assert tpar.__all__ == jpar.__all__
    assert all(callable(getattr(tpar, name)) for name in tpar.__all__)
