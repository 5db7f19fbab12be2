"""PyTorch port at the five long numerologies the JAX CLI decodes
(``ops/_build.LONG_NUMEROLOGIES``): 24 and 32 equalizer taps
(``--eq-length``), and 872, 1120 and 1616 symbols a block (``--ns`` 24,
32 and 48).

For each, ``tests/test_torch_numerology.py``'s cases: its seeded TX
stream (two packets) on C = 2 channels, the second delayed by a third of
a block, descramble off, at the bench operating point:

  * the whole slice: the port's ``prod_rx_batch(fuse_frontend=True)`` on
    CPU tensors (the kernels' plain versions), the state carried across
    two calls, against the JAX package's ``prod_rx_batch(fuse_frontend=
    True, interpret=True)``: one live call at ``ns24``, ``ns32`` and
    ``ns48`` (20 to 30 s each on a CPU), and at ``eq24`` and ``eq32``,
    whose calls take 106 and some 180 s, the outputs of one such call
    recorded in ``tests/fixtures_torch/long_eq.npz``;
  * the XLA path at ``ns48`` and ``eq32``: the port's ``prod_rx_stream``
    against the JAX package's, one channel, the state carried across two
    calls on the port's side (at ``eq32``, whose XLA compile takes 46 s,
    the JAX outputs recorded in the fixture too).

Both held to the North star's criterion (identical valid flags, bits on
valid blocks, lag, phase and matches on detected blocks, |dcfo| < 0.5 Hz,
|deq_error| < 2e-3), every sent packet found with its bits.

And one case per launcher that the long limits reach, as in
``tests/test_torch_numerology_kernels.py``, with its tolerances: at
``ns32`` (past the Toeplitz hunt's 1024 threads) the hunt with the
extraction and decode, live; at ``eq32`` the two decode launchers on the
padded windows and on the packets, against the JAX launchers' outputs
recorded in the fixture with their inputs.

And where the port's kernel paths part from its XLA path at 24 and 32
taps (``tools/parity.JAX_PARTS``: noise blocks that the fit matches to
the preamble, decided and equalized apart by the bf16 and f32 planes),
the JAX package's own Pallas and XLA paths part alike, on the channels
of the parity stream where they part, their JAX outputs recorded in
``tests/fixtures_torch/long_eq_parts.npz``.

The fixtures are written by running this file as a script
(``JAX_PLATFORMS=cpu PYTHONPATH=. python3
tests/test_torch_numerology_long.py [long_eq|long_eq_parts]`` from the
repository's root, about 8 and 15 minutes on a CPU); the two
``test_the_recorded_*`` tests recompute them and are marked ``slow`` for
that reason.
"""

import dataclasses
import functools
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.ops import decode_pallas as jdec
from singlecarrier_tpu_torch import DEFAULT_CONFIG as TCFG
from singlecarrier_tpu_torch.modem import (prod_rx_batch, prod_rx_init,
                                           prod_rx_init_planes,
                                           prod_rx_stream)
from singlecarrier_tpu_torch.ops import _build, decode
from singlecarrier_tpu_torch.ops._build import LONG_NUMEROLOGIES
from singlecarrier_tpu_torch.tools import parity
from singlecarrier_tpu_torch.tools._measure import SEED, bench_point

import test_torch_numerology as whole
import test_torch_numerology_kernels as launchers
import test_torch_wide_parity as wide

FIXTURE = Path(__file__).parent / "fixtures_torch" / "long_eq.npz"
PARTS_FIXTURE = FIXTURE.with_name("long_eq_parts.npz")
LIVE = ("ns24", "ns32", "ns48")     # a live JAX interpret call each
RECORDED = ("eq24", "eq32")         # the JAX package's outputs in FIXTURE
LAUNCH = ("wins", "lag", "ph", "peak", "pkt")   # the eq32 launchers' inputs
C = whole.C


def record() -> dict:
    """{key: array} that FIXTURE holds, from the JAX package: at each of
    ``RECORDED`` the stream's frames and the one-kernel batch path's
    outputs (``<name>/frames``, ``<name>/batch/<field>``); at ``eq32``
    the XLA path's on channel 1 (``eq32/xla/<field>``), the decode
    launchers' inputs as ``test_torch_numerology_kernels``
    builds them (``eq32/launch/<name>``) and ``fused_decode_extract``'s
    and ``fused_decode``'s outputs (``eq32/extract/<key>``,
    ``eq32/decode/<key>``)."""
    out = {}
    for name in RECORDED:
        cfg = whole._bench(name)
        _, x = whole._stream(cfg)
        frames = whole._frames(cfg, x)
        out[f"{name}/frames"] = frames
        for k, v in whole._jax_batch(cfg, frames)._asdict().items():
            out[f"{name}/batch/{k}"] = np.asarray(v)
    frames = out["eq32/frames"][:, 1]
    for k, v in whole._jax_stream(whole._bench("eq32"),
                                  frames)._asdict().items():
        out[f"eq32/xla/{k}"] = np.asarray(v)
    cfg = launchers._bench("eq32")
    inputs = launchers._hunted_windows("eq32")
    for k, v in zip(LAUNCH, inputs):
        out[f"eq32/launch/{k}"] = v
    wins, lag, ph, peak, pkt = (jnp.asarray(a) for a in inputs)
    N = wins.shape[0]
    ext = jdec.fused_decode_extract(cfg, wins, lag, ph, peak,
                                    block_channels=N, interpret=True)
    dec = jdec.fused_decode(cfg, pkt[:, 0], pkt[:, 1], peak,
                            block_channels=N, interpret=True)
    for kind, got in (("extract", ext), ("decode", dec)):
        for k, v in got.items():
            out[f"eq32/{kind}/{k}"] = np.asarray(v)
    return out


# The channels of the CPU draw of tools/parity's stream (128 channels x 6
# packets, 12 dB, 15 Hz) where the port's kernel path (plain versions) and
# its XLA path part at the bench point: at eq24 noise block 4 of channel
# 112 passes in the kernel path only, and block 7 of channel 80 in both;
# at eq32 one noise block of each of channels 75, 86 and 94 passes in one
# path only, and block 7 of channel 35 in both with its equalized noise
# decided apart (of 14 such blocks).
PART_CHANNELS = {"eq24": (80, 112), "eq32": (35, 75, 86, 94)}


def _parity_frames(name):
    """(port config, sent payloads [k, packets, bits], frames [B, k, n])
    of ``PART_CHANNELS[name]`` in the CPU draw of the parity stream."""
    tcfg = bench_point(TCFG.replace(**_build.NUMEROLOGIES[name]))
    bits, ref = parity.payload(tcfg, parity.PARITY_C, parity.PARITY_PACKETS,
                               SEED, "cpu")
    frames = parity.stream(tcfg, bits, SEED + 1, "cpu").numpy()
    chans = list(PART_CHANNELS[name])
    return tcfg, ref[chans], frames[:, chans].copy()


def record_parts() -> dict:
    """{key: array} that PARTS_FIXTURE holds: at each of
    ``PART_CHANNELS`` the frames (``<name>/frames``) and the JAX
    package's one-kernel Pallas path (interpret mode) and XLA path on
    them, [k, B] a field (``<name>/pallas/<field>``, ``<name>/xla/...``)."""
    out = {}
    for name in PART_CHANNELS:
        tcfg, _, frames = _parity_frames(name)
        cfg = CFG.replace(**dataclasses.asdict(tcfg))
        k = frames.shape[1]
        out[f"{name}/frames"] = frames
        _, jp = jrx.prod_rx_batch(
            cfg, jrx.prod_rx_init_planes(cfg, k), jnp.asarray(frames),
            block_channels=k, decode_block_channels=k, fuse_frontend=True,
            interpret=True)
        jx = [jrx.prod_rx_stream(cfg, jrx.prod_rx_init(cfg),
                                 jnp.asarray(frames[:, c]))[1]
              for c in range(k)]
        for f in jp._fields:
            out[f"{name}/pallas/{f}"] = np.swapaxes(
                np.asarray(getattr(jp, f)), 0, 1)
            out[f"{name}/xla/{f}"] = np.stack(
                [np.asarray(getattr(o, f)) for o in jx])
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    in several worker processes at once, and the 128-channel XLA path
    below took 140-175 s a case with a thread a core in each of six
    processes, 5-10 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _load(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _recorded() -> dict:
    return _load(FIXTURE)


def _part(prefix: str, recorded=None) -> dict:
    """The fixture's arrays under ``prefix/``, by the rest of their key."""
    return {k[len(prefix) + 1:]: v
            for k, v in (recorded or _recorded()).items()
            if k.startswith(prefix + "/")}


def test_the_long_numerologies_are_the_named_ones():
    assert sorted(LIVE + RECORDED) == sorted(LONG_NUMEROLOGIES)
    for kw, long in (({"eq_length": 16}, False), ({"eq_length": 17}, True),
                     ({"ns": 16}, False), ({"ns": 17}, True)):
        assert _build.is_long(TCFG.replace(**kw)) is long
    assert not set(LONG_NUMEROLOGIES) & set(_build.WIDE_NUMEROLOGIES)
    assert not set(LONG_NUMEROLOGIES) & set(_build.RETUNED_NUMEROLOGIES)


# the widest combinations inside the limits: every one compiles its nine
# defines, none is refused (a decode block of 4 rows where 8 would pass
# 227 KB; the full-rate front-end's stores from the registers where its
# row buffer would)
CORNERS = {
    "eq32_ns48_cyc10": {"eq_length": 32, "ns": 48, "fs": 16000.0,
                        "rs": 1600.0, "center": 1500.0},
    "eq32_ns48_nfft4096": {"eq_length": 32, "ns": 48, "cfo_nfft": 4096},
    "ns48_nfft4096_seg16": {"ns": 48, "cfo_nfft": 4096,
                            "corr_segments": 16},
    "ns48_cyc9_taps9": {"ns": 48, "fs": 14400.0, "rs": 1600.0,
                        "center": 1500.0, "ntaps": 9},
}


@pytest.mark.parametrize("name", sorted(CORNERS))
def test_the_widest_combinations_are_inside_the_limits(name):
    cfg = TCFG.replace(**CORNERS[name])
    _build.kernel_limits(cfg)
    assert len(_build.kernel_geometry(cfg)) == 9
    assert cfg.symbols_per_block == 1616 and cfg.pkt_window <= 1648


@pytest.mark.parametrize("name", LIVE)
def test_one_kernel_batch_path_matches_jax(name):
    whole.test_one_kernel_batch_path_matches_jax(name)


@pytest.mark.parametrize("name", RECORDED)
def test_one_kernel_batch_path_matches_recorded_jax(name):
    cfg = whole._bench(name)
    bits, x = whole._stream(cfg)
    frames = whole._frames(cfg, x)
    assert np.array_equal(frames, _recorded()[f"{name}/frames"])
    want = types.SimpleNamespace(**_part(f"{name}/batch"))
    whole._agree(whole._port_batch(cfg, frames), want, bits)


def test_xla_path_matches_jax_at_1616_symbols():
    whole.test_xla_path_matches_jax("ns48")


def test_xla_path_matches_recorded_jax_at_32_taps():
    cfg = whole._bench("eq32")
    bits, x = whole._stream(cfg)
    frames = x[1].reshape(-1, cfg.frame_size)
    assert np.array_equal(frames, _recorded()["eq32/frames"][:, 1])
    want = types.SimpleNamespace(**_part("eq32/xla"))
    whole._agree(whole._port_stream(cfg, frames), want, bits)


@pytest.mark.parametrize("name", LIVE)
def test_the_parity_stream_of_long_packets_is_decoded(name):
    """At ``tools/parity.NUMEROLOGY_SNR_DB`` the CPU draw of the parity
    stream (128 channels x 6 packets, 15 Hz) goes through the port's XLA
    path with every packet found once, no bit error and no false detect:
    the stream on which ``chip_smoke.py`` (j) 2 holds every kernel path
    to the XLA path and the truth at 872 to 1616 symbols a block."""
    assert sorted(parity.NUMEROLOGY_SNR_DB) == sorted(LIVE)
    tcfg = bench_point(TCFG.replace(**_build.NUMEROLOGIES[name]))
    bits, ref = parity.payload(tcfg, parity.PARITY_C, parity.PARITY_PACKETS,
                               SEED, "cpu")
    frames = parity.stream(tcfg, bits, SEED + 1, "cpu",
                           parity.NUMEROLOGY_SNR_DB[name],
                           parity.PARITY_CFO_HZ)
    _, out = prod_rx_stream(tcfg, prod_rx_init(tcfg, (parity.PARITY_C,),
                                               "cpu"), frames)
    err, total, false, hits, _ = parity.truth(tcfg, parity.host(out), ref)
    expected = parity.PARITY_C * parity.PARITY_PACKETS
    assert (err, false, len(hits)) == (0, 0, expected)
    assert total == expected * tcfg.bits_per_frame


def test_hunt_and_extract_decode_match_jax_at_1120_symbols():
    launchers.test_hunt_and_extract_decode_match_jax("ns32")


def test_decode_launchers_match_recorded_jax_at_32_taps():
    """``fused_decode_extract`` on the padded windows and
    ``fused_decode`` on the packets, each against the JAX launcher's
    recorded outputs, and the two against each other to the bit."""
    cfg = launchers._bench("eq32")
    tcfg = launchers._tcfg(cfg)
    wins, lag, ph, peak, pkt = (torch.from_numpy(_recorded()[
        f"eq32/launch/{k}"].copy()) for k in LAUNCH)
    got = decode.fused_decode_extract(tcfg, wins, lag, ph, peak)
    got = {k: v.numpy() for k, v in got.items()}
    want = _part("eq32/extract")
    assert got.keys() == want.keys()
    assert launchers._decisions(cfg, got, want) >= 2 * C
    got2 = decode.fused_decode(tcfg, pkt[:, 0].contiguous(),
                               pkt[:, 1].contiguous(), peak)
    got2 = {k: v.numpy() for k, v in got2.items()}
    assert launchers._decisions(cfg, got2, _part("eq32/decode")) >= 2 * C
    for k in got:
        assert np.array_equal(got[k], got2[k]), k


@pytest.mark.parametrize("name", sorted(PART_CHANNELS))
def test_where_the_paths_part_at_long_equalizers_the_jax_packages_part(name):
    """On the channels of ``PART_CHANNELS``: the port's kernel path and
    XLA path equal the JAX package's, path by path, in their decisions;
    JAX's two paths part on the same blocks as the port's (valid flags,
    and the bits of blocks valid in both), every one of them a noise
    block, every sent packet decoded alike with its bits; and
    ``tools/parity.hold`` under ``JAX_PARTS[name]`` holds the port's
    kernel path to its XLA path there, where the default rule does not,
    nor a bound of one flip fewer."""
    tcfg, ref, frames = _parity_frames(name)
    rec = _load(PARTS_FIXTURE)
    assert np.array_equal(frames, rec[f"{name}/frames"])
    C = frames.shape[1]
    _, tp = prod_rx_batch(tcfg, prod_rx_init_planes(tcfg, C, "cpu"),
                          torch.from_numpy(frames), fuse_frontend=True)
    _, tx = prod_rx_stream(tcfg, prod_rx_init(tcfg, (C,), "cpu"),
                           torch.from_numpy(frames))
    port = {k: type(o)(*(v.transpose(0, 1).numpy() for v in o))
            for k, o in (("pallas", tp), ("xla", tx))}
    jax = {k: types.SimpleNamespace(**_part(f"{name}/{k}", rec))
           for k in port}
    for k in port:
        wide._same_decisions(port[k]._asdict(), vars(jax[k]))

    def parting(a, b):
        both = a.valid & b.valid
        return (a.valid != b.valid, both & (a.bits != b.bits).any(-1))
    for got, want in zip(parting(port["pallas"], port["xla"]),
                         parting(jax["pallas"], jax["xla"])):
        assert np.array_equal(got, want)
    flips, bits = parting(jax["pallas"], jax["xla"])
    assert flips.any()
    truth = {k: parity.truth(tcfg, o, ref) for k, o in port.items()}
    hits = truth["pallas"][3] | truth["xla"][3]
    assert not {tuple(cb) for cb in np.argwhere(flips | bits).tolist()} \
        & hits
    assert truth["pallas"][:2] == truth["xla"][:2] == (
        0, C * parity.PARITY_PACKETS * tcfg.bits_per_frame)
    expected = C * parity.PARITY_PACKETS
    args = (tcfg, port["pallas"], port["xla"], truth["pallas"],
            truth["xla"], expected)
    parts = parity.JAX_PARTS[name]
    assert int(flips.sum()) <= parts.noise_detects
    assert parity.hold(*args, parts, "full")[0]
    assert not parity.hold(*args, parity.Parts(), "full")[0]
    fewer = parts._replace(noise_detects=int(flips.sum()) - 1)
    assert not parity.hold(*args, fewer, "full")[0]


def _same_record(got: dict, want: dict) -> None:
    """A recomputed fixture against the committed one: the same keys,
    frames and inputs, the same decisions, the floats within 1e-5
    relative."""
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            assert np.array_equal(v, want[k]), k


@pytest.mark.slow
def test_the_recorded_outputs_are_the_jax_packages():
    """FIXTURE against :func:`record` run anew (some eight minutes of
    interpret-mode calls)."""
    _same_record(record(), _recorded())


@pytest.mark.slow
def test_the_recorded_partings_are_the_jax_packages():
    """PARTS_FIXTURE against :func:`record_parts` run anew (some fifteen
    minutes of interpret-mode calls)."""
    _same_record(record_parts(), _load(PARTS_FIXTURE))


if __name__ == "__main__":
    for which in sys.argv[1:] or ("long_eq", "long_eq_parts"):
        path, fn = {"long_eq": (FIXTURE, record),
                    "long_eq_parts": (PARTS_FIXTURE, record_parts)}[which]
        path.parent.mkdir(exist_ok=True)
        np.savez_compressed(path, **fn())
        print(f"wrote {path} ({path.stat().st_size} bytes)",
              file=sys.stderr)
