"""Where the port's kernel paths and its XLA path part at the wide
numerologies, the JAX package's own Pallas and XLA paths part the same
way.

``chip_smoke.py`` (j) holds every kernel path to the port's XLA path on
``tools/parity``'s stream (128 channels x 6 packets, 12 dB, 15 Hz) at
each named numerology.  At the bench operating point the kernel paths
read bf16 planes and hunt in int8 where the XLA path reads f32 planes,
and at two wide numerologies the two parted on the card:

  * ``eq16``: on channel 70 of the card's stream (the frames are
    ``tests/fixtures_torch/eq16_flip.npz``) noise block 9 reaches a
    peak / energy of 7.0014 in the kernel paths, over the gate of 7, and
    6.8544 in the XLA path, with 100 matches (over 98) in both: a false
    detect of the kernel paths only.  The JAX package's one-kernel Pallas
    path (interpret mode) and its XLA path part there just so, and the
    port's plain versions equal JAX's path by path.
  * ``ns16`` and ``wide_corner``: eq_error of the same packet differs
    between the two paths by up to 2.5e-3 (ns16) on the card.  On a CPU
    draw of the same stream the worst packet's difference is the JAX
    package's own Pallas-vs-XLA difference, to 1e-5; so at ``nfft4096``,
    and at ``ns48`` on its stream at 24 dB (3.2e-3 on the card).
  * ``taps25``: two neighbouring decimation phases all but tie.  The JAX
    package's two paths part on the same blocks, within what
    ``tools/parity.JAX_PARTS`` allows.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu_torch import DEFAULT_CONFIG as TCFG
from singlecarrier_tpu_torch.interop import config_from_dict
from singlecarrier_tpu_torch.modem import (prod_rx_batch, prod_rx_init,
                                           prod_rx_init_planes,
                                           prod_rx_stream)
from singlecarrier_tpu_torch.ops._build import NUMEROLOGIES
from singlecarrier_tpu_torch.tools import parity
from singlecarrier_tpu_torch.tools._measure import SEED, bench_point

FIXTURE = Path(__file__).parent / "fixtures_torch" / "eq16_flip.npz"


def _configs(name):
    """(JAX config, port config) at ``name``'s bench operating point."""
    tcfg = bench_point(TCFG.replace(**NUMEROLOGIES[name]))
    return CFG.replace(**dataclasses.asdict(tcfg)), tcfg


def _four_paths(name, frames):
    """{path: numpy outputs [B]} of one channel's frames [B, 1, n]: the
    JAX package's Pallas and XLA paths and the port's plain versions of
    both."""
    cfg, tcfg = _configs(name)
    assert config_from_dict(dataclasses.asdict(cfg)) == tcfg
    _, jp = jrx.prod_rx_batch(cfg, jrx.prod_rx_init_planes(cfg, 1),
                              jnp.asarray(frames), block_channels=1,
                              decode_block_channels=1, fuse_frontend=True,
                              interpret=True)
    _, jx = jrx.prod_rx_stream(cfg, jrx.prod_rx_init(cfg),
                               jnp.asarray(frames[:, 0]))
    _, tp = prod_rx_batch(tcfg, prod_rx_init_planes(tcfg, 1, "cpu"),
                          torch.from_numpy(frames), fuse_frontend=True)
    _, tx = prod_rx_stream(tcfg, prod_rx_init(tcfg, device="cpu"),
                           torch.from_numpy(frames[:, 0]))
    return {k: {f: np.asarray(getattr(o, f)).reshape(frames.shape[0], -1)
                .squeeze(-1) if f != "bits" else np.asarray(o.bits)
                for f in o._fields}
            for k, o in (("jax pallas", jp), ("jax xla", jx),
                         ("port pallas", tp), ("port xla", tx))}


def _same_decisions(a, b):
    assert np.array_equal(a["valid"], b["valid"])
    for f in ("matches", "lag", "timing_phase"):
        assert np.array_equal(a[f][a["valid"]], b[f][a["valid"]]), f
    np.testing.assert_allclose(a["peak"], b["peak"], rtol=1e-5)
    np.testing.assert_allclose(a["energy"], b["energy"], rtol=1e-5)


def test_the_eq16_noise_flip_is_the_jax_packages():
    frames = np.load(FIXTURE)["frames"]
    out = _four_paths("eq16", frames)
    _same_decisions(out["port pallas"], out["jax pallas"])
    _same_decisions(out["port xla"], out["jax xla"])
    gate = _configs("eq16")[0].effective_peak_gate
    for side, valid in (("pallas", True), ("xla", False)):
        o = out[f"jax {side}"]
        assert bool(o["valid"][9]) is valid, side
        assert bool(o["peak"][9] > gate * o["energy"][9]) is valid, side
        assert o["matches"][9] == 100
    # every other block decides alike in the two paths
    keep = np.arange(frames.shape[0]) != 9
    assert np.array_equal(out["jax pallas"]["valid"][keep],
                          out["jax xla"]["valid"][keep])


@pytest.mark.parametrize("name", ["ns16", "wide_corner", "nfft4096", "ns48"])
def test_the_eq_error_gap_is_the_jax_packages(name):
    """The packet whose eq_error differs most between the port's kernel
    path (plain versions) and its XLA path, on a CPU draw of the parity
    stream (at the numerology's own SNR, ``tools/parity.
    NUMEROLOGY_SNR_DB``), differs by as much between the JAX package's two
    paths."""
    _, tcfg = _configs(name)
    bits, _ = parity.payload(tcfg, 32, parity.PARITY_PACKETS, SEED, "cpu")
    snr_db = parity.NUMEROLOGY_SNR_DB.get(name, parity.PARITY_SNR_DB)
    frames = parity.stream(tcfg, bits, SEED + 1, "cpu", snr_db).numpy()
    C = frames.shape[1]
    _, tp = prod_rx_batch(tcfg, prod_rx_init_planes(tcfg, C, "cpu"),
                          torch.from_numpy(frames), fuse_frontend=True)
    _, tx = prod_rx_stream(tcfg, prod_rx_init(tcfg, (C,), "cpu"),
                           torch.from_numpy(frames))
    both = (tp.valid & tx.valid).numpy()
    gap = np.abs(tp.eq_error.numpy() - tx.eq_error.numpy()) * both
    b, c = np.unravel_index(np.argmax(gap), gap.shape)
    out = _four_paths(name, frames[:, c:c + 1].copy())
    jax_gap = abs(out["jax pallas"]["eq_error"][b]
                  - out["jax xla"]["eq_error"][b])
    assert gap[b, c] > 1e-3
    assert abs(gap[b, c] - jax_gap) < 1e-5


def _ties(o_p, o_x):
    """[.., B] bool: the blocks valid in both paths' outputs whose timing
    (lag and phase) parts."""
    both = o_p["valid"] & o_x["valid"]
    return both & ((o_p["timing_phase"] != o_x["timing_phase"])
                   | (o_p["lag"] != o_x["lag"]))


def test_where_the_paths_part_the_jax_packages_part():
    """At taps25 two neighbouring decimation phases all but tie (two
    phases, or the last phase of a lag and the first of the next).  On a
    CPU draw of the parity stream, on the first channel where the port's
    kernel path (plain versions) and its XLA path part so, the JAX
    package's Pallas and XLA paths part on the same blocks, the port
    equals JAX path by path, and every parting lies where
    ``tools/parity.JAX_PARTS`` lets it: a timing (lag x cycles + phase)
    one sample apart."""
    assert parity.JAX_PARTS["taps25"].phase_ties
    _, tcfg = _configs("taps25")
    bits, _ = parity.payload(tcfg, 32, parity.PARITY_PACKETS, SEED, "cpu")
    frames = parity.stream(tcfg, bits, SEED + 1, "cpu").numpy()
    C = frames.shape[1]
    _, tp = prod_rx_batch(tcfg, prod_rx_init_planes(tcfg, C, "cpu"),
                          torch.from_numpy(frames), fuse_frontend=True)
    _, tx = prod_rx_stream(tcfg, prod_rx_init(tcfg, (C,), "cpu"),
                           torch.from_numpy(frames))
    port = _ties(*({f: getattr(o, f).numpy().T for f in o._fields}
                   for o in (tp, tx)))
    c = int(np.flatnonzero(port.any(1))[0])
    out = _four_paths("taps25", frames[:, c:c + 1].copy())
    _same_decisions(out["port pallas"], out["jax pallas"])
    _same_decisions(out["port xla"], out["jax xla"])
    jax = _ties(out["jax pallas"], out["jax xla"])
    assert jax.any() and np.array_equal(jax, port[c])
    a, x = out["jax pallas"], out["jax xla"]
    for b in np.flatnonzero(jax):
        pos = [int(o["lag"][b]) * tcfg.cycles + int(o["timing_phase"][b])
               for o in (a, x)]
        assert abs(pos[0] - pos[1]) == 1
