"""PyTorch port: the card's false detects on noise, replayed through JAX.

``tests/fixtures_torch/false_detects.npz`` holds up to 16 false detects
that ``python3 -m singlecarrier_tpu_torch.tools.detection
--save-false-detects`` found on the card: blocks of full-scale noise
that the main path at the bench operating point (int8 hunt, gate 7)
declared valid.  Each is kept as the gated RX's phase 2 rebuilds a
detection: the pair of raw blocks its hunt window reads (b-1 and b) and
the plane state entering b-1 (the mixer phase, the FIR tail of b-2's
halo, zero planes), as ``interop.planes_to_numpy`` gives it (the planes
in f32, which holds bf16 exactly).  On the card the pair replayed through
the same path gave the detect again (the fixture's ``replay_*`` rows).

Here the pairs, one per channel, go through the JAX package's
``prod_rx_batch(fuse_frontend=True)`` in interpret mode (one call) and
the port's plain ``prod_rx_batch(fuse_frontend=True)`` on the CPU.  The
North star's criterion on block 1, the detect's block: valid flag, lag
and phase equal, and equal to the card's; peak equal to the bit (the
int8 hunt's sums are exact integers in f32) and energy within 1e-5 of
itself (f32 sums of 256 squares in another order).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import ModemConfig as JaxConfig
from singlecarrier_tpu.modem.rx_production import prod_rx_batch as jbatch
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import prod_rx_batch

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures_torch",
                       "false_detects.npz")
FIELDS = ("valid", "lag", "timing_phase", "peak", "energy", "matches")


@pytest.fixture(scope="module")
def saved():
    z = np.load(FIXTURE)
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def replays(saved):
    """Block 1 of each pair through JAX (interpret mode) and the port's
    plain path: {side: {field: [K]}}."""
    fields = json.loads(str(saved["config"]))
    jcfg = JaxConfig(**fields)
    tcfg = interop.config_from_dict(fields)
    planes = [saved[k] for k in ("p0r", "p0i", "t0r", "t0i")]
    pcm = saved["pcm"]
    _, jo = jbatch(jcfg, tuple(jnp.asarray(x) for x in planes)
                   + (jnp.asarray(saved["dprev"]).astype(jnp.bfloat16),),
                   jnp.asarray(pcm), fuse_frontend=True, interpret=True)
    tplanes = interop.planes_from_numpy(planes + [saved["dprev"]],
                                        device="cpu")
    tplanes = tplanes[:4] + (tplanes[4].to(torch.bfloat16),)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, to = prod_rx_batch(tcfg, tplanes, torch.from_numpy(pcm),
                              fuse_frontend=True)
    finally:
        torch.set_num_threads(n)
    return {"jax": {f: np.asarray(getattr(jo, f))[1] for f in FIELDS},
            "port": {f: getattr(to, f)[1].numpy() for f in FIELDS}}


def test_fixture_holds_false_detects_of_the_card(saved):
    fields = json.loads(str(saved["config"]))
    K = saved["coords"].shape[0]
    assert 1 <= K <= 16 and os.path.getsize(FIXTURE) <= 1 << 20
    assert (fields["hunt_dtype"], fields["decim_dtype"],
            fields["peak_gate"]) == ("int8", "bf16", 7.0)
    assert "H100" in str(saved["card"])
    assert saved["run_valid"].all()                  # each one a detect
    n = interop.config_from_dict(fields).frame_size
    assert saved["pcm"].shape == (2, K, n)
    assert not saved["dprev"].any()                  # the pair's zero planes
    for f in FIELDS:                                 # the card's replay
        assert np.array_equal(saved["replay_" + f], saved["run_" + f]), f


@pytest.mark.parametrize("side", ["jax", "port"])
def test_replayed_false_detects_decide_alike(saved, replays, side):
    got, card = replays[side], {f: saved["replay_" + f] for f in FIELDS}
    for f in ("valid", "lag", "timing_phase", "matches"):
        assert np.array_equal(got[f], card[f]), (side, f, got[f], card[f])
    assert np.array_equal(got["peak"], card["peak"]), side
    np.testing.assert_allclose(got["energy"], card["energy"], rtol=1e-5)


def test_jax_and_port_agree_on_every_replayed_row(replays):
    j, t = replays["jax"], replays["port"]
    for f in ("valid", "lag", "timing_phase", "matches", "peak"):
        assert np.array_equal(j[f], t[f]), (f, j[f], t[f])
    np.testing.assert_allclose(t["energy"], j["energy"], rtol=1e-5)
