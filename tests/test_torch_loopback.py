"""PyTorch port: the loopback modules against the JAX package's, on the
CPU -- ``modem/tx.py``, ``channel.py``, ``ber.py`` and the CLI.

Tolerances: ``tx_stream``'s int16 PCM equal to JAX's but for +/-1 LSB
on at most 1 in 1000 samples (the f32 sample sits at an integer to
within the sum order's rounding, and truncation moves it one way or the
other); the cast saturates as XLA's does, equal to the bit.  Channel
impairments within 1e-5 of the output's scale; the AWGN scale with JAX's
own normal draw fed through the port's one noise function.  BER scoring
equal to JAX's on the same RX outputs.  The CLI's ``loopback`` and
``demod`` (production and, on the C harness's stream, faithful at 0
and 20 Hz) print JAX's JSON lines; the one unrounded float,
``mean_cfo_hz``, within 1e-4 Hz.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu import ber as jber
from singlecarrier_tpu import channel as jchan
from singlecarrier_tpu import cli as jcli
from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import tx as jtx
from singlecarrier_tpu.utils import compat as jcompat
from singlecarrier_tpu_torch import ber as tber
from singlecarrier_tpu_torch import channel as tchan
from singlecarrier_tpu_torch import cli as tcli
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.device import to_int16
from singlecarrier_tpu_torch.modem import tx as ttx

TCFG = interop.config_from_dict(dataclasses.asdict(CFG))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _lsb_close(got, want):
    d = got.astype(np.int64) - want.astype(np.int64)
    assert got.dtype == want.dtype == np.int16
    assert np.abs(d).max() <= 1 and (d != 0).sum() <= want.size // 1000


# ----------------------------------------------------------------- TX

def test_qpsk_map_and_demap_match_jax():
    bits = np.random.default_rng(1).integers(0, 2, (3, 64)).astype(np.uint8)
    sj = jtx.qpsk_mod(jnp.asarray(bits))
    st = ttx.qpsk_mod(_t(bits))
    assert st.dtype == torch.complex64
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(ttx.qpsk_demod(st).numpy(),
                          np.asarray(jtx.qpsk_demod(sj)))
    assert np.array_equal(ttx.qpsk_demod(st).numpy(), bits)


@pytest.mark.parametrize("scramble,flush_gap", [
    (False, False), (True, False), (False, True), (True, True)])
def test_tx_stream_matches_jax(scramble, flush_gap):
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (2, 3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pj = np.asarray(jax.jit(lambda b: jtx.tx_stream(
        CFG, b, scramble=scramble, flush_gap=flush_gap))(jnp.asarray(bits)))
    pt = ttx.tx_stream(TCFG, bits, scramble=scramble, flush_gap=flush_gap,
                       device="cpu")
    assert pt.shape == (2, 3 * CFG.packet_size)
    _lsb_close(pt.numpy(), pj)
    gap = pt.numpy()[:, CFG.frame_size + 60:CFG.packet_size]
    assert flush_gap or not gap.any()


def test_int16_cast_saturates_as_xla_does():
    x = np.array([40000.7, -40000.7, 32767.9, -32768.9, 32766.5, -1.5, 0.9,
                  np.inf, -np.inf, np.nan, 1e9], np.float32)
    assert np.array_equal(to_int16(_t(x)).numpy(),
                          np.asarray(jnp.asarray(x).astype(jnp.int16)))
    assert to_int16(_t(x)).numpy()[0] == 32767
    # a TX frame driven past full scale
    rng = np.random.default_rng(3)
    d = rng.integers(0, 4, (2, 248))
    sym = ((1 - 2 * (d >> 1)) + 1j * (1 - 2 * (d & 1))).astype(np.complex64)
    pj, _ = jtx.tx_frame(CFG, jtx.tx_init(CFG, (2,)), jnp.asarray(sym),
                         60000.0)
    pt, _ = ttx.tx_frame(TCFG, ttx.tx_init(TCFG, (2,), device="cpu"),
                         _t(sym), 60000.0)
    pj = np.asarray(pj)
    assert (np.abs(pj.astype(int)) >= 32767).sum() > 100
    _lsb_close(pt.numpy(), pj)


# ------------------------------------------------------------ channel

def _pcm(n=6000, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3000, (2, n)).astype(np.float32)
    x[:, :500] = 0.0
    return x


@pytest.mark.parametrize("n", [6000, 5999])
def test_cfo_phase_and_analytic_match_jax(n):
    x = _pcm(n)
    _close(tchan._analytic(_t(x)).numpy(), jchan._analytic(jnp.asarray(x)))
    for f, ph, n0 in ((15.0, 0.0, 0), (-35.0, 0.3, 100)):
        _close(tchan.apply_cfo_phase(_t(x), f, ph, 8000.0, n0).numpy(),
               jchan.apply_cfo_phase(jnp.asarray(x), f, ph, 8000.0, n0))


def test_delay_drift_echo_and_roll_match_jax():
    x = _pcm()
    _close(tchan.fractional_delay(_t(x), 0.37).numpy(),
           jchan.fractional_delay(jnp.asarray(x), 0.37))
    _close(tchan.sample_rate_offset(_t(x), 150.0).numpy(),
           jchan.sample_rate_offset(jnp.asarray(x), 150.0))
    ech = ((3, 0.5), (11, -0.25))
    _close(tchan.multipath(_t(x), ech).numpy(),
           jchan.multipath(jnp.asarray(x), ech))
    assert np.array_equal(tchan.timing_offset(_t(x), 37).numpy(),
                          np.asarray(jchan.timing_offset(jnp.asarray(x), 37)))


def _feed_jax_noise(monkeypatch, key):
    """Route the port's one draw through JAX's ``random.normal``."""
    def normal(gen, shape, device):
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))
    monkeypatch.setattr(tchan, "_normal", normal)


@pytest.mark.parametrize("signal_power", [None, 2.5e6])
def test_awgn_matches_jax_with_its_draw(monkeypatch, signal_power):
    key = jax.random.PRNGKey(5)
    _feed_jax_noise(monkeypatch, key)
    x = _pcm()
    _close(tchan.awgn(None, _t(x), 6.0, signal_power=signal_power).numpy(),
           jchan.awgn(key, jnp.asarray(x), 6.0, signal_power=signal_power))


def test_channel_matches_jax_with_its_draw(monkeypatch):
    key = jax.random.PRNGKey(6)
    _feed_jax_noise(monkeypatch, key)
    x = _pcm()
    kw = dict(snr_db=8.0, freq_hz=12.0, phase_rad=0.2, delay=0.25, ppm=80.0,
              gain=0.7, fs=8000.0, echoes=((2, 0.3),))
    _close(tchan.channel(None, _t(x), device="cpu", **kw).numpy(),
           jchan.channel(key, jnp.asarray(x), **kw))
    clean = tchan.channel(None, _t(x), device="cpu")
    assert clean.dtype == torch.float32 and np.array_equal(clean.numpy(), x)


# ---------------------------------------------------------------- BER

def test_ber_helpers_match_jax():
    e = [0.0, 3.0, 6.5]
    assert np.array_equal(tber.qpsk_theory_ber(e), jber.qpsk_theory_ber(e))
    assert tber.snr_to_ebn0_db(4.0, TCFG) == jber.snr_to_ebn0_db(4.0, CFG)
    for k, n in ((0, 0), (0, 1000), (11712, 317440), (5, 5)):
        assert tber._wilson_ci(k, n) == jber._wilson_ci(k, n)
    for p, s in ((3, 9000), (10, 27830), (2, 100)):
        assert np.array_equal(tber.data_section_power_mask(TCFG, p, s),
                              jber.data_section_power_mask(CFG, p, s))


def _canned_outputs(n_trials, n_blocks, ref):
    """RX outputs that take every branch of the scoring: exact and
    off-by-some detections, a closer duplicate that replaces an earlier
    one, a farther one, out-of-range and far-off ones, misses, bit
    errors."""
    rng = np.random.default_rng(7)
    valid = np.zeros((n_trials, n_blocks), bool)
    lag = rng.integers(0, 376, (n_trials, n_blocks)).astype(np.int32)
    phs = rng.integers(0, 5, (n_trials, n_blocks)).astype(np.int32)
    bits = rng.integers(0, 2, (n_trials, n_blocks, ref.shape[1]),
                        dtype=np.uint8)
    plant = {(0, 1): (0, 0, 0), (0, 2): (180, 3, 1), (0, 3): (361, 1, 2),
             (1, 3): (340, 0, 2), (1, 4): (0, 0, 2), (1, 2): (0, 0, None),
             (1, 5): (200, 2, None), (2, 1): (0, 1, 0), (2, 2): (181, 0, 1),
             (2, 0): (10, 0, None)}
    for (t, b), (lg, ph, p) in plant.items():
        valid[t, b], lag[t, b], phs[t, b] = True, lg, ph
        if p is not None:
            bits[t, b] = ref[p]
            bits[t, b, rng.integers(0, ref.shape[1], 3 * t)] ^= 1
    valid[3] = rng.random(n_blocks) < 0.5
    return valid, bits, lag, phs


def test_ber_scoring_matches_jax_on_the_same_outputs(monkeypatch):
    """JAX's ``ber_run`` scores canned outputs (its ``fetch`` hands them
    in for the RX's); the port's ``score_outputs`` scores the same, with
    each packet's last 10 bits left out."""
    drop_tail_bits = 10
    n_packets, n_trials = 3, 4
    n_blocks = -(-n_packets * CFG.packet_size // CFG.frame_size) + 1
    seen = {}
    real_fetch = jcompat.fetch

    def fetch(x):
        k = seen["n"] = seen.get("n", 0) + 1
        if k == 1:
            seen["ref"] = real_fetch(x)
            seen["canned"] = _canned_outputs(
                n_trials, n_blocks,
                seen["ref"].reshape(n_packets, CFG.bits_per_frame))
        return real_fetch(x) if k <= 2 else seen["canned"][k - 3]

    monkeypatch.setattr(jcompat, "fetch", fetch)
    rj = jber.ber_run(CFG, jax.random.PRNGKey(0), n_packets=n_packets,
                      n_trials=n_trials, drop_tail_bits=drop_tail_bits,
                      snr_db=9.0)
    assert seen["n"] == 6
    ref = seen["ref"].reshape(n_packets, CFG.bits_per_frame)
    rt = tber.score_outputs(TCFG, ref, *seen["canned"], snr_db=9.0,
                            drop_tail_bits=drop_tail_bits)
    assert rt == rj
    assert rt["false_detects"] > 2 and 0 < rt["detection_rate"] < 1
    assert rt["err_bits"] > 0


def test_ber_run_paths_agree_on_one_stream():
    """The three paths on the stream one seed gives (the kernel paths by
    their plain versions here): every packet found, no false detect,
    the two kernel paths' errors equal."""
    res = {}
    for path in tber.PATHS:
        gen = torch.Generator().manual_seed(11)
        res[path] = tber.ber_run(TCFG, gen, snr_db=7.0, n_packets=2,
                                 n_trials=3, path=path, device="cpu")
    for r in res.values():
        assert r["detection_rate"] == 1.0 and r["false_detects"] == 0
        assert r["total_bits"] == 6 * CFG.bits_per_frame and r["ber"] < 0.02
    assert res["batch_pallas"]["err_bits"] == res["fused_rx"]["err_bits"]
    with pytest.raises(ValueError, match="unknown path"):
        tber.ber_run(TCFG, None, path="scan", device="cpu")


# ---------------------------------------------------------------- CLI

def _json_lines(text):
    return [json.loads(line) for line in text.strip().splitlines()]


def test_cli_loopback_prints_the_jax_cli_line(capsys):
    assert jcli.main(["loopback", "--packets", "3"]) == 0
    want = _json_lines(capsys.readouterr().out)
    assert tcli.main(["loopback", "--packets", "3", "--device", "cpu"]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert abs(g.pop("mean_cfo_hz") - w.pop("mean_cfo_hz")) < 1e-4
    assert g == w == {"packets_sent": 3, "packets_detected": 3, "ber": 0.0}


def test_cli_mod_then_demod_prints_the_jax_cli_lines(tmp_path, capsys,
                                                     golden):
    raw, bits = str(tmp_path / "tx.raw"), str(tmp_path / "bits.npy")
    assert tcli.main(["mod", "--out", raw, "--bits-out", bits, "--packets",
                      "3", "--seed", "3", "--scramble", "--device",
                      "cpu"]) == 0
    capsys.readouterr()
    assert jcli.main(["demod", "--in", raw, "--descramble"]) == 0
    want = _json_lines(capsys.readouterr().out)
    assert tcli.main(["demod", "--in", raw, "--descramble", "--device",
                      "cpu"]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert got == want and len(got) == 3
    sent = np.load(bits).reshape(3, CFG.bits_per_frame)
    assert [r["bits"] for r in got] == ["".join(map(str, b)) for b in sent]
    # the faithful RX on the C harness's stream's first 8 frames, as the
    # C at 0 and 20 Hz
    raw = str(tmp_path / "harness.raw")
    golden["tx_pcm"][:8 * CFG.frame_size].astype("<i2").tofile(raw)
    for extra, tag in (([], "rxt"), (["--freq-offset", "20"], "f20_rxt")):
        args = ["demod", "--in", raw, "--mode", "faithful", *extra]
        assert jcli.main(args) == 0
        want = _json_lines(capsys.readouterr().out)
        assert tcli.main(args + ["--device", "cpu"]) == 0
        got = _json_lines(capsys.readouterr().out)
        assert got == want
        valid = golden[f"{tag}_valid"][:8]
        assert [r["frame"] for r in got if r["frame"] < 8] \
            == np.nonzero(valid)[0].tolist()
    assert tcli.main(["info", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["derived"]["frame_size"] \
        == CFG.frame_size
