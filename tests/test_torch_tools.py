"""PyTorch port: the tools of ``singlecarrier_tpu_torch.tools`` on the CPU.

What runs here, without a card and without an interpret-mode call: the
device rule of every tool (no ``--device`` raises naming the card; the
timing tools also refuse ``--device cpu``); ``_measure.kernel_bounds``
against the bound column of ``PERF.md`` section 6; ``parity`` at 4
channels x 2 packets (its record carries ``PARITY_TPU.json``'s keys; one
flipped output bit gives ``ok: false`` and exit 1); ``detection``'s
Wilson interval against the JAX package's; its host-side criterion
against the plain path's ``valid``; and ``gated_decode_bench``'s verify
step at 8 channels.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from singlecarrier_tpu.ber import _wilson_ci as jax_wilson
from singlecarrier_tpu_torch import DEFAULT_CONFIG
from singlecarrier_tpu_torch.modem import prod_rx_batch, prod_rx_init_planes
from singlecarrier_tpu_torch.tools import (
    _measure, detection, gated_decode_bench, gated_wrapper_bench,
    ingest_bench, parity, profile_stages, roofline, scaling_bench)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = _measure.bench_point(DEFAULT_CONFIG)
TOOLS = {"parity": (parity, False), "detection": (detection, False),
         "roofline": (roofline, True),
         "profile_stages": (profile_stages, True),
         "gated_decode_bench": (gated_decode_bench, True),
         "gated_wrapper_bench": (gated_wrapper_bench, True),
         "ingest_bench": (ingest_bench, True),
         "scaling_bench": (scaling_bench, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_device_rule(name, tmp_path, monkeypatch):
    """Without a card a tool raises, naming the card; a timing tool also
    refuses the CPU, whose times would not be the card's."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the rule is about its absence")
    module, timing = TOOLS[name]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device.*card"):
        module.main([])
    if timing:
        with pytest.raises(ValueError, match="refuses --device cpu"):
            module.main(["--device", "cpu"])
    assert not os.listdir(tmp_path)             # nothing written


def test_kernel_bounds_match_perf_table():
    """The bounds at 8192 x 4 blocks at the bench operating point, to the
    four decimals of ``PERF.md`` section 6's bound column."""
    want = {"frontend_decim": 0.1113, "hunt": 0.0799,
            "extract_decode": 0.3007, "extract_gate": 0.0151,
            "frontend_rows": 0.1142, "frontend_full": 0.1885,
            "frontend_decim_folded": 0.1113, "frontend_rows_folded": 0.1142}
    got = _measure.kernel_bounds(BENCH, 8192 * 4, 8192)
    assert {k: round(got[k][0], 4) for k in want} == want
    assert got["frontend_full"][1] == "operations"
    assert got["extract_decode"][1] == "operations"
    assert got["hunt"][1] == "bytes"


def _parity(tmp_path, config, *extra):
    out = tmp_path / f"{config.replace(' ', '_')}.json"
    rc = parity.main(["--device", "cpu", "--channels", "4", "--packets",
                      "2", "--config", config, "--out", str(out), *extra])
    return rc, json.loads(out.read_text())


@pytest.mark.parametrize("config", ["default", "hunt int8"])
def test_parity_on_cpu_is_ok_with_the_records_keys(config, tmp_path):
    rc, rec = _parity(tmp_path, config)
    with open(os.path.join(ROOT, "PARITY_TPU.json")) as f:
        tpu = json.load(f)
    assert rc == 0 and rec["ok"] and rec["xla_ok"]
    assert rec["device"] == "cpu" and rec["card"] is None
    assert set(tpu) <= set(rec)
    path_keys = set(next(iter(tpu["paths"].values())))
    assert set(rec["paths"]) == {"batch_pallas", "fused_rx", "scan_pallas",
                                 "pallas_fe_xla_decode"}
    for path, rep in rec["paths"].items():
        assert path_keys <= set(rep), path
        assert rep["ok"] and rep["bit_errors_vs_truth"][0] == 0, path
    assert rec["expected_packets"] == 8 == rec["xla_packets_detected"]
    assert rec["hunt_dtype"] == ("int8" if config == "hunt int8" else "bf16")
    assert not any(k.endswith("_per_sec") or k.endswith("GSps")
                   for k in rec)                # a CPU record holds no rate


def test_parity_flags_one_flipped_bit(tmp_path, monkeypatch):
    real = parity.prod_rx_stream_pallas

    def flipped(*args, **kw):
        state, out = real(*args, **kw)
        bits = out.bits.clone()
        b, c = (int(i) for i in torch.nonzero(out.valid)[0])
        bits[b, c, 0] ^= 1
        return state, out._replace(bits=bits)

    monkeypatch.setattr(parity, "prod_rx_stream_pallas", flipped)
    rc, rec = _parity(tmp_path, "default")
    assert rc == 1 and rec["ok"] is False
    for path in ("scan_pallas", "pallas_fe_xla_decode"):
        rep = rec["paths"][path]
        assert not rep["ok"] and rep["bit_diffs_vs_xla"] == 1, path
    assert rec["paths"]["fused_rx"]["ok"]


def _held(p, o, parts=parity.Parts(), rule="full"):
    """``parity.hold`` of two synthetic [2, 4] outputs: a sent packet at
    block 1 of each channel, decoded by both paths, one bit wrong on
    channel 0 in ``p``'s copy only where ``p`` flips it."""
    def truth(out):
        hits = {(c, 1) for c in range(2) if out.valid[c, 1]}
        wrong = {(c, 1): int(out.bits[c, 1].sum()) for c in range(2)
                 if out.bits[c, 1].any()}
        false = int(out.valid.sum()) - len(hits)
        return (sum(wrong.values()), 2 * DEFAULT_CONFIG.bits_per_frame,
                false, hits, wrong)
    return parity.hold(DEFAULT_CONFIG, p, o, truth(p), truth(o), 2, parts,
                       rule)[0]


def _out():
    valid = np.zeros((2, 4), bool)
    valid[:, 1] = True
    z = np.zeros((2, 4), np.float32)
    return types.SimpleNamespace(
        valid=valid, bits=np.zeros((2, 4, 8), np.uint8),
        lag=z.astype(np.int32), timing_phase=z.astype(np.int32),
        cfo_hz=z.copy(), eq_error=z.copy())


def test_parity_hold_compares_wrong_packets_only_on_the_same_planes():
    """A bit the two paths decode apart on a packet that one of them
    decodes wrong: "" and "same" leave it out, "planes" (two paths on the
    same planes) does not, "full" holds the truth."""
    p, o = _out(), _out()
    p.bits[0, 1, 3] = 1
    assert _held(p, o, rule="") and _held(p, o, rule="same")
    assert not _held(p, o, rule="planes")
    assert not _held(p, o, rule="full")
    assert _held(o, o, rule="planes") and _held(o, o, rule="full")


@pytest.mark.parametrize("flips", [1, 2])
def test_parity_hold_bounds_the_noise_detects(flips):
    """Noise blocks that cross the gate in one path only: ``Parts()``
    refuses each one, ``Parts(noise_detects=n)`` takes at most n, and
    against the truth at most the other path's false detects and the
    flips."""
    p, o = _out(), _out()
    p.valid[:flips, 3] = True
    p.bits[:flips, 3] = 1            # equalized noise: not compared
    assert not _held(p, o)
    assert _held(p, o, parity.Parts(noise_detects=flips))
    assert not _held(p, o, parity.Parts(noise_detects=flips - 1))
    assert _held(p, o, parity.Parts(noise_detects=flips), "")


def test_wilson_interval_is_the_jax_packages():
    for n in (1, 7, 1000, 1048576, 4194304):
        for k in sorted(k for k in {0, 1, 3, n // 3, n - 1, n} if k <= n):
            assert detection.wilson(k, n) == pytest.approx(
                jax_wilson(k, n), rel=1e-12, abs=1e-15), (k, n)
    assert detection.wilson(0, 0) == (0.0, 1.0)


@pytest.mark.parametrize("fused", [True, False])
def test_host_criterion_is_the_paths_valid(fused):
    """Packets on half the channels, full-scale noise on the others: the
    host-side criterion at the configured gate reproduces ``valid`` on
    every row, and sweeping the gate moves it."""
    dev = torch.device("cpu")
    bits, _ = parity.payload(DEFAULT_CONFIG, 4, 3, 3, dev)
    frames = parity.stream(DEFAULT_CONFIG, bits, 4, dev, 4.0, 20.0)
    gen = torch.Generator().manual_seed(5)
    noise = torch.randint(-16384, 16384, frames.shape, generator=gen,
                          dtype=torch.int16)
    frames = torch.cat([frames, noise], 1)
    cfg = BENCH
    _, out = prod_rx_batch(cfg, prod_rx_init_planes(cfg, 8, dev), frames,
                           fuse_frontend=fused)
    own = detection.criterion(out.peak, out.energy, out.matches,
                              cfg.effective_peak_gate, cfg.match_threshold)
    assert torch.equal(own, out.valid)
    assert 0 < int(out.valid.sum()) < out.valid.numel()
    loose = detection.criterion(out.peak, out.energy, out.matches, 0.0,
                                cfg.match_threshold)
    assert bool((loose >= own).all())


def test_gated_decode_verify_at_8_channels():
    rep = gated_decode_bench.verify(BENCH, 8, 8, torch.device("cpu"))
    assert rep["detections"] > 0 and rep["mismatched"] == 0
    assert rep["bit_identical"] == rep["detections"]
    assert rep["valid"] > 0 and rep["valid_lag_phase_equal"] == rep["valid"]


def test_gated_decode_break_even():
    rows = {"0.1": {"t_compact_decode_s": 0.01},
            "0.5": {"t_compact_decode_s": 0.05}}
    assert gated_decode_bench.break_even(0.08, 0.05, rows) == (
        pytest.approx(0.3))
    assert gated_decode_bench.break_even(0.2, 0.05, rows) is None
