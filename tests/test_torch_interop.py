"""PyTorch port: its own numerology and tables against the JAX package's,
state interop, imports free of JAX and of the JAX package, the device
rule, the configuration knobs every entry point runs, and the CPU route
of the kernel wrappers."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from singlecarrier_tpu import constants as jconst
from singlecarrier_tpu import filter_design as jfd
from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.config import ModemConfig as JaxConfig
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu_torch import constants as tconst
from singlecarrier_tpu_torch import filter_design as tfd
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.config import DEFAULT_CONFIG as TCFG
from singlecarrier_tpu_torch.config import ModemConfig as TorchConfig
from singlecarrier_tpu_torch.modem import (GatedRxState, ProdRxState,
                                           make_prod_rx_fn, planes_to_state,
                                           prod_rx_batch, prod_rx_batch_gated,
                                           prod_rx_gated_init, prod_rx_init,
                                           prod_rx_init_planes,
                                           prod_rx_stream_pallas,
                                           prod_rx_stream_superstep,
                                           state_to_planes)
from singlecarrier_tpu_torch.modem import rx_production as trx
from singlecarrier_tpu_torch.ops import _build
from singlecarrier_tpu_torch.ops.frontend import fused_frontend_decim
from singlecarrier_tpu_torch.ops.fused_rx import fused_rx_block

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "singlecarrier_tpu_torch"

VARIANTS = [{}, {"decim_dtype": "bf16", "hunt_dtype": "int8",
                 "ls_refit_symbols": 128},
            {"alpha": 0.50, "corr_segments": 32, "eq_length": 7},
            {"fs": 9600.0, "rs": 2400.0, "ns": 4, "preamble_length": 64}]


def _properties(cls):
    return sorted(k for k, v in vars(cls).items() if isinstance(v, property))


def test_config_copy_equals_the_jax_package():
    """Every field, default and derived property of the port's own
    ``ModemConfig`` equals the JAX package's, so the copies cannot drift
    apart unseen."""
    assert TorchConfig is not JaxConfig
    fj = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    ft = [(f.name, f.type, f.default)
          for f in dataclasses.fields(TorchConfig)]
    assert fj == ft
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(CFG)
    props = _properties(JaxConfig)
    assert props == _properties(TorchConfig)
    assert {"effective_peak_gate", "pkt_window", "symbols_per_block",
            "frame_size", "match_threshold", "bits_per_frame"} <= set(props)
    for kw in VARIANTS:
        cj = CFG.replace(**kw)
        ct = interop.config_from_dict(dataclasses.asdict(cj))
        assert isinstance(ct, TorchConfig)
        assert ct == TCFG.replace(**kw)
        for name in props:
            assert getattr(ct, name) == getattr(cj, name), name
    for bad in ({"ntaps": 48}, {"fs": 8000.0, "rs": 3000.0},
                {"hunt_dtype": "fp8"}, {"alpha": 0.0}):
        for cls in (JaxConfig, TorchConfig):
            with pytest.raises(ValueError):
                cls(**bad)


def test_constant_tables_equal_the_jax_package():
    names = [n for n in dir(jconst) if n.isupper()]
    assert {"PREAMBLE_VALUES", "ALPHA35_ROOT", "ALPHA50_ROOT"} <= set(names)
    for n in names:
        a, b = getattr(jconst, n), getattr(tconst, n)
        assert np.array_equal(np.asarray(a), np.asarray(b)), n
        assert np.asarray(a).dtype == np.asarray(b).dtype, n
    for alpha in (0.35, 0.50):
        assert np.array_equal(tconst.rrc_taps(alpha, 49),
                              jconst.rrc_taps(alpha, 49))
        assert np.array_equal(tfd.reference_taps(alpha),
                              jfd.reference_taps(alpha))
    assert np.array_equal(tconst.scramble_dibit_mask(),
                          jconst.scramble_dibit_mask())
    assert np.array_equal(tconst.scramble_keystream(),
                          jconst.scramble_keystream())


@pytest.mark.parametrize("decim_dtype", ["bf16", "f32"])
def test_plane_state_round_trip(decim_dtype):
    cfg = CFG.replace(decim_dtype=decim_dtype)
    tcfg = TCFG.replace(decim_dtype=decim_dtype)
    rng = np.random.default_rng(0)
    planes = [np.asarray(a) for a in jrx.prod_rx_init_planes(cfg, 3)]
    planes = [(rng.normal(size=a.shape)).astype(a.dtype) for a in planes]
    want_dt = ml_dtypes.bfloat16 if decim_dtype == "bf16" else np.float32
    assert planes[4].dtype == want_dt
    st = interop.planes_from_numpy(planes, device="cpu")
    assert st[4].dtype == (torch.bfloat16 if decim_dtype == "bf16"
                           else torch.float32)
    # the same values the JAX package would compute with
    assert np.array_equal(st[4].float().numpy(),
                          planes[4].astype(np.float32))
    back = interop.planes_to_numpy(st)
    for a, b in zip(planes, back):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    # and the port's own initial state is the JAX package's
    mine = interop.planes_to_numpy(prod_rx_init_planes(tcfg, 3, "cpu"))
    for a, b in zip(jrx.prod_rx_init_planes(cfg, 3), mine):
        assert np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("decim_dtype", ["bf16", "f32"])
def test_complex_state_round_trip(decim_dtype):
    """``ProdRxState`` crosses the packages unchanged, and
    planes -> state -> planes is exact (bf16 planes widen to f32 and
    round back), as in the JAX package."""
    cfg = CFG.replace(decim_dtype=decim_dtype)
    tcfg = TCFG.replace(decim_dtype=decim_dtype)
    init_j = [np.asarray(a) for a in jrx.prod_rx_init(cfg, (3,))]
    init_t = interop.state_to_numpy(prod_rx_init(tcfg, (3,), "cpu"))
    for a, b in zip(init_j, init_t):
        assert a.dtype == b.dtype == np.complex64
        assert np.array_equal(a, b)
    rng = np.random.default_rng(5)
    leaves = [(rng.normal(size=a.shape) + 1j * rng.normal(size=a.shape)
               ).astype(np.complex64) for a in init_j]
    st = interop.state_from_numpy(leaves, device="cpu")
    assert isinstance(st, ProdRxState)
    for a, b in zip(leaves, interop.state_to_numpy(st)):
        assert np.array_equal(a, b)
    # state_to_planes equals the JAX package's, bit for bit
    want = jrx.state_to_planes(cfg, jrx.ProdRxState(*leaves))
    got = state_to_planes(tcfg, st)
    for a, b in zip(want, interop.planes_to_numpy(got)):
        a = np.ascontiguousarray(a)
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    # planes -> state -> planes is exact
    again = state_to_planes(tcfg, planes_to_state(got))
    for a, b in zip(got, again):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back_j = jrx.planes_to_state(want)
    for a, b in zip(back_j, interop.state_to_numpy(planes_to_state(got))):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("decim_dtype", ["bf16", "f32"])
def test_gated_state_round_trip(decim_dtype):
    """``GatedRxState`` crosses the packages unchanged: the planes as
    the plane state, the two int16 PCM leaves as they are; and the
    port's initial state is the JAX package's."""
    from singlecarrier_tpu.modem import prod_rx_gated_init as jax_init
    cfg = CFG.replace(decim_dtype=decim_dtype)
    tcfg = TCFG.replace(decim_dtype=decim_dtype)
    init_j = jax_init(cfg, 3)
    init_t = interop.gated_state_to_numpy(prod_rx_gated_init(tcfg, 3, "cpu"))
    for a, b in zip(init_j.planes, init_t[0]):
        assert np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)
    for a, b in zip(init_j[1:], init_t[1:]):
        assert b.dtype == np.int16 and np.array_equal(np.asarray(a), b)
    rng = np.random.default_rng(9)
    planes = [rng.normal(size=a.shape).astype(np.asarray(a).dtype)
              for a in init_j.planes]
    pcm = [rng.integers(-2 ** 15, 2 ** 15, a.shape).astype(np.int16)
           for a in init_j[1:]]
    st = interop.gated_state_from_numpy((planes, *pcm), device="cpu")
    assert isinstance(st, GatedRxState)
    assert st.pcm_prev.dtype == st.pcm_prev2_tail.dtype == torch.int16
    assert st.planes[4].dtype == (torch.bfloat16 if decim_dtype == "bf16"
                                  else torch.float32)
    back = interop.gated_state_to_numpy(st)
    for a, b in zip(planes, back[0]):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    for a, b in zip(pcm, back[1:]):
        assert np.array_equal(a, b)


def test_the_card_is_the_default_device():
    """Without ``device`` the constructors make CUDA tensors, and raise
    where there is no card; the processing entry points follow their
    state."""
    from singlecarrier_tpu_torch.modem import rx_frame, rx_init
    if torch.cuda.is_available():
        assert prod_rx_init_planes(TCFG, 2)[0].is_cuda
        assert prod_rx_init(TCFG, (2,)).phase.is_cuda
        assert rx_init(TCFG, (2,)).rx_timing.is_cuda
        return
    z = np.zeros(2, np.float32)
    from singlecarrier_tpu_torch.ber import ber_run, ber_sweep
    from singlecarrier_tpu_torch.channel import channel
    from singlecarrier_tpu_torch.cli import main as cli_main
    from singlecarrier_tpu_torch.modem.tx import tx_init, tx_stream
    bits = np.zeros((1, TCFG.ns, 2 * TCFG.data_symbols), np.uint8)
    for make in (lambda: prod_rx_init_planes(TCFG, 2),
                 lambda: prod_rx_init(TCFG, (2,)),
                 lambda: prod_rx_gated_init(TCFG, 2),
                 lambda: tx_init(TCFG, (2,)),
                 lambda: tx_stream(TCFG, bits),
                 lambda: channel(None, np.zeros(8, np.float32)),
                 lambda: ber_run(TCFG, None),
                 lambda: ber_sweep(TCFG, [4.0]),
                 lambda: cli_main(["loopback", "--packets", "1"]),
                 lambda: cli_main(["demod", "--in", "-", "--mode",
                                   "faithful"]),
                 lambda: rx_init(TCFG, (2,)),
                 lambda: interop.rx_state_from_numpy([z] * 7),
                 lambda: interop.planes_from_numpy([z]),
                 lambda: interop.state_from_numpy([z]),
                 lambda: interop.gated_state_from_numpy(([z], z, z))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    state = prod_rx_init_planes(TCFG, 2, device="cpu")
    assert all(t.device.type == "cpu" for t in state)
    pcm = torch.zeros((1, 2, TCFG.frame_size), dtype=torch.int16)
    new, out = prod_rx_batch(TCFG, state, pcm)
    assert out.valid.device.type == new[4].device.type == "cpu"
    new, out = rx_frame(TCFG, rx_init(TCFG, (2,), device="cpu"), pcm[0])
    assert out.valid.device.type == new.rx_timing.device.type == "cpu"


def test_package_imports_without_jax():
    code = ("import sys; import singlecarrier_tpu_torch, "
            "singlecarrier_tpu_torch.modem, singlecarrier_tpu_torch.interop, "
            "singlecarrier_tpu_torch.ops.fused_rx, "
            "singlecarrier_tpu_torch.ops._build, "
            "singlecarrier_tpu_torch.modem.tx, singlecarrier_tpu_torch.ber, "
            "singlecarrier_tpu_torch.channel, singlecarrier_tpu_torch.cli, "
            "singlecarrier_tpu_torch.__main__, "
            "singlecarrier_tpu_torch.scramble, "
            "singlecarrier_tpu_torch.adaptive.ls_equalizer, "
            "singlecarrier_tpu_torch.adaptive.blocked_rls, "
            "singlecarrier_tpu_torch.modem.rx, "
            "singlecarrier_tpu_torch.dsp.fir, "
            "singlecarrier_tpu_torch.dsp.fftops, "
            "singlecarrier_tpu_torch.dsp.correlate, "
            "singlecarrier_tpu_torch.dsp.decimate, "
            "singlecarrier_tpu_torch.utils.linalg, "
            "singlecarrier_tpu_torch.runtime, "
            "singlecarrier_tpu_torch.runtime.checkpoint, "
            "singlecarrier_tpu_torch.runtime.engine, "
            "singlecarrier_tpu_torch.runtime.failover, "
            "singlecarrier_tpu_torch.runtime.ingest, "
            "singlecarrier_tpu_torch.runtime.metrics, "
            "singlecarrier_tpu_torch.runtime.profiling, "
            "singlecarrier_tpu_torch.runtime.stream, "
            "singlecarrier_tpu_torch.runtime.validate, "
            "singlecarrier_tpu_torch.parallel, "
            "singlecarrier_tpu_torch.parallel.mesh, "
            "singlecarrier_tpu_torch.parallel.sharded_rx, "
            "singlecarrier_tpu_torch.parallel.timeshard, "
            "singlecarrier_tpu_torch.parallel.multihost, "
            "singlecarrier_tpu_torch.kernel_ab, "
            "singlecarrier_tpu_torch.tools, "
            "singlecarrier_tpu_torch.tools._measure, "
            "singlecarrier_tpu_torch.tools.parity, "
            "singlecarrier_tpu_torch.tools.detection, "
            "singlecarrier_tpu_torch.tools.roofline, "
            "singlecarrier_tpu_torch.tools.profile_stages, "
            "singlecarrier_tpu_torch.tools.gated_decode_bench, "
            "singlecarrier_tpu_torch.tools.gated_wrapper_bench, "
            "singlecarrier_tpu_torch.tools.ingest_bench, "
            "singlecarrier_tpu_torch.tools.scaling_bench, "
            "torch.distributed.checkpoint; "
            "from singlecarrier_tpu_torch.runtime import (save_sharded, "
            "restore_sharded); "
            "from singlecarrier_tpu_torch.parallel import *; "
            "assert len(singlecarrier_tpu_torch.parallel.__all__) == 12; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'singlecarrier_tpu' or "
            "m.startswith('singlecarrier_tpu.') or m == 'chip_smoke'); "
            "assert not bad, bad; "
            "assert 'singlecarrier_tpu_torch.config' in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_package_sources():
    pat = re.compile(r"^\s*(import jax|from jax|import singlecarrier_tpu\b"
                     r"(?!_torch)|from singlecarrier_tpu(\.|\s))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 26
    for f in files:
        assert not pat.search(f.read_text()), f
    assert pat.search("from singlecarrier_tpu.config import X")
    assert pat.search("    import singlecarrier_tpu")
    assert not pat.search("from singlecarrier_tpu_torch.config import X")


@pytest.mark.parametrize("knob", [
    {"mixer_fold": True}, {"frac_timing": True},
    {"mixer_fold": True, "decim_dtype": "bf16", "hunt_dtype": "int8"},
    {"hunt_norm": "energy"}, {"hunt_norm": "none"}, {"ls_gram": "direct"},
    {"ls_bvec": "matmul"}, {"cfo_dtype": "bf16"},
    {"frontend_dtype": "f32"}, {"hunt_dtype": "f32"},
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_ported_knobs_run(knob):
    """The knobs this port once refused: every entry point that takes
    them runs (the streaming paths, the XLA path, the batch paths in every
    flag combination, the superstep and the gated RX)."""
    cfg = TCFG.replace(**knob)
    state = prod_rx_init_planes(cfg, 2, "cpu")
    cstate = prod_rx_init(cfg, (2,), "cpu")
    pcm = torch.zeros((2, 2, cfg.frame_size), dtype=torch.int16)
    _, out = prod_rx_stream_pallas(cfg, cstate, pcm)
    assert out.valid.shape == (2, 2) and not bool(out.valid.any())
    _, out = trx.prod_rx_stream(cfg, cstate, pcm)
    assert out.valid.shape == (2, 2) and not bool(out.valid.any())
    if cfg.frac_timing:
        return                  # the batch paths refuse it, as in JAX
    for flags in ({"fuse_frontend": True}, {}):
        _, out = prod_rx_batch(cfg, state, pcm, **flags)
        assert out.valid.shape == (2, 2)
    for flags in ({"fuse_hunt": False},
                  {"fuse_hunt": False, "fuse_extract": False}):
        _, out = prod_rx_batch(cfg, cstate, pcm, **flags)
        assert out.valid.shape == (2, 2)
    _, out = prod_rx_stream_superstep(cfg, state, pcm, superstep=2,
                                      fuse_frontend=True)
    assert out.valid.shape == (2, 2)
    _, gout = prod_rx_batch_gated(cfg, prod_rx_gated_init(cfg, 2, "cpu"),
                                  pcm, max_detections=2)
    assert int(gout["count"]) == 0


def test_unported_paths_raise():
    state = prod_rx_init_planes(TCFG, 2, "cpu")
    cstate = prod_rx_init(TCFG, (2,), "cpu")
    pcm = torch.zeros((1, 2, TCFG.frame_size), dtype=torch.int16)
    with pytest.raises(TypeError, match="ProdRxState or the 5-tuple"):
        prod_rx_batch(TCFG, state[:4], pcm, fuse_frontend=True)
    # the stage probes of the TPU kernel (only "full" and "gate" run)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_rx_block(TCFG, pcm, *state, stage="hunt")
    z = torch.zeros((2,))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_frontend_decim(TCFG, pcm[0], z, z, z, z,
                             debug_mode="store_only")
    with pytest.raises(ValueError, match="frac_timing"):
        prod_rx_batch(TCFG.replace(frac_timing=True), state, pcm,
                      fuse_frontend=True)
    cfg = TCFG.replace(corr_segments=32)
    with pytest.raises(NotImplementedError, match="corr_segments"):
        _build.kernel_limits(cfg)


@pytest.mark.parametrize("frac_timing", [False, True],
                         ids=["integer", "frac"])
def test_unfused_stream_and_xla_fn_match_jax(golden, frac_timing):
    """The paths that raised until the XLA back end was ported:
    ``prod_rx_stream_pallas(fuse_decode=False)`` (JAX in interpret mode)
    and, with integer timing, ``make_prod_rx_fn(cfg)``, on the golden
    stream over 3 channels at other delays, two calls carrying the
    state; held to the ROADMAP criterion (valid, bits, lag and phase
    identical; |dcfo| < 0.5 Hz, |deq_error| < 2e-3)."""
    cfg = CFG.replace(frac_timing=frac_timing)
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    n = CFG.frame_size
    tx = golden["tx_pcm"].astype(np.int16)
    x = np.zeros((3, 17 * n), np.int16)
    for c, d in enumerate((0, 611, 1500)):
        x[c, d:d + len(tx)] = tx
    frames = x.reshape(3, 17, n)

    def agree(o_t, o_j):
        o_t = [t.numpy() for t in o_t]
        o_j = jax.tree.map(np.asarray, o_j)
        v = o_j.valid
        assert int(v.sum()) >= 10
        assert np.array_equal(o_t[0], v)
        for k, name in ((1, "bits"), (3, "lag"), (4, "timing_phase")):
            assert np.array_equal(o_t[k][v], getattr(o_j, name)[v])
        assert np.abs(o_t[7][v] - o_j.cfo_hz[v]).max() < 0.5
        assert np.abs(o_t[8][v] - o_j.eq_error[v]).max() < 2e-3

    fr = np.ascontiguousarray(frames.transpose(1, 0, 2))
    _, o_j = jrx.prod_rx_stream_pallas(
        cfg, jrx.prod_rx_init(cfg, (3,)), fr, descramble=False,
        block_channels=3, fuse_decode=False, interpret=True)
    st = prod_rx_init(tcfg, (3,), "cpu")
    outs = []
    for part in (fr[:9], fr[9:]):
        st, o = prod_rx_stream_pallas(tcfg, st, torch.from_numpy(part),
                                      descramble=False, fuse_decode=False)
        outs.append(o)
    agree([torch.cat(v) for v in zip(*outs)], o_j)
    if frac_timing:
        return
    _, o_j = jrx.make_prod_rx_fn(cfg, batched=True)(
        jrx.prod_rx_init(cfg, (3,)), frames)
    _, o_t = make_prod_rx_fn(tcfg, batched=True)(
        prod_rx_init(tcfg, (3,), "cpu"), torch.from_numpy(frames))
    agree(o_t, o_j)
    _, o_j = jrx.make_prod_rx_fn(cfg)(jrx.prod_rx_init(cfg), frames[1])
    _, o_t = make_prod_rx_fn(tcfg)(prod_rx_init(tcfg, (), "cpu"),
                                   torch.from_numpy(frames[1]))
    agree(o_t, o_j)


def _wrapper_calls(cfg):
    """Every kernel wrapper with seeded CPU operands of ``cfg``'s shapes
    (N = 2 rows, one block of C = 2 channels): {name: (call, plain)},
    each taking the config to run at; ``plain`` calls the wrapper's plain
    version directly."""
    from singlecarrier_tpu_torch.ops import decode, frontend
    n, halo, cyc = cfg.frame_size, cfg.ntaps - 1, cfg.cycles
    n_sym, pkt = cfg.symbols_per_block, cfg.pkt_window
    wp = -(-(n_sym - 1 + pkt) // 128) * 128
    gen = torch.Generator().manual_seed(7)
    f32 = dict(dtype=torch.float32)

    def rand(*shape):
        return torch.randn(shape, generator=gen, **f32)

    pcm = torch.randint(-16384, 16384, (2, n), generator=gen,
                        dtype=torch.int16)
    ang = torch.rand((2,), generator=gen) * 6.0
    ph_r, ph_i = torch.cos(ang), torch.sin(ang)
    tail_r, tail_i = rand(2, halo) * 0.1, rand(2, halo) * 0.1
    adv = torch.tensor([[1.0], [0.0]])
    planes = rand(cyc, 2, 2, n_sym) * 0.5
    prev = rand(cyc, 2, 2, n_sym) * 0.5
    lag = torch.randint(0, n_sym, (2,), generator=gen, dtype=torch.int32)
    phase = torch.randint(0, cyc, (2,), generator=gen, dtype=torch.int32)
    peak = torch.ones((2,), **f32)
    wins = rand(2, cyc, 2, wp) * 0.5
    pkt_r, pkt_i = rand(2, pkt) * 0.5, rand(2, pkt) * 0.5
    rows = (pcm, ph_r, ph_i, tail_r, tail_i)
    batch = (pcm[None], ph_r, ph_i, tail_r, tail_i, adv)
    ext = (planes, prev, lag, phase, peak)
    return {
        "frontend_decim": (
            lambda c: frontend.frontend_decim(c, *batch),
            lambda c: frontend.frontend_decim_ref(c, *batch)),
        "frontend_decim folded": (
            lambda c: frontend.frontend_decim(c, *batch, mixer_fold=True),
            lambda c: frontend.frontend_decim_folded_ref(c, *batch)),
        "frontend_rows": (
            lambda c: frontend.frontend_rows(c, *rows),
            lambda c: frontend.frontend_rows_ref(c, *rows)),
        "frontend_rows folded": (
            lambda c: frontend.frontend_rows(c, *rows, mixer_fold=True),
            lambda c: frontend.frontend_rows_folded_ref(c, *rows)),
        "frontend_full": (
            lambda c: frontend.frontend_full(c, *rows),
            lambda c: frontend.frontend_full_ref(c, *rows)),
        "hunt": (lambda c: decode.hunt(c, planes, prev),
                 lambda c: decode.hunt_ref(c, planes, prev)),
        "extract_decode": (
            lambda c: decode.extract_decode(c, *ext),
            lambda c: decode.extract_decode_ref(c, *ext)),
        "extract_gate": (
            lambda c: decode.extract_gate(c, *ext),
            lambda c: decode.extract_gate_ref(c, *ext)),
        "fused_decode_extract": (
            lambda c: decode.fused_decode_extract(c, wins, lag, phase, peak),
            lambda c: decode.stat_dict(c, decode.fused_decode_extract_ref(
                c, wins, lag, phase, peak), hunt=False)),
        "fused_decode": (
            lambda c: decode.fused_decode(c, pkt_r, pkt_i, peak),
            lambda c: decode.stat_dict(c, decode.fused_decode_ref(
                c, pkt_r, pkt_i, peak), hunt=False)),
    }


_DECIMATING = ("frontend_decim", "frontend_decim folded", "frontend_rows",
               "frontend_rows folded")
_WRAPPERS = (*_DECIMATING, "frontend_full", "hunt", "extract_decode",
             "extract_gate", "fused_decode_extract", "fused_decode")


def _leaves(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("wrapper,refused", [
    *((w, "corr_segments=3") for w in _WRAPPERS),
])
def test_wrappers_refuse_on_the_cpu_what_the_card_refuses(wrapper, refused):
    """A config outside the kernels' limits (``_build.kernel_limits``)
    raises for CPU tensors too, before the plain version runs, naming the
    limit."""
    knob, value = refused.split("=")
    cfg = TCFG.replace(**{knob: int(value)})
    call, _ = _wrapper_calls(TCFG)[wrapper]
    call(TCFG)                                   # the operands are right
    with pytest.raises(NotImplementedError,
                       match=re.escape("corr_segments in (1, 2, 4, 8, 16)")):
        call(cfg)


@pytest.mark.parametrize("wrapper", _WRAPPERS)
def test_wrappers_run_another_geometry_on_the_cpu(wrapper):
    """A config inside the limits with other compiled-in shapes than the
    reference (``corr_segments=4``: segments of 32 chips) runs every
    wrapper on the CPU, and equals its plain version called directly."""
    cfg = TCFG.replace(corr_segments=4)
    assert _build.kernel_geometry(cfg)
    call, plain = _wrapper_calls(cfg)[wrapper]
    got, want = _leaves(call(cfg)), _leaves(plain(cfg))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors go through the plain versions: no kernel is built or
    launched, and the counters stay at 0."""
    _build.reset_launches()
    cfg = TCFG.replace(decim_dtype="bf16", hunt_dtype="int8")
    rng = np.random.default_rng(1)
    pcm = torch.from_numpy(rng.integers(-16384, 16384, (2, 2, CFG.frame_size),
                                        dtype=np.int16))
    state, out = prod_rx_batch(cfg, prod_rx_init_planes(cfg, 2, "cpu"), pcm,
                               fuse_frontend=True)
    assert out.valid.shape == (2, 2)
    assert out.bits.shape == (2, 2, CFG.bits_per_frame)
    assert out.bits.dtype == torch.uint8
    assert state[4].dtype == torch.bfloat16
    cstate = prod_rx_init(cfg, (2,), "cpu")
    for flags in ({}, {"fuse_hunt": False}, {"fuse_extract": False,
                                             "fuse_hunt": False}):
        _, out = prod_rx_batch(cfg, cstate, pcm, **flags)
        assert out.valid.shape == (2, 2)
    _, out = prod_rx_stream_pallas(cfg, cstate, pcm)
    assert out.bits.shape == (2, 2, CFG.bits_per_frame)
    fold = cfg.replace(mixer_fold=True)
    prod_rx_batch(fold, prod_rx_init_planes(fold, 2, "cpu"), pcm,
                  fuse_frontend=True)
    prod_rx_batch(fold, prod_rx_init_planes(fold, 2, "cpu"), pcm)
    prod_rx_stream_pallas(cfg.replace(frac_timing=True), cstate, pcm)
    _, gout = prod_rx_batch_gated(cfg, prod_rx_gated_init(cfg, 2, "cpu"),
                                  pcm, max_detections=3)
    assert gout["bits"].shape == (3, CFG.bits_per_frame)
    assert set(_build.LAUNCHES) == {
        "frontend_decim", "frontend_rows", "hunt", "extract_decode",
        "decode_extract", "decode_packets", "frontend_decim_folded",
        "frontend_rows_folded", "extract_gate", "frontend_full"}
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert _build._lib is None


def test_helpers_match_jax():
    for C in (1, 7, 64, 192, 8192):
        for cap in (64, 128):
            assert trx._auto_cb(C, cap) == jrx._auto_cb(C, cap)
    d = np.arange(4, dtype=np.float32)[None].repeat(3, 0)
    assert np.array_equal(trx.dibits_to_bits(torch.from_numpy(d)).numpy(),
                          np.asarray(jrx.dibits_to_bits(d)))
