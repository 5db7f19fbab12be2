"""PyTorch port: state interop, JAX-free imports, unsupported knobs, and
the CPU route of the kernel wrappers."""

import pathlib
import re
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import prod_rx_batch, prod_rx_init_planes
from singlecarrier_tpu_torch.modem import rx_production as trx
from singlecarrier_tpu_torch.ops import _build
from singlecarrier_tpu_torch.ops.fused_rx import fused_rx_block

PKG = pathlib.Path(__file__).resolve().parents[1] / "singlecarrier_tpu_torch"


@pytest.mark.parametrize("decim_dtype", ["bf16", "f32"])
def test_plane_state_round_trip(decim_dtype):
    cfg = CFG.replace(decim_dtype=decim_dtype)
    rng = np.random.default_rng(0)
    planes = [np.asarray(a) for a in jrx.prod_rx_init_planes(cfg, 3)]
    planes = [(rng.normal(size=a.shape)).astype(a.dtype) for a in planes]
    want_dt = ml_dtypes.bfloat16 if decim_dtype == "bf16" else np.float32
    assert planes[4].dtype == want_dt
    st = interop.planes_from_numpy(planes)
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
    mine = interop.planes_to_numpy(prod_rx_init_planes(cfg, 3))
    for a, b in zip(jrx.prod_rx_init_planes(cfg, 3), mine):
        assert np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)


def test_package_imports_without_jax():
    code = ("import sys; import singlecarrier_tpu_torch, "
            "singlecarrier_tpu_torch.modem, singlecarrier_tpu_torch.interop, "
            "singlecarrier_tpu_torch.ops.fused_rx; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_package_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    for f in files:
        assert not pat.search(f.read_text()), f


@pytest.mark.parametrize("knob", [
    {"hunt_norm": "energy"}, {"hunt_norm": "none"}, {"ls_gram": "direct"},
    {"ls_bvec": "matmul"}, {"cfo_dtype": "bf16"},
    {"frontend_dtype": "f32"}, {"mixer_fold": True}, {"hunt_dtype": "f32"},
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_unported_knobs_raise(knob):
    cfg = CFG.replace(**knob)
    state = prod_rx_init_planes(cfg, 2)
    pcm = torch.zeros((1, 2, cfg.frame_size), dtype=torch.int16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prod_rx_batch(cfg, state, pcm, fuse_frontend=True)


def test_unported_paths_raise():
    state = prod_rx_init_planes(CFG, 2)
    pcm = torch.zeros((1, 2, CFG.frame_size), dtype=torch.int16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prod_rx_batch(CFG, state, pcm)                  # two-kernel path
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prod_rx_batch(CFG, state[:4], pcm, fuse_frontend=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_rx_block(CFG, pcm, *state, stage="gate")
    with pytest.raises(ValueError, match="frac_timing"):
        prod_rx_batch(CFG.replace(frac_timing=True), state, pcm,
                      fuse_frontend=True)
    cfg = CFG.replace(eq_length=7)
    with pytest.raises(NotImplementedError, match="numerolog"):
        _build.require_kernel_geometry(cfg)


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors go through the plain versions: no kernel is built or
    launched, and the counters stay at 0."""
    _build.reset_launches()
    cfg = CFG.replace(decim_dtype="bf16", hunt_dtype="int8")
    rng = np.random.default_rng(1)
    pcm = torch.from_numpy(rng.integers(-16384, 16384, (2, 2, CFG.frame_size),
                                        dtype=np.int16))
    state, out = prod_rx_batch(cfg, prod_rx_init_planes(cfg, 2), pcm,
                               fuse_frontend=True)
    assert out.valid.shape == (2, 2)
    assert out.bits.shape == (2, 2, CFG.bits_per_frame)
    assert out.bits.dtype == torch.uint8
    assert state[4].dtype == torch.bfloat16
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert _build._lib is None


def test_helpers_match_jax():
    for C in (1, 7, 64, 192, 8192):
        for cap in (64, 128):
            assert trx._auto_cb(C, cap) == jrx._auto_cb(C, cap)
    d = np.arange(4, dtype=np.float32)[None].repeat(3, 0)
    assert np.array_equal(trx.dibits_to_bits(torch.from_numpy(d)).numpy(),
                          np.asarray(jrx.dibits_to_bits(d)))
