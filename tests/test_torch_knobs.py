"""PyTorch port: the seven configuration values its kernels take as
template parameters -- ``hunt_norm`` "energy" and "none",
``hunt_dtype="f32"``, ``ls_gram="direct"``, ``ls_bvec="matmul"``,
``cfo_dtype="bf16"`` and ``frontend_dtype="f32"`` -- on the CPU, where
every wrapper runs its plain version, against the JAX package.

* The one-kernel path ``prod_rx_batch(fuse_frontend=True)`` under each
  knob against JAX's in interpret mode, on one numpy-seeded stream (four
  channels of three scrambled packets of the JAX TX at distinct delays,
  AWGN of sigma 1500), held to the North star's criterion: identical
  valid, bits on valid blocks, lag and phase on detected blocks, equal
  matches, |dcfo| < 0.5 Hz, |deq_error| < 2e-3; the carried phase and
  tail within 1e-6, the carried decim planes within 2e-5 (f32).
* Each module that holds a kernel: the front-end planes with f32
  operands (premix into bf16 planes within one bf16 ulp, folded into f32
  planes within 2e-5, the 49-term sums reassociated); the hunt under
  each hunt knob (identical lag and phase on detected rows, the peak to
  1e-5 relative, and the decode's decisions); ``fused_decode`` under the
  three decode knobs at once (decisions identical, |dcfo| < 0.5 Hz,
  |deq_error| < 2e-3).
* The XLA path's ``hunt_norm`` energy and none against JAX's
  ``prod_rx_stream``, and ``_hunt_metric`` itself.
* Order models, numpy and torch only: the direct Gram against JAX's and
  against the sliding one, the matmul b-vector against JAX's band
  product, against the reduce form and, bit for bit, against the
  kernel's lane loop; the bf16 CFO operands' exact products; the f32
  front-end's unfused tap order.

Thirteen JAX calls run in interpret mode (each lowers and compiles its
Pallas kernels anew, some seconds on a CPU).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import rx_production as jrx
from singlecarrier_tpu.modem import tx_stream
from singlecarrier_tpu.ops import decode_pallas as jdec
from singlecarrier_tpu.ops.frontend_pallas import fused_frontend_decim
from singlecarrier_tpu_torch import interop
from singlecarrier_tpu_torch.modem import (prod_rx_batch, prod_rx_init,
                                           prod_rx_stream)
from singlecarrier_tpu_torch.modem import rx_production as trx
from singlecarrier_tpu_torch.ops import decode, frontend

KNOBS = [{"hunt_norm": "energy"}, {"hunt_norm": "none"},
         {"hunt_dtype": "f32"}, {"ls_gram": "direct"},
         {"ls_bvec": "matmul"}, {"cfo_dtype": "bf16"},
         {"frontend_dtype": "f32"}]
HUNT_KNOBS = KNOBS[:3]
DECODE_KNOBS = {"cfo_dtype": "bf16", "ls_gram": "direct",
                "ls_bvec": "matmul"}
C = 4


def _id(knob):
    return "-".join(f"{k}={v}" for k, v in knob.items())


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _stream(seed=31):
    """[nb, C, n] int16 frames: three scrambled random-payload packets of
    the JAX TX on each of C channels at distinct delays, AWGN of sigma
    1500 (the TX amplitude is 16384)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True,
                               scramble=True)).astype(np.float64)
    n = CFG.frame_size
    nb = -(-(len(pcm) + n) // n)
    x = np.zeros((C, nb * n))
    for c in range(C):
        d = int(rng.integers(0, n))
        x[c, d:d + len(pcm)] = pcm[:nb * n - d]
    x += rng.normal(0, 1500.0, x.shape)
    x = np.clip(x, -32768, 32767).astype(np.int16)
    return np.ascontiguousarray(x.reshape(C, nb, n).transpose(1, 0, 2))


def _assert_parity(o_t, o_j, min_valid=6):
    v = np.asarray(o_j.valid)
    assert v.sum() >= min_valid
    assert np.array_equal(o_t.valid.numpy(), v)
    for name in ("bits", "lag", "timing_phase", "matches"):
        assert np.array_equal(getattr(o_t, name).numpy()[v],
                              np.asarray(getattr(o_j, name))[v]), name
    assert np.abs(o_t.cfo_hz.numpy()[v]
                  - np.asarray(o_j.cfo_hz)[v]).max() < 0.5
    assert np.abs(o_t.eq_error.numpy()[v]
                  - np.asarray(o_j.eq_error)[v]).max() < 2e-3


def _ulp_bf16(x):
    """One bf16 ulp of each value of f32 array ``x``."""
    _, e = np.frexp(np.maximum(np.abs(x), 1e-30))
    return np.ldexp(1.0, e - 8)


# --------------------------------------------- the one-kernel path


@pytest.mark.parametrize("knob", KNOBS, ids=_id)
def test_one_kernel_path_matches_jax(knob):
    cfg = CFG.replace(**knob)
    frames = _stream()
    st_j = jrx.prod_rx_init_planes(cfg, C)
    st_t = interop.planes_from_numpy([np.asarray(a) for a in st_j],
                                     device="cpu")
    st_j, o_j = jrx.prod_rx_batch(cfg, st_j, jnp.asarray(frames),
                                  block_channels=C, decode_block_channels=C,
                                  fuse_frontend=True, interpret=True)
    st_t, o_t = prod_rx_batch(_tcfg(cfg), st_t, torch.from_numpy(frames),
                              fuse_frontend=True)
    _assert_parity(o_t, jax.tree.map(np.asarray, o_j))
    for a, b in zip(st_j[:4], st_t[:4]):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
    assert np.abs(np.asarray(st_j[4]) - st_t[4].numpy()).max() < 2e-5


# ------------------------------------------ the modules with a kernel


@pytest.mark.parametrize("fold", [False, True], ids=["premix", "folded"])
def test_f32_front_end_planes_match_jax(fold):
    """``frontend_rows`` (the kernel of ``fused_frontend_decim``) with f32
    operands: premix into bf16 planes, folded into f32 planes."""
    cfg = CFG.replace(frontend_dtype="f32",
                      decim_dtype="f32" if fold else "bf16")
    frames = _stream()
    n, halo = cfg.frame_size, cfg.ntaps - 1
    N = frames.shape[0] * C
    pcm = frames.reshape(N, n)
    rng = np.random.default_rng(7)
    ph = rng.uniform(0, 2 * np.pi, N)
    ph_r, ph_i = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
    tail = (rng.normal(0, 0.3, (2, N, halo))).astype(np.float32)
    want = fused_frontend_decim(cfg, jnp.asarray(pcm), jnp.asarray(ph_r),
                                jnp.asarray(ph_i), jnp.asarray(tail[0]),
                                jnp.asarray(tail[1]), transposed=True,
                                mixer_fold=fold, interpret=True)
    got = frontend.fused_frontend_decim(
        _tcfg(cfg), torch.from_numpy(pcm), torch.from_numpy(ph_r),
        torch.from_numpy(ph_i), torch.from_numpy(tail[0]),
        torch.from_numpy(tail[1]), transposed=True, mixer_fold=fold)
    wp = np.asarray(want[0].astype(jnp.float32))
    gp = got[0].float().numpy()
    assert got[0].dtype == (torch.float32 if fold else torch.bfloat16)
    assert np.abs(wp).max() > 0.5
    if fold:
        assert np.abs(gp - wp).max() < 2e-5
    else:
        assert np.all(np.abs(gp - wp) <= _ulp_bf16(wp))
    for a, b in zip(want[1:], got[1:]):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6


@functools.lru_cache(maxsize=None)
def _planes(decim_dtype="f32"):
    """(dprev0, dcur) numpy decim planes [cyc, 2, rows, n_sym] of the
    stream, by the port's plain front-end: block 0 is the carried
    state, the rest the batch."""
    cfg = _tcfg(CFG.replace(decim_dtype=decim_dtype))
    frames = torch.from_numpy(_stream())
    st = trx.prod_rx_init_planes(cfg, C, "cpu")
    B = frames.shape[0]
    adv = trx._advances(cfg, B, torch.device("cpu"))[1]
    dec = frontend.frontend_decim(cfg, frames, *st[:4], adv)
    dec = dec.float().numpy()
    return dec[:, :, :C].copy(), dec[:, :, C:].copy()


@pytest.mark.parametrize("knob", HUNT_KNOBS, ids=_id)
def test_hunt_matches_jax(knob):
    """The hunt (and the decode at its lag and phase) under each hunt
    knob against ``fused_hunt_decode_decim`` in interpret mode."""
    cfg = CFG.replace(**knob)
    dprev0, dcur = _planes()
    want = jax.tree.map(np.asarray, jdec.fused_hunt_decode_decim(
        cfg, jnp.asarray(dprev0), jnp.asarray(dcur), channels=C,
        block_channels=C, interpret=True))
    tcfg = _tcfg(cfg)
    tp, tc = torch.from_numpy(dprev0), torch.from_numpy(dcur)
    lag, ph, peak = decode.hunt(tcfg, tc, tp)
    out = decode.extract_decode(tcfg, tc, tp, lag, ph, peak).numpy()
    D = cfg.frame_symbols
    v = want["gated"] & (want["matches"] > cfg.match_threshold)
    assert v.sum() >= 6
    assert np.array_equal((out[:, D + 3] > 0.5)
                          & (out[:, D] > cfg.match_threshold), v)
    assert np.array_equal(lag.numpy()[v], want["lag"][v])
    assert np.array_equal(ph.numpy()[v], want["phase_idx"][v])
    assert np.allclose(peak.numpy()[v], want["peak"][v], rtol=1e-5)
    assert np.array_equal(out[v, :D], want["dibits"][v])
    assert np.abs(out[v, D + 2] - want["cfo_hz"][v]).max() < 0.5
    assert np.abs(out[v, D + 1] - want["eq_error"][v]).max() < 2e-3


def test_fused_decode_matches_jax_under_the_decode_knobs():
    """``fused_decode`` with ``cfo_dtype="bf16"``, ``ls_gram="direct"``
    and ``ls_bvec="matmul"`` together, on packets the plain hunt found."""
    cfg = CFG.replace(**DECODE_KNOBS)
    tcfg = _tcfg(cfg)
    dprev0, dcur = _planes()
    wins = decode._windows(tcfg, torch.from_numpy(dcur),
                           torch.from_numpy(dprev0))
    lag, ph, peak = decode.hunt(tcfg, torch.from_numpy(dcur),
                                torch.from_numpy(dprev0))
    pkt = decode._extract_from_planes(tcfg, torch.from_numpy(dcur),
                                      torch.from_numpy(dprev0), lag, ph)
    assert wins.shape[-1] == 768
    pr, pi = pkt[:, 0].contiguous(), pkt[:, 1].contiguous()
    want = jax.tree.map(np.asarray, jdec.fused_decode(
        cfg, jnp.asarray(pr.numpy()), jnp.asarray(pi.numpy()),
        jnp.asarray(peak.numpy()), block_channels=pr.shape[0],
        interpret=True))
    got = {k: t.numpy() for k, t in
           decode.fused_decode(tcfg, pr, pi, peak).items()}
    v = want["gated"] & (want["matches"] > cfg.match_threshold)
    assert v.sum() >= 6
    assert np.array_equal(
        got["gated"] & (got["matches"] > cfg.match_threshold), v)
    assert np.array_equal(got["dibits"][v], want["dibits"][v])
    assert np.array_equal(got["matches"][v], want["matches"][v])
    assert np.abs(got["cfo_hz"][v] - want["cfo_hz"][v]).max() < 0.5
    assert np.abs(got["eq_error"][v] - want["eq_error"][v]).max() < 2e-3


# ------------------------------------------------------ the XLA path


@pytest.mark.parametrize("norm", ["energy", "none"])
def test_xla_path_hunt_norm_matches_jax(norm):
    """``prod_rx_stream`` on [B, C] blocks against JAX's, mapped over the
    channels (``make_prod_rx_fn(batched=True)``, [C, B] out)."""
    cfg = CFG.replace(hunt_norm=norm)
    frames = _stream()
    _, o_j = jrx.make_prod_rx_fn(cfg, batched=True)(
        jrx.prod_rx_init(cfg, (C,)), jnp.asarray(frames.transpose(1, 0, 2)))
    _, o_t = prod_rx_stream(_tcfg(cfg), prod_rx_init(_tcfg(cfg), (C,), "cpu"),
                            torch.from_numpy(frames))
    _assert_parity(type(o_t)(*(t.transpose(0, 1) for t in o_t)),
                   jax.tree.map(np.asarray, o_j))


@pytest.mark.parametrize("norm", ["espan", "energy", "none"])
def test_hunt_metric_matches_jax(norm):
    cfg = CFG.replace(hunt_norm=norm)
    rng = np.random.default_rng(3)
    n_lags, p = cfg.symbols_per_block, cfg.preamble_length
    power = rng.uniform(0, 50, (3, cfg.cycles, n_lags)).astype(np.float32)
    sq = rng.uniform(0, 2, (3, cfg.cycles, n_lags + p - 1)).astype(
        np.float32)
    want = np.asarray(jrx._hunt_metric(cfg, jnp.asarray(power),
                                       jnp.asarray(sq)))
    got = trx._hunt_metric(_tcfg(cfg), torch.from_numpy(power),
                           torch.from_numpy(sq)).numpy()
    assert got.shape == want.shape == power.shape
    assert np.allclose(got, want, rtol=1e-6, atol=0)
    if norm == "none":
        assert np.array_equal(got, power)


# --------------------------------------------------------- order models


def _windows(rows=6, count=128, L=5, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, count + L - 1)).astype(np.float32),
            rng.normal(size=(rows, count + L - 1)).astype(np.float32))


@pytest.mark.parametrize("count", [128, 248])
def test_direct_gram_matches_jax_and_the_sliding_gram(count):
    """``_gram_direct`` equals JAX's to the reassociation of its sums,
    and the sliding Gram to the same tolerance (``config.ls_gram``: the
    same terms summed in another order)."""
    L = 5
    pr, pi = _windows(count=count, L=L)
    sl = [jnp.asarray(pr[:, i:i + count]) for i in range(L)]
    sli = [jnp.asarray(pi[:, i:i + count]) for i in range(L)]
    A_j = jdec._gram_direct(jnp.asarray(pr), jnp.asarray(pi), sl, sli, L,
                            count)
    A_t = decode._gram_direct(torch.from_numpy(pr), torch.from_numpy(pi), L,
                              count)
    A_s = decode._gram_sliding(torch.from_numpy(pr), torch.from_numpy(pi),
                               L, count)
    assert A_j[0].keys() == A_t[0].keys()
    for dj, dt, ds in zip(A_j, A_t, A_s):
        for k in dj:
            scale = float(np.abs(np.asarray(A_j[0][(k[0], k[0])])).max())
            assert np.abs(np.asarray(dj[k]) - dt[k].numpy()).max() \
                <= 1e-5 * scale
            assert np.abs(ds[k].numpy() - dt[k].numpy()).max() \
                <= 1e-5 * scale
    for i in range(L):                    # the diagonal's imaginary part
        assert not bool(A_t[1][(i, i)].any())


def _lane_bvec(pr, pi, pn, L):
    """The matmul b-vector as the decode kernel's lanes form it: lane i
    sums w_r[i + k] pn[k], lane L + i sums (-w_i[i + k]) pn[k], each in
    ascending k from 0 in f32."""
    rows, P = pr.shape[0], pn.shape[0]
    out = np.zeros((2, L, rows), np.float32)
    for lane in range(2 * L):
        i, w = (lane, pr) if lane < L else (lane - L, -pi)
        acc = np.zeros(rows, np.float32)
        for k in range(P):
            acc = acc + w[:, i + k] * pn[k]
        out[lane // L, i] = acc
    return out


def test_matmul_bvec_is_the_kernels_lane_sums_and_jax_band_product():
    """``_pn_bvec`` equals the kernel's lane loop to the bit, JAX's band
    matmul (``_pn_bvec_band``) and the reduce b-vector to the
    reassociation of the same 128 products."""
    L, P = 5, 128
    pr, pi = _windows(count=P, L=L, seed=9)
    pn = np.asarray(decode.PREAMBLE_VALUES, np.float32)
    b_r, b_i = decode._pn_bvec(torch.from_numpy(pr), torch.from_numpy(pi),
                               torch.from_numpy(pn)[None], L)
    got = np.stack([torch.cat(b_r, 1).numpy().T, torch.cat(b_i, 1).numpy().T])
    assert np.array_equal(got, _lane_bvec(pr, pi, pn, L))
    kb = 256
    band = jdec._pn_bvec_band(P, L, kb)
    wr = np.zeros((pr.shape[0], kb), np.float32)
    wi = np.zeros_like(wr)
    wr[:, :P + L - 1], wi[:, :P + L - 1] = pr, pi
    want_r = np.asarray(jnp.dot(jnp.asarray(wr), band))[:, :L].T
    want_i = np.asarray(jnp.dot(-jnp.asarray(wi), band))[:, :L].T
    reduce_r = np.stack([(pr[:, i:i + P] * pn).sum(-1) for i in range(L)])
    reduce_i = np.stack([(-pi[:, i:i + P] * pn).sum(-1) for i in range(L)])
    for a in (np.stack([want_r, want_i]), np.stack([reduce_r, reduce_i])):
        assert np.abs(got - a).max() <= 1e-5 * np.abs(a).max()


def test_bf16_cfo_operands_make_exact_products():
    """Under ``cfo_dtype="bf16"`` the DFT table is JAX's to the bit, and
    every product of a bf16 chip operand with a table entry is exact in
    f32: the kernel's sums of those products in the f32 DFT's order are
    the plain version's sums of the same numbers."""
    cfg = CFG.replace(cfo_dtype="bf16")
    wr, wi = decode._dft_table(_tcfg(cfg))
    jr, ji = jdec._dft_operands(cfg)
    assert np.array_equal(wr.numpy(), np.asarray(jr[0], np.float32))
    assert np.array_equal(wi.numpy(), np.asarray(ji[0], np.float32))
    assert not np.array_equal(wr.numpy(),
                              decode._dft_table(_tcfg(CFG))[0].numpy())
    rng = np.random.default_rng(4)
    chips = torch.from_numpy(rng.normal(0, 1.0, (64, cfg.preamble_length))
                             .astype(np.float32))
    t = chips.to(torch.bfloat16).float().numpy()
    for table in (wr.numpy(), wi.numpy()):
        prod32 = t[:, :, None] * table[None]
        prod64 = (t.astype(np.float64)[:, :, None]
                  * table.astype(np.float64)[None])
        assert np.array_equal(prod32.astype(np.float64), prod64)


def test_f32_front_end_sums_stay_unfused():
    """With f32 operands the decimating kernels take each tap product and
    sum on their own (``tap_sums<false>``): that order is the plain
    version's to the bit, and a fused multiply-add would not be."""
    cfg = _tcfg(CFG.replace(frontend_dtype="f32"))
    w = frontend.decim_taps(cfg).numpy()
    assert not np.array_equal(
        w, frontend.decim_taps(_tcfg(CFG)).numpy())   # unrounded taps
    rng = np.random.default_rng(5)
    u = rng.uniform(-2, 2, (512, cfg.ntaps)).astype(np.float32)
    plain = np.zeros(512, np.float32)
    fused = np.zeros(512, np.float32)
    for k in range(cfg.ntaps):
        plain = plain + w[k] * u[:, k]
        fused = (np.float64(w[k]) * u[:, k].astype(np.float64)
                 + fused.astype(np.float64)).astype(np.float32)
    want = frontend._tap_sums(cfg, torch.from_numpy(
        np.concatenate([u, np.zeros((512, cfg.frame_size - 1),
                                    np.float32)], 1)))[:, 0].numpy()
    assert np.array_equal(plain, want)
    assert int((fused != plain).sum()) > 50
