#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the production RX once on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases:

  1. device   -- name, CUDA version, power limit; exits 1 without CUDA;
  2. build    -- compiles the kernels (``singlecarrier_tpu_torch/csrc``)
                 into ``build/torch_kernels/`` and prints ptxas' register
                 and spill report;
  3. kernels  -- each kernel against its plain PyTorch version on the
                 card (C=256 channels x 4 blocks, golden packets + noise);
  4. main     -- ``prod_rx_batch(fuse_frontend=True)`` at the bench
                 operating point, 8192 channels, two chained dispatches
                 of 10 blocks carrying the state, on the golden stream
                 delayed by 0..1879 samples per channel: every channel
                 must decode its 10 packets (a packet at a block seam
                 may be found twice, as in the JAX package; such repeats
                 are counted); 32 channels are checked
                 against the plain path on the CPU; then one noise-only
                 dispatch counts false detects;
  5. timing   -- chained dispatches of the main path (8192 x 128 blocks),
                 and each kernel against its plain version.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line and, last, ``{"ok": true, "device": {...}}``.  Any failing phase
exits non-zero before the last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

C_CMP, B_CMP = 256, 4          # kernel-vs-plain comparison geometry
C_MAIN, B_MAIN = 8192, 10      # main path: two dispatches of B_MAIN blocks
B_TIME, ITERS = 128, 3         # timed dispatches of C_MAIN x B_TIME
B_KTIME = 4                    # per-kernel timing: C_MAIN x B_KTIME rows
N_REF_CH = 32                  # channels re-run on the CPU plain path
SEED = 1234

KERNELS = {
    "frontend_decim": ("singlecarrier_tpu_torch/csrc/frontend.cu",
                       "singlecarrier_tpu/ops/fused_rx.py:155"),
    "hunt": ("singlecarrier_tpu_torch/csrc/hunt.cu",
             "singlecarrier_tpu/ops/decode_pallas.py:705"),
    "extract_decode": ("singlecarrier_tpu_torch/csrc/decode.cu",
                       "singlecarrier_tpu/ops/decode_pallas.py:398"),
}


class PhaseError(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _ulp(x, dtype):
    """Spacing of ``dtype`` at |x| (floored at the smallest normal)."""
    import torch
    bits = {torch.bfloat16: 8, torch.float32: 24}[dtype]
    _, e = torch.frexp(x.abs().clamp_min(torch.finfo(dtype).tiny))
    return torch.ldexp(torch.ones_like(x), (e - bits).to(torch.int32))


def _time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _golden_stream(torch, tx, C, n_samp, offsets, dev):
    """[C, n_samp] int16: ``tx`` delayed by ``offsets[ch]``, zero elsewhere."""
    stream = torch.zeros((C, n_samp), dtype=torch.int16, device=dev)
    idx = torch.arange(tx.numel(), device=dev)[None] + offsets[:, None]
    stream.scatter_(1, idx, tx[None].expand(C, -1).contiguous())
    return stream


def _frames(stream, B, n):
    """[C, B*n] stream -> [B, C, n] contiguous frames."""
    C = stream.shape[0]
    return stream[:, :B * n].reshape(C, B, n).permute(1, 0, 2).contiguous()


def _decisions_agree(a, b, what: str) -> None:
    """The port's decision-level parity criterion (tools/tpu_parity.py)."""
    import torch
    v = a.valid
    _require(torch.equal(v, b.valid), f"{what}: valid differs "
             f"({int((v != b.valid).sum())} rows)")
    _require(torch.equal(a.bits[v], b.bits[v]), f"{what}: bits differ")
    _require(torch.equal(a.lag[v], b.lag[v]), f"{what}: lag differs")
    _require(torch.equal(a.timing_phase[v], b.timing_phase[v]),
             f"{what}: timing phase differs")
    if bool(v.any()):
        dc = float((a.cfo_hz[v] - b.cfo_hz[v]).abs().max())
        de = float((a.eq_error[v] - b.eq_error[v]).abs().max())
        _require(dc < 0.5 and de < 2e-3,
                 f"{what}: |dcfo| {dc} Hz, |deq_error| {de}")


def _check_packets(torch, outs, tx_bits, cfg) -> int:
    """Every channel decodes each of the 10 transmitted packets once, with
    the transmitted bits except the TX-truncated last 10.

    A preamble that starts within one symbol of a block seam is found by
    both windows that contain it (lag 375 of one, lag 0 of the next), in
    this port as in the JAX package.  Such a repeat -- a detection within
    5 samples of the previous block's, with the same bits -- is counted
    and dropped.  Returns the number of channels with a repeat.
    """
    valid = torch.cat([o.valid for o in outs])               # [2B, C]
    bits = torch.cat([o.bits for o in outs])                 # [2B, C, 496]
    blk = torch.arange(valid.shape[0], device=valid.device)[:, None]
    pos = ((blk * cfg.symbols_per_block + torch.cat([o.lag for o in outs]))
           * cfg.cycles + torch.cat([o.timing_phase for o in outs]))
    rep = torch.zeros_like(valid)
    rep[1:] = valid[1:] & valid[:-1] & (pos[1:] - pos[:-1] <= cfg.cycles)
    same = (bits[1:, :, :-10] == bits[:-1, :, :-10]).all(-1)
    _require(bool((same | ~rep[1:]).all()),
             "a seam repeat decoded different bits")
    kept = valid & ~rep
    per_ch = kept.sum(0)
    C = valid.shape[1]
    _require(bool((per_ch == 10).all()),
             f"packets per channel: min {int(per_ch.min())}, max "
             f"{int(per_ch.max())} (want 10 on all {C})")
    order = torch.sort((~kept).to(torch.int8), dim=0, stable=True).indices
    got = torch.gather(bits, 0, order[:10, :, None].expand(10, C,
                                                           bits.shape[-1]))
    bad = (got[..., :-10] != tx_bits[:, None, :-10]).any(-1).any(0)
    _require(not bool(bad.any()),
             f"payload bits wrong on {int(bad.sum())} channels")
    return int(rep.any(0).sum())


def _kernel_inputs(torch, np, gen, tx, cfg, C, B, dev):
    """Kernel operands for [B, C] rows: golden packets at random delays
    and positions with AWGN of 0..4500 (every 8th channel full-scale
    noise only), a random carried state."""
    n = cfg.frame_size
    off = torch.randint(0, 4 * n, (C,), generator=gen, device=dev)
    stream = _golden_stream(torch, tx, C, B * n + 4 * n + tx.numel(), off,
                            dev)
    start = torch.randint(0, tx.numel(), (C,), generator=gen, device=dev)
    idx = start[:, None] + torch.arange(B * n, device=dev)[None]
    sig = torch.gather(stream, 1, idx).float()
    sigma = (torch.arange(C, device=dev) % 4).float()[:, None] * 1500.0
    noise = torch.randn((C, B * n), generator=gen, device=dev) * sigma
    x = (sig + noise).clamp(-32768, 32767).to(torch.int16)
    pure = torch.randint(-16384, 16384, (C, B * n), generator=gen,
                         device=dev, dtype=torch.int16)
    x = torch.where((torch.arange(C, device=dev) % 8 == 7)[:, None], pure, x)
    ph = torch.rand((C,), generator=gen, device=dev) * (2 * np.pi)
    halo = cfg.ntaps - 1
    t0r = torch.randn((C, halo), generator=gen, device=dev) * 0.1
    t0i = torch.randn((C, halo), generator=gen, device=dev) * 0.1
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    advs = np.exp(1j * w_ * n * np.arange(B)).astype(np.complex64)
    adv = torch.from_numpy(np.stack([advs.real, advs.imag])).to(dev)
    ddt = torch.bfloat16 if cfg.decim_dtype == "bf16" else torch.float32
    dprev0 = (torch.randn((cfg.cycles, 2, C, cfg.symbols_per_block),
                          generator=gen, device=dev) * 0.5).to(ddt)
    return (_frames(x, B, n), torch.cos(ph), torch.sin(ph), t0r, t0i, adv,
            dprev0)


def _compare_kernels(torch, cfg, inputs, what: str) -> dict:
    """Each kernel against its plain version on the same operands; returns
    {name: {"max_abs_err": x}}."""
    from singlecarrier_tpu_torch.ops.decode import (
        extract_decode, extract_decode_ref, hunt, hunt_ref)
    from singlecarrier_tpu_torch.ops.frontend import (
        frontend_decim, frontend_decim_ref)
    D = cfg.frame_symbols
    ddt = torch.bfloat16 if cfg.decim_dtype == "bf16" else torch.float32
    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = inputs
    report = {}
    dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    dr = frontend_decim_ref(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    torch.cuda.synchronize()
    err1 = (dk.float() - dr.float()).abs()
    report["frontend_decim"] = {"max_abs_err": float(err1.max())}
    _require(bool((err1 <= _ulp(dr.float(), ddt)).all()),
             f"{what}: frontend_decim differs from its plain version by "
             f"more than 1 ulp")
    print(f"[kernels] {what}: frontend_decim vs plain: max |err| "
          f"{float(err1.max()):.3e} (tolerance 1 ulp of {cfg.decim_dtype}; "
          f"same f32 sum order), exact share "
          f"{float((err1 == 0).float().mean()):.6f}", flush=True)

    lk, pk_, qk = hunt(cfg, dk, dprev0)
    lr, pr_, qr = hunt_ref(cfg, dk, dprev0)
    torch.cuda.synchronize()
    rel = float(((qk - qr).abs() / qr.abs().clamp_min(1e-30)).max())
    report["hunt"] = {"max_abs_err": float((qk - qr).abs().max())}
    _require(torch.equal(lk, lr) and torch.equal(pk_, pr_),
             f"{what}: hunt lag/phase differ on {int((lk != lr).sum())}/"
             f"{int((pk_ != pr_).sum())} rows")
    _require(rel <= 1e-5, f"{what}: hunt peak rel err {rel}")
    print(f"[kernels] {what}: hunt vs plain: lag/phase identical on "
          f"{lk.numel()} rows, peak max rel err {rel:.3e} (tolerance 1e-5)",
          flush=True)

    ok_ = extract_decode(cfg, dk, dprev0, lk, pk_, qk)
    or_ = extract_decode_ref(cfg, dk, dprev0, lk, pk_, qk)
    torch.cuda.synchronize()
    vk = (ok_[:, D + 3] > 0.5) & (ok_[:, D] > cfg.match_threshold)
    vr = (or_[:, D + 3] > 0.5) & (or_[:, D] > cfg.match_threshold)
    _require(torch.equal(vk, vr), f"{what}: extract_decode valid differs "
             f"on {int((vk != vr).sum())} rows")
    _require(bool(vk.any()), f"{what}: no packet decoded")
    _require(torch.equal(ok_[vk, :D], or_[vr, :D]),
             f"{what}: extract_decode dibits differ on valid rows")
    stat_err = (ok_[vk, D:D + 8] - or_[vr, D:D + 8]).abs()
    dcfo, deq = float(stat_err[:, 2].max()), float(stat_err[:, 1].max())
    _require(dcfo < 0.5 and deq < 2e-3,
             f"{what}: extract_decode |dcfo| {dcfo}, |deq| {deq}")
    report["extract_decode"] = {"max_abs_err": float(stat_err.max())}
    print(f"[kernels] {what}: extract_decode vs plain: valid identical "
          f"({int(vk.sum())}/{vk.numel()} rows valid), descrambled dibits "
          f"identical, |dcfo| {dcfo:.3e} Hz, |deq_error| {deq:.3e}, max "
          f"|err| of the valid rows' stats {float(stat_err.max()):.3e} "
          f"(tolerances 0.5 Hz, 2e-3)", flush=True)
    return report


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from singlecarrier_tpu_torch import DEFAULT_CONFIG
        from singlecarrier_tpu_torch.modem import (prod_rx_batch,
                                                   prod_rx_init_planes)
        from singlecarrier_tpu_torch.ops import _build
        from singlecarrier_tpu_torch.ops.decode import (
            extract_decode, extract_decode_ref, hunt, hunt_ref)
        from singlecarrier_tpu_torch.ops.frontend import (
            frontend_decim, frontend_decim_ref)
        golden = np.load(os.path.join(here, "tests", "golden",
                                      "reference.npz"))
    except (ImportError, OSError) as e:
        print(f"chip_smoke: the repository is incomplete: {e}",
              file=sys.stderr)
        return 1
    # the plain versions' f32 matmuls must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}; "
          f"{smi_line}", flush=True)

    cfg = DEFAULT_CONFIG.replace(decim_dtype="bf16", hunt_dtype="int8",
                                 ls_refit_symbols=128)
    n = cfg.frame_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tx = torch.from_numpy(golden["tx_pcm"].astype(np.int16)).to(dev)
    tx_bits = torch.from_numpy(golden["tx_bits"].reshape(10, -1)).to(dev)

    # ---- 2. build ----
    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    _build.load()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build]   {line.strip()}")

    # ---- 3. kernels vs plain, on the card ----
    def _inputs(cfg_, C, B):
        return _kernel_inputs(torch, np, gen, tx, cfg_, C, B, dev)

    default = DEFAULT_CONFIG
    _compare_kernels(torch, default, _inputs(default, C_CMP, B_CMP),
                     "library default")
    report = _compare_kernels(torch, cfg, _inputs(cfg, C_CMP, B_CMP),
                              "bench operating point")

    # ---- 4. main path ----
    offsets = torch.arange(C_MAIN, device=dev) % n
    stream = _golden_stream(torch, tx, C_MAIN, 2 * B_MAIN * n, offsets, dev)
    frames = _frames(stream, 2 * B_MAIN, n)
    state = prod_rx_init_planes(cfg, C_MAIN, dev)
    _build.reset_launches()
    outs = []
    for part in (frames[:B_MAIN], frames[B_MAIN:]):
        state, out = prod_rx_batch(cfg, state, part, descramble=False,
                                   fuse_frontend=True)
        outs.append(out)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[main] launches in the main path: {launches}", flush=True)
    _require(all(v > 0 for v in launches.values()),
             f"a kernel of the path was never launched: {launches}")
    for o in outs:
        _require(bool(torch.isfinite(o.eq_error).all()
                      and torch.isfinite(o.cfo_hz).all()
                      and torch.isfinite(o.peak).all()),
                 "non-finite outputs")
    n_dup = _check_packets(torch, outs, tx_bits, cfg)
    print(f"[main] {C_MAIN} channels x 2 dispatches x {B_MAIN} blocks: "
          f"10/10 packets on every channel, bits exact except the "
          f"TX-truncated last 10 of each packet; {n_dup} channels also "
          f"detect one packet twice across a block seam (the JAX "
          f"package's behaviour at those offsets)", flush=True)

    ref_state = prod_rx_init_planes(cfg, N_REF_CH)
    for k, part in enumerate((frames[:B_MAIN], frames[B_MAIN:])):
        ref_state, ref = prod_rx_batch(
            cfg, ref_state, part[:, :N_REF_CH].cpu(), descramble=False,
            fuse_frontend=True)
        sub = type(outs[k])(*(x[:, :N_REF_CH].cpu() for x in outs[k]))
        _decisions_agree(sub, ref, f"main path vs CPU plain, dispatch {k}")
    print(f"[main] first {N_REF_CH} channels agree with the CPU plain "
          f"path (valid, bits, lag, phase; |dcfo| < 0.5 Hz, |deq| < 2e-3)",
          flush=True)
    del frames, stream, outs

    noise = torch.randint(-16384, 16384, (B_TIME, C_MAIN, n), generator=gen,
                          device=dev, dtype=torch.int16)
    state = prod_rx_init_planes(cfg, C_MAIN, dev)
    state, out = prod_rx_batch(cfg, state, noise, fuse_frontend=True)
    fa = int(out.valid.sum())
    print(f"[main] noise-only dispatch {C_MAIN} x {B_TIME}: {fa} false "
          f"detects in {C_MAIN * B_TIME} blocks", flush=True)
    del out

    # ---- 5. timing ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, out = prod_rx_batch(cfg, state, noise, fuse_frontend=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = ITERS * B_TIME * C_MAIN * n / wall
    print(f"[timing] main path {C_MAIN} ch x {B_TIME} blocks x {ITERS} "
          f"chained dispatches: {wall:.3f} s, {rate:.4e} samples/s = "
          f"{rate / cfg.fs:.1f} real-time channels; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
          f"{smi_line}", flush=True)
    del out, noise, state

    pcm, p0r, p0i, t0r, t0i, adv, dprev0 = _inputs(cfg, C_MAIN, B_KTIME)
    dk = frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv)
    lk, pk_, qk = hunt(cfg, dk, dprev0)
    calls = {
        "frontend_decim": (
            lambda: frontend_decim(cfg, pcm, p0r, p0i, t0r, t0i, adv),
            lambda: frontend_decim_ref(cfg, pcm, p0r, p0i, t0r, t0i, adv)),
        "hunt": (lambda: hunt(cfg, dk, dprev0),
                 lambda: hunt_ref(cfg, dk, dprev0)),
        "extract_decode": (
            lambda: extract_decode(cfg, dk, dprev0, lk, pk_, qk),
            lambda: extract_decode_ref(cfg, dk, dprev0, lk, pk_, qk)),
    }
    for name, (kern, plain) in calls.items():
        report[name]["ms"] = _time_cuda(kern, 10)
        report[name]["plain_ms"] = _time_cuda(plain, 3)
        print(f"[timing] {name} at {C_MAIN} ch x {B_KTIME} blocks: kernel "
              f"{report[name]['ms']:.3f} ms, plain "
              f"{report[name]['plain_ms']:.3f} ms; {smi_line}", flush=True)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"],
                "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(2)
