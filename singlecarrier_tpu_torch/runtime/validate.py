"""Shape/dtype assertion layer + finiteness checks of a step's outputs.

Counterpart of ``singlecarrier_tpu/runtime/validate.py``.  The
reference has no sanitizers and carries a real out-of-bounds write
(``decimated_frame[562]`` written at indices up to 751, reference:
src/qpsk.c:42 vs 157-162) that ASan would have caught (SURVEY.md quirk
#1).  The functional design removes whole classes of such faults, and
this module covers what remains:

 * ``assert_rx_state`` / ``assert_pcm_block`` -- host-side structural
   checks of the demod state and of input blocks at API boundaries (the
   JAX package's chex asserts, as plain checks): a wrong shape or dtype
   raises ``AssertionError`` naming the leaf instead of surfacing as a
   broadcast or a silent float path deep inside the step.
 * ``checkify_step`` -- wraps a ``(state, pcm) -> (state, out)`` step
   with a finiteness check of every floating and complex leaf it
   RETURNS: a NaN/Inf escaping into the carried state or the outputs
   raises, naming the leaf.  One host sync per step; a debug tool --
   production uses runtime/failover.health_check.
"""

from __future__ import annotations

import torch

from ..config import ModemConfig
from ..modem.rx_production import ProdRxState


def _dtype_name(x) -> str:
    """``complex64``, ``int16``, ... for a tensor or an array."""
    return str(x.dtype).removeprefix("torch.")


def _check_leaf(name: str, x, dtype: str, shape: tuple) -> None:
    if _dtype_name(x) != dtype:
        raise AssertionError(f"{name}: dtype {_dtype_name(x)}, expected "
                             f"{dtype}")
    if tuple(x.shape) != shape:
        raise AssertionError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{shape}")


def assert_rx_state(cfg: ModemConfig, state: ProdRxState,
                    n_channels: int | None = None) -> None:
    """Validate a (possibly channel-batched) ProdRxState structurally.

    Raises AssertionError naming the offending leaf on any mismatch.
    """
    batch = (n_channels,) if n_channels is not None else ()
    _check_leaf("phase", state.phase, "complex64", batch)
    _check_leaf("fir_tail", state.fir_tail, "complex64",
                (*batch, cfg.ntaps - 1))
    _check_leaf("decim_prev", state.decim_prev, "complex64",
                (*batch, cfg.cycles, cfg.symbols_per_block))


def assert_pcm_block(cfg: ModemConfig, pcm, n_channels: int) -> None:
    """Validate one [n_channels, frame_size] int16 input block (a numpy
    array or a tensor)."""
    if tuple(pcm.shape) != (n_channels, cfg.frame_size):
        raise AssertionError(f"pcm block: shape {tuple(pcm.shape)}, "
                             f"expected {(n_channels, cfg.frame_size)}")
    if _dtype_name(pcm) != "int16":
        raise AssertionError(
            f"pcm block must be int16 (got {_dtype_name(pcm)}): a float "
            "block takes another path through the step's arithmetic and "
            "hides a caller's scaling bug")


def _leaves(tree, path: str = ""):
    """(path, tensor) for every tensor leaf of nested tuples, NamedTuples
    and dicts; the path as JAX's ``keystr`` writes it (``[0].phase``)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, x in zip(tree._fields, tree):
            yield from _leaves(x, f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k, x in tree.items():
            yield from _leaves(x, f"{path}[{k!r}]")


def checkify_step(step_fn):
    """Wrap a step in per-output-leaf finiteness checks (debug tool).

    Returns ``checked(state, pcm) -> (state, out)`` that RAISES
    ``FloatingPointError`` naming the first returned leaf containing
    NaN/Inf.  The flags of all leaves come to the host at once.
    Example::

        step = checkify_step(lambda st, pcm: prod_rx_frame(cfg, st, pcm))
        state, out = step(state, pcm)   # raises on non-finite output
    """
    def run(state, pcm):
        result = step_fn(state, pcm)
        checked = [(path, x) for path, x in _leaves(result)
                   if x.is_floating_point() or x.is_complex()]
        if checked:
            finite = torch.stack([torch.isfinite(x).all()
                                  for _, x in checked]).cpu().numpy()
            for (path, _), ok in zip(checked, finite):
                if not ok:
                    raise FloatingPointError(
                        f"non-finite value in step output leaf {path}")
        return result

    return run
