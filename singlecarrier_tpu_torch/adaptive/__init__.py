"""Equalizers of the port (counterpart of ``singlecarrier_tpu.adaptive``):
the square-root Kalman and its equalizer steps (the faithful path), the
blocked RLS (``blocked_rls``) and the batch LS equalizer
(``ls_equalizer``, the production path)."""

from .equalizer import (EqState, data_step, data_step_coherent,
                        data_step_nlms, eq_init, train_step)
from .kalman import KalmanState, kalman_init, kalman_update

__all__ = ["KalmanState", "kalman_init", "kalman_update", "EqState",
           "eq_init", "train_step", "data_step", "data_step_coherent",
           "data_step_nlms"]
