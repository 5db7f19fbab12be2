"""Equalizers of the port (counterpart of ``singlecarrier_tpu.adaptive``)."""
