"""Small numerical helpers of the port (counterpart of
``singlecarrier_tpu.utils``)."""
