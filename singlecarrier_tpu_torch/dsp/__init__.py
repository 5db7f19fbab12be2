"""DSP helpers of the port (counterparts of ``singlecarrier_tpu.dsp``)."""
