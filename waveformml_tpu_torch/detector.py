"""PROSPECT detector geometry constants (counterpart of waveformml_tpu/detector.py)."""

NX = 14            # detector segments in x
NY = 11            # detector segments in y

MAX_RANGE = 2 ** 14 - 1  # 14-bit ADC full scale

Z_SCALE = 1200.0   # z normalization scale
