"""PROSPECT detector geometry constants (counterpart of waveformml_tpu/detector.py)."""

NX = 14            # detector segments in x
NY = 11            # detector segments in y

MAX_RANGE = 2 ** 14 - 1  # 14-bit ADC full scale

Z_SCALE = 1200.0   # z normalization scale
E_SCALE = 12.0     # energy normalization scale

#: the z scale of a Z model's output: a served z in [0, 1] is
#: (z - 0.5) · Z_NORMALIZATION_FACTOR in mm (waveformml_tpu/evaluation/ad1.py:23)
Z_NORMALIZATION_FACTOR = 1200.0
