"""Host-side helpers (counterpart of waveformml_tpu/utils)."""
