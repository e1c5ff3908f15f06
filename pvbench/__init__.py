"""pvbench: the benchmark of phase_vocoder_tpu_torch (see run.py)."""
