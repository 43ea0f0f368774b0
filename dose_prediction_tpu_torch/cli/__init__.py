"""The command line (python -m dose_prediction_tpu_torch)."""
