"""Inference: the sliding-window engine and the two-stage serve cascade."""
