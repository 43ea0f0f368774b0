"""Evaluation: the OpenKBP metrics (host and device halves), seg metrics and plots."""
