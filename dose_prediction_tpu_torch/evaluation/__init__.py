"""Evaluation helpers used on the serve path."""
