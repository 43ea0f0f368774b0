"""Run-time configuration of the port."""
