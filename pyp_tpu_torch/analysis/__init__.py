"""Particle-table analysis, model fitting and plots (torch port of
pyp_tpu/analysis)."""
