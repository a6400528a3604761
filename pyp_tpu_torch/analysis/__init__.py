"""Particle-table analysis, model fitting, plots, item filters and the
HTML project report (torch port of pyp_tpu/analysis)."""
