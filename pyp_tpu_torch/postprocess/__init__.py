"""Map postprocessing (torch port of pyp_tpu/postprocess)."""
