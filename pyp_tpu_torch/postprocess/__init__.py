"""Map postprocessing (torch port of pyp_tpu/postprocess): masks, the
mask-corrected FSC, sharpening and local resolution."""
