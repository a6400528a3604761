"""Command-line entry point of the port: the `refine` mode on a CUDA device.

    python -m pyp_tpu_torch.cli refine -refine_engine gather -refine_maxiter 3 ...

Reads stack.mrc, stack.cistem and initial_model.mrc (or -model_path) from
the project directory, like `pyp_tpu refine`, and runs the gather-engine
refinement loop; parameters persist in the same project file
(.pyp_tpu_config.toml), read through pyp_tpu.cli._project_params. Every
other mode, SLURM submission and ab initio are not ported yet and exit
non-zero.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from pyp_tpu.cli import MODES, _project_params
from pyp_tpu.utils import get_logger

logger = get_logger("cli")


def mode_refine(argv, device="cuda"):
    params = _project_params(argv)
    from pyp_tpu.io import cistem, mrc
    from pyp_tpu.sched import bridge
    from pyp_tpu_torch.pipeline import refine as ref_pipe

    if bridge.slurm_requested(params):
        logger.error("SLURM submission of refine is not yet ported")
        return 2
    stack = mrc.read("stack.mrc").astype(np.float32)
    table = cistem.read_parameters("stack.cistem")
    n = stack.shape[-1]
    model_path = Path(params.get("model_path") or "initial_model.mrc")
    init_path = model_path if model_path.exists() else Path("initial_model.mrc")
    if init_path.exists():
        initial = mrc.read(init_path).astype(np.float32)
    elif params.get("refine_abinit") and not params.get("abinit_skip"):
        logger.error("ab initio (refine_abinit) is not yet ported; supply "
                     "initial_model.mrc")
        return 2
    else:
        # featureless sphere initial model (the reference's fallback)
        from pyp_tpu_torch.core.filters import soft_spherical_mask

        initial = soft_spherical_mask(n, n * 0.3, 5.0).numpy()
    dataset = params.get("data_set") or "dataset"
    table, final, history = ref_pipe.refine_loop(
        stack, table, initial, params, dataset=dataset, device=device)
    print(json.dumps({"iterations": history}, default=str))
    return 0


def main(argv=None, device="cuda"):
    """Entry point: `main(["refine", ...], device=...)`. Returns the exit
    code; modes other than refine are not yet ported."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    mode, rest = argv[0], argv[1:]
    if mode == "refine":
        return mode_refine(rest, device=device)
    if mode in MODES:
        logger.error("mode %r is not yet ported to pyp_tpu_torch", mode)
    else:
        logger.error("unknown mode %r", mode)
    return 2


if __name__ == "__main__":
    sys.exit(main())
