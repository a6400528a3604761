"""Command-line entry point of the port: the `refine` mode on a CUDA device.

    python -m pyp_tpu_torch.cli refine -refine_maxiter 4 -refine_goldstandard ...

Reads stack.mrc, stack.cistem and initial_model.mrc (or -model_path) from
the project directory, like `pyp_tpu refine`, and runs the refinement loop
with the engine the parameters name (`-refine_engine frm`, the default, or
`gather`); parameters persist in the same project file
(.pyp_tpu_config.toml, written and read by `config.params` in the same
format as the JAX package's). Every other mode, SLURM submission and ab
initio are not ported yet and exit non-zero.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

from pyp_tpu_torch.config import params as cfg
from pyp_tpu_torch.config.blocks import apply_reference_aliases
from pyp_tpu_torch.utils import get_logger

logger = get_logger("cli")

# the JAX package's modes; only `refine` is ported
MODES = ("spr", "tomo", "extract", "refine", "classify2d", "classify3d",
         "csp", "polish", "postprocess", "import_star", "export_star",
         "clean", "worker", "params", "gain", "stream", "kselection",
         "byp", "mine", "mask", "tomoedit", "boxedit", "sprtrain",
         "tomotrain", "heterogeneity", "sva", "export_session", "filter",
         "prism", "workflow", "report", "fsc")


def _project_params(argv, work_dir=".", persist=True):
    """The run's parameters: the project file's (a nextPYP
    `.pyp_config.toml` seeds it on a first run), updated with the flags
    given in `argv` and saved back, with reference-spelled ids landed on
    their engine targets. `persist=False` applies the flags without
    writing the project file."""
    ref_cfg = Path(work_dir) / ".pyp_config.toml"
    if ref_cfg.exists() and not (Path(work_dir) / cfg.PROJECT_FILE).exists():
        ref_params, report = cfg.load_reference_config(ref_cfg)
        logger.info("imported nextPYP project config: %d loaded / %d "
                    "tolerated / %d unimplemented / %d unknown",
                    len(report["loaded"]), len(report["tolerated"]),
                    len(report["unimplemented"]), len(report["unknown"]))
        if persist:
            cfg.save_parameters(ref_params, work_dir)
    overrides = cfg.parse_arguments(argv)
    # an argument is explicit iff its flag appears on the command line, so
    # a saved project value is not overridden by a flag's default
    given = {a.lstrip("-").split("=")[0] for a in argv if a.startswith("-")}
    defaults = cfg.defaults()
    explicit = {
        k: v for k, v in overrides.items()
        if k in given or defaults.get(k) != v
    }
    if not persist:
        saved = {**defaults, **(cfg.load_parameters(work_dir) or {})}
        saved.update(explicit)
        return apply_reference_aliases(saved)
    # aliases land AFTER persistence, so the project file keeps the user's
    # spelling
    return apply_reference_aliases(cfg.update_parameters(work_dir, explicit))


def slurm_requested(params: dict) -> bool:
    """True where the parameters ask for SLURM submission (a worker,
    marked by PYP_TPU_WORKER, executes instead)."""
    if os.environ.get("PYP_TPU_WORKER"):
        return False
    return bool(params.get("slurm_queue") or params.get("slurm_host")
                or params.get("slurm_submit"))


def mode_refine(argv, device="cuda"):
    params = _project_params(argv)
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.pipeline import refine as ref_pipe

    if slurm_requested(params):
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
