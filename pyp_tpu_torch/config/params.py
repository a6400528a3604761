"""Parameter handling: schema-driven CLI, project state, schedules.

Equivalents of the reference's system/project_params.py: generated argparse
(parse_parameters :377), persisted project state (.pyp_config.toml;
load/save_pyp_parameters :1159), and per-iteration schedule resolution
(`param()` :362 — "8:7:6:4:3" means value for iterations 2,3,4,5,6...).

The port's own copy of pyp_tpu/config/params.py; keep the two in step.
The port writes the project file atomically (the elements of a SLURM
array share it).
"""

from __future__ import annotations

import argparse
import os
import tomllib
from pathlib import Path

from pyp_tpu_torch.config.schema import SCHEMA, all_params, defaults

PROJECT_FILE = ".pyp_tpu_config.toml"


def build_parser(tabs=None) -> argparse.ArgumentParser:
    """Generate an argparse parser from the schema (all tabs by default)."""
    parser = argparse.ArgumentParser(
        prog="pyp_tpu", description="TPU-native cryo-EM/ET pipeline",
        fromfile_prefix_chars="@",
    )
    for tab, defs in SCHEMA.items():
        if tabs is not None and tab not in tabs:
            continue
        group = parser.add_argument_group(tab)
        for d in defs:
            flag = f"-{d.name}"
            kw: dict = {"help": d.help, "default": None}
            if d.type is bool:
                group.add_argument(flag, dest=d.name, action="store_true",
                                   default=None, help=d.help)
                group.add_argument(f"-no_{d.name}", dest=d.name,
                                   action="store_false", default=None,
                                   help=argparse.SUPPRESS)
            else:
                kw["type"] = d.type if not d.schedule else str
                if d.enum:
                    kw["choices"] = list(d.enum)
                group.add_argument(flag, dest=d.name, **kw)
    return parser


def parse_arguments(argv=None, tabs=None) -> dict:
    """CLI -> parameter dict (defaults + explicit overrides)."""
    parser = build_parser(tabs)
    ns, _unknown = parser.parse_known_args(argv)
    params = defaults()
    for k, v in vars(ns).items():
        if v is not None:
            params[k] = v
    return params


def param(value, iteration: int = 2):
    """Resolve an iteration-scheduled value: "8:7:6:4:3" -> value for the
    given refinement iteration (iteration 2 = first entry, reference
    convention project_params.py:362). Scalars pass through; schedules
    clamp to their last entry."""
    if isinstance(value, str) and ":" in value:
        parts = [p for p in value.split(":") if p != ""]
        idx = max(0, min(iteration - 2, len(parts) - 1))
        v = parts[idx]
        try:
            return int(v)
        except ValueError:
            return float(v)
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            try:
                return float(value)
            except ValueError:
                return value
    return value


# ---------------------------------------------------------------------------
# project state persistence (minimal TOML emitter; tomllib is read-only)
# ---------------------------------------------------------------------------

def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'


def save_parameters(params: dict, directory="."):
    path = Path(directory) / PROJECT_FILE
    known = all_params()
    lines = ["# pyp_tpu project parameters\n[parameters]"]
    for k in sorted(params):
        v = params[k]
        if v is None:
            continue
        lines.append(f"{k} = {_toml_value(v)}")
    unknown = [k for k in params if k not in known]
    # written under a private name, then renamed: the elements of a SLURM
    # array share the project file, and none reads a half-written one
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    tmp.write_text("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return path


def load_parameters(directory="."):
    path = Path(directory) / PROJECT_FILE
    if not path.exists():
        return None
    with open(path, "rb") as f:
        data = tomllib.load(f)
    params = defaults()
    params.update(data.get("parameters", {}))
    return params


# parameter-id families owned by external tools the rebuild deliberately
# replaces with native equivalents (VERDICT r3: relion_refine_*/tomodrgn_*
# are out of scope) — tolerated when loading a nextPYP project file
OUT_OF_SCOPE_PREFIXES = (
    "relion_refine_", "tomodrgn_", "cryodrgn_", "micromon",
    "detect_milo_", "detect_topaz2d_",
    # Warp/M integration tabs (the reference shells out to warptools;
    # this framework's native refinement covers the role)
    "mcore_",
)

# Recognized ids inside otherwise-wired tabs that configure the external
# tool's own implementation (torch/GPU plumbing, container paths, CUDA
# device splits). The native TPU equivalents make these moot; the loader
# accepts and records them rather than warning "unimplemented".
TOLERATED_IMPL_PREFIXES = (
    "tomo_denoise_topaz", "tomo_denoise_cryocare", "tomo_denoise_isonet",
    "tomo_mem_tardis_", "detect_nn3d_milo_",
    # remaining torch-trainer internals of tabs whose roles are native
    # (prism quality model, membrane segmenter, NN denoisers)
    "prism_train_", "prism_preprocessing_", "tomo_mem_",
    "tomo_denoise_",
)
TOLERATED_IMPL_IDS = frozenset({
    "tomo_pick_pytom_volume_split", "tomo_pick_pytom_rng_seed",
    "tomo_pick_pytom_search_x", "tomo_pick_pytom_search_y",
    "tomo_pick_pytom_search_z", "tomo_pick_pytom_defocus_handedness",
    "tomo_pick_pytom_tomogram_ctf_model", "tomo_pick_pytom_half_precision",
    "tomo_pick_pytom_use_existing_scores", "tomo_pick_pytom_tophat",
    "tomo_pick_pytom_tophat_connectivity", "tomo_pick_pytom_non_spherical",
    "detect_nn2d_tau", "detect_nn2d_algorithm", "detect_nn2d_noise_value",
    "detect_nn2d_noise_style", "detect_nn2d_bb", "detect_nn2d_debug",
    "detect_nn2d_alpha", "detect_nn2d_num", "detect_nn2d_num_particles",
    "detect_nn3d_compile", "detect_nn3d_compile_mode",
    "detect_nn3d_use_gpu_train", "detect_nn3d_use_gpu_eval",
    "detect_nn3d_val_interval", "detect_nn3d_val_debug_interval",
    "detect_nn3d_temp", "detect_nn3d_tau", "detect_nn3d_cr_weight",
    "detect_nn3d_translation_ratio", "detect_nn3d_loss_size_downscale",
    "detect_nn3d_loss_height_downscale", "detect_nn3d_patch_height",
    "detect_nn3d_compress", "detect_nn3d_with_score",
    "detect_nn3d_impute_tomograms", "detect_nn3d_mask_loss",
    "prism_train_workers", "prism_train_print_freq",
    "prism_train_world_size", "prism_train_rank",
    "prism_train_dist_backend", "prism_train_multiprocessing_distributed",
    "prism_train_add_datetime", "prism_train_evaluate",
    "prism_train_resume", "prism_train_feature_extractor_weights",
    "prism_train_fix_pred_lr", "tomo_mem_use_gpu",
    # web-UI session actions / display toggles (no engine behavior)
    "data_auto", "data_import", "data_retrieve", "import_enable",
    "import_read_star", "stream_camera_profile", "stream_scope_profile",
    "stream_file", "stream_process_format", "stream_transfer_all",
    "stream_transfer_fileset", "stream_transfer_remote",
    "stream_transfer_restart", "refine_daemon", "sharpen_plot_rhref",
    "sharpen_resmap_pval", "tomo_ali_export", "tomo_ali_format",
    "reconstruct_export_enable", "sva_class_selection",
    # external-binary internals of natively-covered stages
    "ctf_method", "movie_depth", "movie_source",
    "movie_motioncor_corr_interp", "movie_motioncor_in_frame_motion",
    "movie_motioncor_patch_overlap", "tomo_ali_aretomo_bft",
    "tomo_ali_aretomo_measure_tiltoff", "tomo_ali_sigma1",
    "tomo_ali_sigma2", "tomo_ali_pixels_trim_x", "tomo_ali_pixels_trim_y",
    "refine_adjust", "refine_fmag", "refine_imem", "refine_target",
    "refine_updateallparx", "refine_ref_par_path",
    "sharpen_cistem_part_ssnr_scale", "sharpen_cistem_statistics_path",
    "sharpen_cistem_use_statistics", "denoise2d_topaz_model",
    "scope_image_shift_x", "scope_image_shift_y",
    "tomo_ext_default", "tomo_ext_erase_detect_store",
    "tomo_ext_erase_iterations", "tomo_ext_erase_order",
    "tomo_rec_erase_detect_store", "tomo_rec_erase_iterations",
    "tomo_rec_erase_order", "tomo_rec_generate_halves_use_frames",
    "tomo_pick_contract_times_3d", "tomo_pick_min_size_3d",
    "tomo_pick_detection_width_3d", "tomo_pick_segmentation_path_path",
    "tomo_pick_vir_canny_low", "tomo_pick_vir_canny_high",
    "tomo_spk_contract_times_3d", "tomo_spk_min_size_3d",
    "tomo_spk_detection_width_3d", "tomo_spk_files_flip",
    "tomo_vir_canny_low", "tomo_vir_canny_high",
    "detect_nn3d_curvature_cutoff", "detect_nn3d_curvature_sampling",
    "detect_nn3d_mask_radius", "detect_nn3d_mask_segmentation",
    "detect_nn3d_use_masking", "detect_nn3d_r2_cutoff",
    "detect_nn3d_segmentation_dir_path", "detect_nn3d_segmentation_path_path",
    "extract_cls", "extract_method", "extract_use_clean",
    "reconstruct_denoise_dont_augment",
    "reconstruct_denoise_flatten_spectrum", "reconstruct_denoise_mini_model",
    "reconstruct_denoise_old_model_path",
    "reconstruct_denoise_overflatten_factor",
    "reconstruct_denoise_separately",
    "reconstruct_denoise_start_model_path",
    "reconstruct_dose_weighting_weights_input",
    "reconstruct_dose_weighting_weights_path",
    "detect_nn3d_segmentation_dir", "detect_nn3d_segmentation_path",
    "reconstruct_denoise_old_model", "reconstruct_denoise_start_model",
    "refine_ref_par", "sharpen_cistem_statistics",
    "tomo_pick_segmentation_path",
})


def _reference_ids() -> set:
    """All parameter ids the reference schema defines — the project-file
    format contract (pyp_config.toml [tabs.*]; regenerate the list with
    tools/make_reference_ids.py)."""
    path = Path(__file__).resolve().parent / "reference_param_ids.txt"
    return set(path.read_text().split())


def load_reference_config(path) -> tuple[dict, dict]:
    """Load a nextPYP project file (.pyp_config.toml: a flat TOML of
    reference parameter ids, reference project_params.py:550) into this
    framework's parameter namespace.

    Every key is classified: `loaded` (consumed by this framework, type-
    coerced via the schema), `tolerated` (a recognized external-tool id —
    OUT_OF_SCOPE_PREFIXES — accepted and recorded), `unimplemented` (a
    recognized reference id this framework does not consume yet; accepted
    with a warning so real project files never hard-fail), or `unknown`
    (not a reference id at all). Returns (params, report)."""
    from pyp_tpu_torch.utils import get_logger

    logger = get_logger("config")
    with open(path, "rb") as f:
        data = tomllib.load(f)
    if "parameters" in data and isinstance(data["parameters"], dict):
        data = data["parameters"]
    known = all_params()
    ref_ids = _reference_ids()
    params = defaults()
    report = {"loaded": [], "tolerated": [], "unimplemented": [],
              "unknown": []}
    for key, val in data.items():
        if key in known:
            d = known[key]
            try:
                if d.type is bool and not isinstance(val, bool):
                    val = str(val).strip().lower() in ("1", "true", "yes",
                                                       "on")
                elif d.type in (int, float) and not isinstance(
                        val, (int, float, bool)):
                    val = d.type(str(val).strip())
            except (TypeError, ValueError):
                logger.warning("%s: cannot coerce %r to %s — keeping raw",
                               key, val, d.type.__name__)
            params[key] = val
            report["loaded"].append(key)
        elif (key.startswith(OUT_OF_SCOPE_PREFIXES)
              or key.startswith(TOLERATED_IMPL_PREFIXES)
              or key in TOLERATED_IMPL_IDS):
            report["tolerated"].append(key)
        elif key in ref_ids:
            report["unimplemented"].append(key)
        else:
            report["unknown"].append(key)
    if report["tolerated"]:
        logger.info("%d external-tool settings tolerated (first: %s)",
                    len(report["tolerated"]), report["tolerated"][:3])
    if report["unimplemented"]:
        logger.warning(
            "%d recognized nextPYP settings are not consumed by this "
            "framework yet and will have no effect (first: %s)",
            len(report["unimplemented"]), report["unimplemented"][:5])
    if report["unknown"]:
        logger.warning("%d unknown keys ignored: %s",
                       len(report["unknown"]), report["unknown"][:10])
    return params, report


def update_parameters(directory, overrides: dict) -> dict:
    """Load + apply overrides + save (the reference's resume-with-changes)."""
    params = load_parameters(directory) or defaults()
    params.update({k: v for k, v in overrides.items() if v is not None})
    save_parameters(params, directory)
    return params
