"""Reference-spelled parameter ids and the per-block CSP tab fields.

The port's copy of the part of pyp_tpu/config/blocks.py that the schema
and the `refine` mode need: `BLOCK_FIELDS` (which fields each of nextPYP's
[tabs.csp_tomo_*] blocks exposes; the schema declares a parameter for
each) and `REFERENCE_ALIASES` with `apply_reference_aliases`, which lands
reference-spelled ids (metric_*, sharpen_cistem_*, dose_weighting_*, the
UI's file-picker twins, ...) on their engine targets; and the block
overrides of the `csp` mode (`apply_block_overrides` with
`block_mode_schedule`), which land a block tab's values on the csp_*
parameters.
"""

from __future__ import annotations

# engine-namespace targets shared by every refinement block
_SHARED_FIELDS = {
    "ToleranceMicrographTiltAngles": "csp_ToleranceMicrographTiltAngles",
    "ToleranceMicrographTiltAxisAngles":
        "csp_ToleranceMicrographTiltAxisAngles",
    "ToleranceMicrographShifts": "csp_ToleranceMicrographShifts",
    "ToleranceParticlesPhi": "csp_ToleranceParticlesPhi",
    "ToleranceParticlesPsi": "csp_ToleranceParticlesPsi",
    "ToleranceParticlesTheta": "csp_ToleranceParticlesTheta",
    "ToleranceParticlesShifts": "csp_ToleranceParticlesShifts",
    "ToleranceMicrographAstigmatism":
        "csp_ToleranceMicrographAstigmatism",
    "ToleranceMicrographDefocus1": "csp_ToleranceMicrographDefocus1",
    "ToleranceMicrographDefocus2": "csp_ToleranceMicrographDefocus2",
    "NumberOfRandomIterations": "csp_NumberOfRandomIterations",
    "OptimizerMaxIter": "csp_OptimizerIters",
    "OptimizerStepLength": "csp_OptimizerStepLength",
    "OptimizerStepTolerance": "csp_OptimizerStepTolerance",
    "OptimizerValueTolerance": "csp_OptimizerValueTolerance",
    "GridSearch": "csp_GridSearch",
    "Grid": "csp_Grid",
    "AngleStep": "csp_AngleStep",
    "ShiftStep": "csp_ShiftStep",
    "parfile": "csp_parfile",
    "resume": "csp_resume",
    "first_iter": "refine_iter",
    "iter": "refine_iter",
    "maxiter": "refine_maxiter",
    "transreg": "csp_transreg",
    "spatial_sigma": "csp_spatial_sigma",
    "time_sigma": "csp_time_sigma",
    "num": "class_num",
    "rhcls": "class_rhcls",
    "focusmask": "class_focusmask",
    "bin": "extract_bin",
    "force_init": "class3d_force_init",
    "refineeulers": "class3d_refineeulers",
    "refineshifts": "class3d_refineshifts",
    "InitialResolution": "csp_rlref",
    "ResolutionLimit": "csp_rhref",
    "InitialSkip": "abinit_skip",
    "RandomSkipRatio": "abinit_random_skip_ratio",
    "RandomParticles": "abinit_random_particles",
    "model": "csp_reference_model",
    "format": "import_format",
    "parfile_tomo": "csp_parfile_tomo",
    "refine_micrographs": None,   # consumed by the mode-schedule builder
    "refine_particles": None,
    "refine_ctf": None,
}

# which tab fields each block exposes (pyp_config.toml [tabs.csp_tomo_*])
BLOCK_FIELDS: dict[str, tuple] = {
    "csp_tomo_init": (
        "resume", "first_iter", "maxiter", "InitialResolution",
        "ResolutionLimit", "InitialSkip", "RandomSkipRatio",
        "RandomParticles", "GridSearch", "ToleranceParticlesPhi",
        "ToleranceParticlesPsi", "ToleranceParticlesTheta", "AngleStep",
        "ToleranceParticlesShifts", "ShiftStep", "num", "rhcls",
        "OptimizerMaxIter", "OptimizerStepLength", "OptimizerStepTolerance",
        "OptimizerValueTolerance",
    ),
    "csp_tomo_coarse": (
        "parfile", "resume", "first_iter", "iter", "maxiter",
        "refine_micrographs", "ToleranceMicrographTiltAngles",
        "ToleranceMicrographTiltAxisAngles", "ToleranceMicrographShifts",
        "refine_particles", "ToleranceParticlesPhi", "ToleranceParticlesPsi",
        "ToleranceParticlesTheta", "ToleranceParticlesShifts", "refine_ctf",
        "ToleranceMicrographAstigmatism", "ToleranceMicrographDefocus1",
        "ToleranceMicrographDefocus2", "Grid", "NumberOfRandomIterations",
        "OptimizerMaxIter", "OptimizerStepLength", "OptimizerStepTolerance",
        "OptimizerValueTolerance",
    ),
    "csp_tomo_reference": (
        "model", "ToleranceParticlesPhi", "ToleranceParticlesPsi",
        "ToleranceParticlesTheta", "AngleStep", "ToleranceParticlesShifts",
        "ShiftStep", "OptimizerMaxIter", "OptimizerStepLength",
        "OptimizerStepTolerance", "OptimizerValueTolerance",
    ),
    "csp_tomo_movie": (
        "parfile", "resume", "first_iter", "iter", "maxiter", "transreg",
        "spatial_sigma", "time_sigma",
    ),
    "csp_tomo_movie_after": (
        "parfile", "resume", "first_iter", "iter", "maxiter",
        "refine_micrographs", "ToleranceMicrographTiltAngles",
        "ToleranceMicrographTiltAxisAngles", "ToleranceMicrographShifts",
        "refine_particles", "ToleranceParticlesPhi", "ToleranceParticlesPsi",
        "ToleranceParticlesTheta", "ToleranceParticlesShifts",
        "NumberOfRandomIterations", "OptimizerMaxIter",
        "OptimizerStepLength", "OptimizerStepTolerance",
        "OptimizerValueTolerance",
    ),
    "csp_tomo_classification": (
        "parfile", "resume", "first_iter", "iter", "maxiter", "num",
        "rhcls", "force_init", "bin", "refineeulers", "refineshifts",
        "focusmask", "refine_particles", "ToleranceParticlesPhi",
        "ToleranceParticlesPsi", "ToleranceParticlesTheta",
        "ToleranceParticlesShifts", "NumberOfRandomIterations",
        "OptimizerMaxIter", "OptimizerStepLength", "OptimizerStepTolerance",
        "OptimizerValueTolerance",
    ),
    "csp_tomo_free": ("format", "parfile_tomo", "parfile"),
}


# block behavior beyond plain value overrides
_BLOCK_MODES = {
    # init: particle orientations/shifts from scratch (grid + local)
    "csp_tomo_init": dict(micrographs=False, particles=True, ctf=False),
    # reference-based: particle axes only
    "csp_tomo_reference": dict(micrographs=False, particles=True, ctf=False),
    # movie: frame refinement, no geometry modes
    "csp_tomo_movie": dict(frames=True),
}


def block_mode_schedule(micrographs: bool, particles: bool,
                        ctf: bool) -> str:
    """Compose the CSP mode schedule from the block's refine switches the
    way the reference builds its mode list (align/core.py:1015-1023), in
    this engine's measured-best order: micrograph shifts (3) then tilt
    geometry (0) before particle shifts (2) then angles (1); defocus (4)
    last."""
    modes = []
    if micrographs:
        modes += [3, 0]
    if particles:
        modes += [2, 1]
    if ctf:
        modes += [4]
    return ":".join(str(m) for m in modes) if modes else "2:1"


# ---------------------------------------------------------------------------
# Reference-id aliases: nextPYP tabs whose fields are alternate spellings of
# engine parameters this framework already consumes (metric, sharpen_cistem,
# sharpen_relion, dose_weighting, class2d — pyp_config.toml). Each entry is
# reference_id -> (target, transform|None) or (targets tuple, transform).
# Applied by apply_reference_aliases for every explicitly-set key.

def _neg(v):
    return not bool(v)


def _auto_b(v):
    # relion auto_bfac=true == "fit the B-factor" == our sharpen_bfactor 0
    return 0.0 if v else None


def _pick_method(v):
    # reference tomo_pick method enum -> engine tomo_spk_method values
    return {"pytom": "template", "virions": "surface", "manual": "import",
            "milo": "nn"}.get(str(v), str(v))


def _x16(v):
    # reference level-set iteration counts -> SH-refinement gradient steps
    return int(round(float(v) * 16))


def _fiber(v):
    # detect_nn3d fiber_mode=true -> the native filament tracer
    return "filament" if v else None


def _hamming(v):
    return "hamming" if v else None


def _win_enum(v):
    # reference 2D/radial filter form enums -> engine WBP window names
    return {"hamming": "hamming", "mtfilter": "radial", "lpradial": "radial",
            "fakesirt": "ramp", "none": "ramp"}.get(str(v), str(v))


def _sart(v):
    return "sart" if v else None


def _local_mode(v):
    return str(v) == "local"


def _dbg_trace(v):
    return "trace" if v else None


def _dbg_debug(v):
    return "debug" if v else None


def _dbg_info(v):
    return "info" if v else None


REFERENCE_ALIASES: dict[str, tuple] = {
    # ---- metric tab (refinement metric selection, pyp_config [tabs.metric])
    "metric_UseImagesForRefinementMin": ("csp_UseImagesForRefinementMin",
                                         None),
    "metric_UseImagesForRefinementMax": ("csp_UseImagesForRefinementMax",
                                         None),
    "metric_RefineProjectionCutoff": ("csp_RefineProjectionCutoff", None),
    "metric_rlref": (("refine_rlref", "csp_rlref"), None),
    "metric_rhref": (("refine_rhref", "csp_rhref"), None),
    "metric_fboost": ("refine_fboost", None),
    "metric_fboostlim": ("refine_fboostlim", None),
    "metric_fssnr": ("refine_fssnr", None),
    "metric_priors": ("refine_priors", None),
    "metric_score_weighting": ("refine_score_weighting", None),
    "metric_masking_method": ("refine_masking_method", None),
    "metric_global_stat": ("refine_global_stat", None),
    "metric_srad": ("refine_srad", None),
    "metric_maskth": ("refine_maskth", None),
    # ---- sharpen_cistem tab (cisTEM sharpen_map stdin card)
    "sharpen_cistem_input_map": ("sharpen_input_map", None),
    "sharpen_cistem_inner_mask_radius": ("sharpen_inner_mask_radius", None),
    "sharpen_cistem_outer_mask_radius": ("sharpen_outer_mask_radius", None),
    "sharpen_cistem_low_res_bfactor": ("sharpen_low_res_bfactor", None),
    "sharpen_cistem_high_res_bfactor": ("sharpen_high_res_bfactor", None),
    "sharpen_cistem_low_res_flattening": ("sharpen_flatten_res", None),
    "sharpen_cistem_high_res_limit": ("sharpen_high_res_limit", None),
    "sharpen_cistem_filter_edge_width": ("sharpen_edge_width", None),
    "sharpen_cistem_use_mask": ("sharpen_apply_mask", None),
    "sharpen_cistem_invert_handedness": ("sharpen_invert_handedness", None),
    # ---- sharpen_relion tab (relion_postprocess flags)
    "sharpen_relion_first_half": ("sharpen_first_half", None),
    "sharpen_relion_second_half": ("sharpen_second_half", None),
    "sharpen_relion_auto_mask": ("sharpen_apply_mask", None),
    "sharpen_relion_inimask_threshold": ("sharpen_mask_threshold", None),
    "sharpen_relion_extend_inimask": ("sharpen_mask_dilation", None),
    "sharpen_relion_width_mask_edge": ("sharpen_mask_soft", None),
    "sharpen_relion_mask": ("sharpen_mask", None),
    "sharpen_relion_mtf": ("sharpen_mtf", None),
    "sharpen_relion_auto_bfac": ("sharpen_bfactor", _auto_b),
    "sharpen_relion_autob_lowres": ("sharpen_bfac_lowres", None),
    "sharpen_relion_autob_highres": ("sharpen_bfac_highres", None),
    "sharpen_relion_adhoc_bfac": ("sharpen_bfactor", None),
    "sharpen_relion_skip_fsc_weighting": ("sharpen_fsc_weight", _neg),
    "sharpen_relion_low_pass": ("sharpen_high_res_limit", None),
    "sharpen_relion_locres": ("sharpen_locres", None),
    "sharpen_relion_locres_sampling": ("sharpen_locres_sampling", None),
    "sharpen_relion_locres_maskrad": ("sharpen_locres_maskrad", None),
    "sharpen_relion_locres_edgwidth": ("sharpen_locres_edgwidth", None),
    "sharpen_relion_locres_randomize_at": ("sharpen_locres_randomize_at",
                                           None),
    "sharpen_relion_locres_minres": ("sharpen_locres_minres", None),
    "sharpen_relion_ampl_corr": ("sharpen_ampl_corr", None),
    "sharpen_relion_randomize_at_fsc": ("sharpen_randomize_at_fsc", None),
    "sharpen_relion_randomize_at_A": ("sharpen_rand_res", None),
    "sharpen_relion_filter_edge_width": ("sharpen_edge_width", None),
    "sharpen_relion_random_seed": ("sharpen_random_seed", None),
    # ---- dose_weighting tab -> the engine's dose model
    "dose_weighting_enable": ("reconstruct_dose_weighting_enable", None),
    "dose_weighting_fraction": ("dose_weight_fraction", None),
    "dose_weighting_transition": ("dose_weight_transition", None),
    "dose_weighting_multiply": ("dose_weight_multiply", None),
    "dose_weighting_global": ("dose_weight_global", None),
    "dose_weighting_weights": ("dose_weight_weights", None),
    # ---- tomo_pick tab -> the 3D picking dispatch + native template match
    "tomo_pick_method": ("tomo_spk_method", _pick_method),
    "tomo_pick_rad": ("tomo_spk_rad", None),
    "tomo_pick_dilation_3d": ("tomo_spk_dist", None),
    "tomo_pick_pytom_template": ("tomo_pick_ref", None),
    "tomo_pick_pytom_template_size": ("tomo_pick_template_size", None),
    "tomo_pick_pytom_template_invert": ("tomo_pick_template_invert", None),
    "tomo_pick_pytom_template_mirror": ("tomo_pick_template_mirror", None),
    "tomo_pick_pytom_mask_method": ("tomo_pick_mask_method", None),
    "tomo_pick_pytom_mask_sigma": ("tomo_pick_mask_sigma", None),
    "tomo_pick_pytom_mask_file": ("tomo_pick_mask_file", None),
    "tomo_pick_pytom_angular_search": ("tomo_pick_ang", None),
    "tomo_pick_pytom_low_pass": ("tomo_pick_low_pass", None),
    "tomo_pick_pytom_high_pass": ("tomo_pick_high_pass", None),
    "tomo_pick_pytom_spectral_whitening":
        ("tomo_pick_spectral_whitening", None),
    "tomo_pick_pytom_random_phase_correction":
        ("tomo_pick_random_phase_correction", None),
    "tomo_pick_pytom_estimate_cutoff": ("tomo_pick_estimate_cutoff", None),
    "tomo_pick_pytom_cutoff": ("tomo_pick_cutoff", None),
    "tomo_pick_pytom_number_of_particles": ("tomo_spk_max", None),
    "tomo_pick_pytom_number_of_false_positives":
        ("tomo_pick_n_false_positives", None),
    "tomo_pick_vir_rad": ("tomo_vir_rad", None),
    "tomo_pick_vir_number": ("tomo_vir_detect_max", None),
    "tomo_pick_vir_det_tol": ("tomo_vir_det_tol", None),
    "tomo_pick_vir_iterations": ("tomo_vir_sh_iters", _x16),
    "tomo_pick_vir_binn": ("tomo_vir_binn", None),
    # ---- detect_nn2d tab -> the native 2D picker trainer (models/picker)
    "detect_nn2d_iterations": ("train_steps", None),
    "detect_nn2d_batch_size": ("train_batch", None),
    "detect_nn2d_patch_size": ("train_patch", None),
    "detect_nn2d_thresh": ("detect_nn_threshold", None),
    "detect_nn2d_ref": ("detect_nn_model", None),
    "detect_nn2d_bin": ("train_bin", None),
    # ---- detect_nn3d tab -> the native tomogram picker trainer
    "detect_nn3d_lr": ("train_lr", None),
    "detect_nn3d_patch_size": ("train_patch", None),
    "detect_nn3d_thresh": ("detect_nn_threshold", None),
    "detect_nn3d_ref": ("detect_nn_model", None),
    "detect_nn3d_rad": ("tomo_spk_rad", None),
    "detect_nn3d_max_objects": ("tomo_spk_max", None),
    "detect_nn3d_down_ratio": ("train_bin", None),
    "detect_nn3d_distance_cutoff": ("tomo_spk_dist", None),
    "detect_nn3d_fiber_mode": ("tomo_spk_method", _fiber),
    # ---- tomo_denoise tab (core) -> the native denoiser trainers
    "tomo_denoise_method": ("denoise_method", None),
    "tomo_denoise_iterations": ("denoise_epochs", None),
    "tomo_denoise_batchsize": ("denoise_batch", None),
    "tomo_denoise_learningrate": ("denoise_lr", None),
    "tomo_denoise_window": ("denoise_patch", None),
    "tomo_denoise_lowpass": ("denoise_lowpass", None),
    # ---- tomo_srf tab -> surface-constrained picking
    "tomo_srf_detect_rad": ("tomo_spk_rad", None),
    "tomo_srf_detect_thre": ("tomo_spk_thresh", None),
    "tomo_srf_detect_dist": ("tomo_spk_dist", None),
    "tomo_srf_detect_band": ("tomo_vir_detect_band", None),
    "tomo_srf_detect_rand": ("tomo_pick_rand", None),
    "tomo_srf_detect_method": ("tomo_vir_method", None),
    "tomo_srf_detect_ref": ("tomo_pick_ref", None),
    "tomo_srf_detect_offset": ("tomo_srf_offset", None),
    # ---- tomo_sphere tab -> SH membrane refinement
    "tomo_sphere_smoothness": ("tomo_vir_sh_smoothness", None),
    "tomo_sphere_iterations": ("tomo_vir_sh_iters", _x16),
    "tomo_sphere_seg_tol": ("tomo_sphere_seg_tol_px", None),
    # ---- tomo_ext tab -> extraction / WBP filter windows
    "tomo_ext_fmt": ("extract_fmt", None),
    "tomo_ext_size": ("extract_box", None),
    "tomo_ext_binn": ("extract_bin", None),
    "tomo_ext_mtfilter_cutoff": ("tomo_rec_filter_cutoff", None),
    "tomo_ext_mtfilter_falloff": ("tomo_rec_filter_falloff", None),
    "tomo_ext_lpradial_cutoff": ("tomo_rec_filter_cutoff", None),
    "tomo_ext_lpradial_falloff": ("tomo_rec_filter_falloff", None),
    "tomo_ext_hamming": ("tomo_rec_filter_window", _hamming),
    "tomo_ext_fake_sirt_iterations": ("tomo_rec_fake_sirt", None),
    "tomo_ext_erase_fiducials": ("tomo_rec_erase_fiducials", None),
    # ---- movie tab (motioncor spellings) -> the TPU motion kernel
    "movie_motioncor_bin": ("movie_align_bin", None),
    "movie_motioncor_bfactor_global": ("movie_bfactor", None),
    "movie_motioncor_bfactor_local": ("movie_patch_bfactor", None),
    "movie_motioncor_iter": ("movie_iters", None),
    "movie_motioncor_tol": ("movie_tol", None),
    "movie_motioncor_patch_x": ("movie_patches", None),
    "movie_motioncor_patch_y": ("movie_patches", None),
    "movie_motioncor_phase_only": ("movie_phase_only", None),
    "movie_motioncor_sumrange_min": ("movie_first", None),
    "movie_motioncor_sumrange_max": ("movie_last", None),
    # ---- prism tab -> the native quality model
    "prism_train_epochs": ("prism_steps", None),
    "prism_train_batch_size": ("prism_batch", None),
    "prism_train_lr": ("prism_lr", None),
    "prism_train_seed": ("prism_seed", None),
    "prism_train_dim": ("prism_latent", None),
    "prism_train_momentum": ("prism_momentum", None),
    "prism_train_weight_decay": ("prism_weight_decay", None),
    "prism_train_print_freq": ("prism_print_freq", None),
    "movie_motioncor_frameref": ("movie_ref", None),
    # ---- class2d tab -> 2D classification protocol
    "class2d_num": ("class_num", None),
    "class2d_rlref": ("class_rlcls", None),
    "class2d_rhref": ("class_rhcls", None),
    "class2d_ctf_min_res": ("ctf_min_res", None),
    # ---- sharpen tab (reference spellings of the postprocess knobs)
    "sharpen_automask_lp": ("sharpen_mask_lowpass", None),
    "sharpen_automask_threshold": ("sharpen_mask_threshold", None),
    "sharpen_adhoc_bfac": ("sharpen_bfactor", None),
    "sharpen_auto_bfac_low": ("sharpen_bfac_lowres", None),
    "sharpen_auto_bfac_high": ("sharpen_bfac_highres", None),
    "sharpen_skip_fsc_weighting": ("sharpen_fsc_weight", _neg),
    "sharpen_lowpass": ("sharpen_high_res_limit", None),
    "sharpen_randomize_below_fsc": ("sharpen_randomize_at_fsc", None),
    "sharpen_randomize_beyond": ("sharpen_rand_res", None),
    "sharpen_resmap": ("sharpen_locres", None),
    "sharpen_resmap_min_res": ("sharpen_locres_minres", None),
    "sharpen_resmap_step_size": ("sharpen_locres_sampling", None),
    # ---- ctf tab (reference spellings of the CTF-fit geometry)
    "ctf_phase_shift": ("ctf_use_phs", None),
    "ctf_min_rad": ("ctf_min_res", None),
    "ctf_max_rad": ("ctf_max_res", None),
    "ctf_ps_step": ("ctf_phase_steps", None),
    "ctf_determine_tilt": ("ctf_use_lcl", None),
    "ctf_tilt_axis": ("scope_tilt_axis", None),
    "ctf_handedness_mintilt": ("tomo_hand_min_tilt", None),
    "ctf_handedness_maxtilt": ("tomo_hand_max_tilt", None),
    # ---- movie tab (unblur/motioncor drivers)
    "movie_no_frames": ("movie_ali", _neg),
    "movie_bin": ("movie_align_bin", None),
    "movie_eer_reduce": ("movie_eer_frames", None),
    "movie_pbc": ("refine_pbc", None),
    "movie_boff": ("refine_boff", None),
    # ---- refine tab (FREALIGN/cisTEM card spellings)
    "refine_dataset": ("data_set", None),
    "refine_model": ("model_path", None),
    "refine_parfile": ("csp_parfile", None),
    "refine_parfile_tomo": ("csp_parfile_tomo", None),
    "refine_resume": ("csp_resume", None),
    "refine_first_iter": ("refine_iter", None),
    "refine_itmax": ("refine_frm_rounds", None),
    "refine_crop": ("reconstruct_crop", None),
    "refine_debug": ("slurm_verbose", None),
    "refine_dfsig": ("refine_def_range", None),
    "refine_fastig": ("refine_fdef", None),
    "refine_fpart": ("refine_fdef", None),
    "refine_merge_normalize": ("reconstruct_norm", None),
    "refine_xstd": ("refine_maskth", None),
    "refine_same_ref": ("refine_goldstandard", _neg),
    "refine_interp": ("reconstruct_gridding", None),
    "refine_invert": ("data_invert", None),
    "refine_ipmax": ("refine_topk", None),
    # ---- reconstruct tab (FREALIGN reconstruct/merge cards)
    "reconstruct_cutoff": ("reconstruct_score_threshold", None),
    "reconstruct_threc": ("reconstruct_score_threshold", None),
    "reconstruct_optimal_cutoff": ("reconstruct_score_fraction", None),
    "reconstruct_radrec": ("reconstruct_rrec", None),
    "reconstruct_saveplots": ("plot_per_item", None),
    "reconstruct_num_frames": ("csp_frames", None),
    "reconstruct_scratch_copy_stack": ("csp_save_stacks", None),
    "reconstruct_weights": ("movie_weights", None),
    "reconstruct_ffilt": ("refine_fssnr", None),
    "reconstruct_lblur_start": ("reconstruct_lblur_range", None),
    "reconstruct_dose_weighting_global": ("dose_weight_global", None),
    "reconstruct_dose_weighting_fraction": ("dose_weight_fraction", None),
    "reconstruct_dose_weighting_transition": ("dose_weight_transition", None),
    "reconstruct_dose_weighting_multiply": ("dose_weight_multiply", None),
    "reconstruct_denoise_enable": ("denoise_spr", None),
    "reconstruct_denoise_method": ("denoise_method", None),
    "reconstruct_denoise_iters": ("denoise_epochs", None),
    "reconstruct_denoise_iterations": ("denoise_epochs", None),
    "reconstruct_denoise_patch_size": ("denoise_patch", None),
    "reconstruct_denoise_window": ("denoise_patch", None),
    "reconstruct_denoise_batchsize": ("denoise_batch", None),
    "reconstruct_denoise_learningrate_start": ("denoise_lr", None),
    "reconstruct_denoise_lowpass": ("denoise_lowpass", None),
    # ---- extract tab
    "extract_gold": ("detect_gold_erase", None),
    "extract_ctf_handedness": ("csp_ctf_handedness", None),
    "extract_ctf_handedness_force": ("tomo_hand_detect", _neg),
    "extract_wgh": ("scope_wgh", None),
    "extract_stacks": ("csp_save_stacks", None),
    "extract_using_frames": ("csp_frames", None),
    # ---- sva tab (3DAVG subvolume averaging)
    "sva_symmetry": ("particle_sym", None),
    "sva_centering_symmetry": ("particle_sym", None),
    "sva_refine_iter": ("sva_iters", None),
    "sva_mode": ("sva_local", _local_mode),
    "sva_zcorr": ("sva_wedge", None),
    "sva_class_num": ("sva_classes", None),
    "sva_centering_iterations": ("sva_centering_iters", None),
    "sva_tol_angle": ("sva_ang", None),
    "sva_tol_shifts": ("sva_shift", None),
    "sva_pre_selection_fraction": ("sva_keep_fraction", None),
    "sva_mask": ("mask_file", None),
    "sva_filter_map": ("sva_lowpass", None),
    # ---- stream tab (session daemon)
    "stream_session_name": ("data_set", None),
    "stream_session_group": ("stream_group", None),
    "stream_session_timeout": ("stream_idle_exit", None),
    "stream_transfer_local": ("stream_transfer_dir", None),
    "stream_transfer_target_path": ("stream_transfer_dir", None),
    "stream_transfer_age": ("stream_settle_polls", None),
    # ---- csp tab (CSP binary argv spellings)
    "csp_Grid_spr": ("csp_Grid", None),
    "csp_OptimizerMaxIter": ("csp_OptimizerIters", None),
    "csp_abinitio": ("refine_abinit", None),
    "csp_InitialResolution": ("csp_rlref", None),
    "csp_ResolutionLimit": ("csp_rhref", None),
    "csp_automask": ("refine_mask", None),
    "csp_frame_refinement": ("csp_frames", None),
    "csp_produce_running_average": ("movie_group", None),
    "csp_ctf_handedness_force": ("tomo_hand_detect", _neg),
    "csp_thresh": ("reconstruct_score_threshold", None),
    "csp_stacks": ("csp_save_stacks", None),
    "csp_no_stacks": ("csp_save_stacks", _neg),
    "csp_parx_only": ("csp_save_stacks", _neg),
    "csp_DebugFull": ("slurm_verbose_level", _dbg_trace),
    "csp_DebugData": ("slurm_verbose_level", _dbg_trace),
    "csp_DebugBasic": ("slurm_verbose_level", _dbg_debug),
    "csp_DebugInfo": ("slurm_verbose_level", _dbg_debug),
    "csp_DebugNone": ("slurm_verbose_level", _dbg_info),
    # ---- class tab
    "class_force_init": ("class3d_force_init", None),
    "class_bin": ("train_bin", None),
    "class_refineeulers": ("class3d_refineeulers", None),
    "class_refineshifts": ("class3d_refineshifts", None),
    # ---- gain tab
    "gain_remove_hot_pixels": ("data_remove_xrays", None),
    # ---- clean tab
    "clean_threshold": ("clean_min_score", None),
    # ---- detect tab (SPA picking)
    "detect_thre": ("detect_thresh", None),
    "detect_ignore_contamination": ("detect_contamination", _neg),
    "detect_rand": ("tomo_pick_rand", None),
    "detect_ref": ("detect_nn_model", None),
    # ---- denoise2d tab
    "denoise2d_method": ("denoise_method", None),
    # ---- import tab (RELION star interop)
    "import_mode": ("data_mode", None),
    "import_tilt_series_star": ("import_tomo_star", None),
    "import_tomo_motion_star": ("import_motion_star", None),
    # ---- tomo_rec tab (IMOD tilt / AreTomo spellings)
    "tomo_rec_2d_filtering_method": ("tomo_rec_filter_window", _win_enum),
    "tomo_rec_filtering_method": ("tomo_rec_filter_window", _win_enum),
    "tomo_rec_filter_form": ("tomo_rec_filter_window", _win_enum),
    "tomo_rec_mtfilter_cutoff": ("tomo_rec_filter_cutoff", None),
    "tomo_rec_mtfilter_falloff": ("tomo_rec_filter_falloff", None),
    "tomo_rec_lpradial_cutoff": ("tomo_rec_filter_cutoff", None),
    "tomo_rec_lpradial_falloff": ("tomo_rec_filter_falloff", None),
    "tomo_rec_hamming": ("tomo_rec_filter_window", _hamming),
    "tomo_rec_fake_sirt_iterations": ("tomo_rec_fake_sirt", None),
    "tomo_rec_aretomo_sart": ("tomo_rec_method", _sart),
    "tomo_rec_aretomo_sart_iter": ("tomo_rec_sart_iters", None),
    "tomo_rec_aretomo_sart_num_projs": ("tomo_rec_sart_subsets", None),
    "tomo_rec_erase_detect_max": ("detect_gold_max", None),
    "tomo_rec_erase_detect_threshold": ("detect_gold_thresh", None),
    "tomo_rec_depth": ("tomo_rec_thickness", None),
    # ---- tomo_ali tab (etomo/AreTomo spellings)
    "tomo_ali_auto_bin": ("tomo_ali_bin", None),
    "tomo_ali_binning": ("tomo_ali_bin", None),
    "tomo_ali_fiducial_number": ("tomo_ali_fiducial_n", None),
    "tomo_ali_radius1": ("tomo_ali_bp_low", None),
    "tomo_ali_radius2": ("tomo_ali_bp_high", None),
    "tomo_ali_iterate": ("tomo_ali_model_iters", None),
    "tomo_ali_coarse_iterate": ("tomo_ali_model_iters", None),
    "tomo_ali_patches_x": ("tomo_ali_patches", None),
    "tomo_ali_patches_y": ("tomo_ali_patches", None),
    "tomo_ali_patches_size_x": ("tomo_ali_patch_size", None),
    "tomo_ali_patches_size_y": ("tomo_ali_patch_size", None),
    "tomo_ali_aretomo_zheight": ("tomo_rec_thickness", None),
    "tomo_ali_aretomo3_zheight": ("tomo_rec_thickness", None),
    "tomo_ali_aretomo_estimate_zheight": ("tomo_rec_thickness", None),
    # ---- tomo_vir tab (virion detection/segmentation)
    "tomo_vir_number": ("tomo_vir_detect_max", None),
    "tomo_vir_seg_tol": ("tomo_sphere_seg_tol_px", None),
    "tomo_vir_seg_smoothness": ("tomo_vir_sh_smoothness", None),
    "tomo_vir_seg_iterations": ("tomo_vir_sh_iters", _x16),
    "tomo_vir_iterations": ("tomo_vir_sh_iters", _x16),
    "tomo_vir_detect_method": ("tomo_vir_method", None),
    "tomo_vir_detect_ref": ("tomo_pick_ref", None),
    "tomo_vir_detect_thre": ("tomo_spk_thresh", None),
    "tomo_vir_detect_dist": ("tomo_spk_dist", None),
    "tomo_vir_detect_rand": ("tomo_pick_rand", None),
    "tomo_vir_detect_offset": ("tomo_srf_offset", None),
    "tomo_vir_force": ("detect_force", None),
    "tomo_srf_force": ("detect_force", None),
    # ---- tomo_spk tab (size-based 3D picker)
    "tomo_spk_dilation_3d": ("tomo_spk_dist", None),
    "tomo_spk_inhibit_3d": ("tomo_spk_dist", None),
    "tomo_spk_remove_edge_3d": ("tomo_pick_remove_edge_3d", None),
    "tomo_spk_stdtimes_cont_3d": ("detect_cont_sigma", None),
    "tomo_spk_rand": ("tomo_pick_rand", None),
    # ---- tomo_pick tab (additional pytom/manual spellings)
    "tomo_pick_stdtimes_cont_3d": ("detect_cont_sigma", None),
    "tomo_pick_inhibit_3d": ("tomo_spk_dist", None),
    "tomo_pick_normals": ("refine_priors", None),
    "tomo_pick_use_vector_normals": ("refine_priors", None),
    "tomo_pick_pytom_defocus_handedness": ("csp_ctf_handedness", None),
    "tomo_pick_pytom_half_precision": ("tomo_rec_float16", None),
    # ---- tomo_ext tab (extraction-time reconstruction filters)
    "tomo_ext_2d_filtering_method": ("tomo_rec_filter_window", _win_enum),
    "tomo_ext_filtering_method": ("tomo_rec_filter_window", _win_enum),
    "tomo_ext_filter_form": ("tomo_rec_filter_window", _win_enum),
    "tomo_ext_erase_detect_max": ("detect_gold_max", None),
    "tomo_ext_erase_detect_threshold": ("detect_gold_thresh", None),
    "tomo_ext_coords": ("tomo_pick_files", None),
    # ---- debug spellings -> worker log level
    "tomo_vir_seg_debug": ("slurm_verbose", None),
    "tomo_vir_debug": ("slurm_verbose", None),
    "tomo_sphere_debug": ("slurm_verbose", None),
    # ---- tomo_spk spellings of the consumed tomo_pick 3D picker cards
    "tomo_spk_gaussian_3d": ("tomo_pick_gaussian_3d", None),
    "tomo_spk_sigma_3d": ("tomo_pick_sigma_3d", None),
    "tomo_spk_stdtimes_filt_3d": ("tomo_pick_stdtimes_filt_3d", None),
    "tomo_spk_radiustimes_3d": ("tomo_pick_radiustimes_3d", None),
    "tomo_spk_files_path": ("tomo_pick_files", None),
    # ---- aretomo tilt-offset spelling
    "tomo_ali_aretomo_tiltoff": ("tomo_ali_tiltoff", None),
    # ---- remaining detect spellings
    "detect_offset": ("tomo_srf_offset", None),
    "detect_nn3d_rand": ("tomo_pick_rand", None),
    "detect_nn3d_normals": ("refine_priors", None),
    "detect_nn3d_use_vector_normals": ("refine_priors", None),
    "detect_nn3d_pred_diameter": ("tomo_spk_rad", None),
    "detect_nn3d_bbox": ("train_patch", None),
    # ---- membrane NN spellings
    "tomo_mem_model_path": ("tomo_mem_model", None),
    "tomo_mem_target_path": ("tomo_mem_model", None),
    "tomo_mem_target_input": ("tomo_mem_model", None),
    # ---- remaining sva selection-fraction spellings
    "sva_class_refinement_iterations": ("sva_iters", None),
    "sva_class_selection_fraction": ("sva_keep_fraction", None),
    "sva_cluster_selection_fraction": ("sva_keep_fraction", None),
    "sva_pre_selection_fraction_centering": ("sva_keep_fraction", None),
    # ---- remaining sharpen/denoise/dose spellings
    "sharpen_relion_force_mask": ("sharpen_apply_mask", None),
    "tomo_denoise_learningrate_start": ("denoise_lr", None),
    "tomo_denoise_learningrate_finish": ("denoise_lr_finish", None),
    "reconstruct_denoise_learningrate_finish": ("denoise_lr_finish", None),
    "reconstruct_denoise_nsearch": ("denoise_nsearch", None),
    "reconstruct_denoise_sigma": ("denoise_sigma", None),
    "tomo_denoise_force": ("tomo_rec_force", None),
    "tomo_ext_padd": ("extract_bnd", None),
    "tomo_ext_erase_factor": ("tomo_rec_erase_factor", None),
    # ---- score-shaping group-count spellings
    "reconstruct_agroups": ("clean_shape_angles", None),
    "reconstruct_dgroups": ("clean_shape_defocuses", None),
    # ---- import spellings
    "import_relion_path": ("data_parent", None),
    # ---- bare stems of the file-picker twins (the UI stores the stem id
    # too; same engine targets as their _path/_input twins)
    "clean_parfile": ("csp_parfile", None),
    "sva_parfile": ("csp_parfile", None),
    "detect_files": ("tomo_pick_files", None),
    "tomo_spk_files": ("tomo_pick_files", None),
    "mask_model": ("mask_file", None),
    "reconstruct_dose_weighting_weights": ("dose_weight_weights", None),
    "stream_transfer_target": ("stream_transfer_dir", None),
    "tomo_ali_import": ("tomo_ali_import_path", None),
}

# Reference UI file-picker twins: every file parameter X is mirrored by
# X_path (server-side path picker) and/or X_input (upload widget) in
# pyp_config.toml; both land on the engine's X. Twins whose stem is itself
# an alias resolve the chain at build time so apply_reference_aliases stays
# single-pass.
_TWIN_IDS = [
    "csp_tomo_classification_parfile_input",
    "csp_tomo_classification_parfile_path",
    "csp_tomo_coarse_parfile_input", "csp_tomo_coarse_parfile_path",
    "csp_tomo_free_parfile_input", "csp_tomo_free_parfile_path",
    "csp_tomo_free_parfile_tomo_input", "csp_tomo_free_parfile_tomo_path",
    "csp_tomo_movie_after_parfile_input", "csp_tomo_movie_after_parfile_path",
    "csp_tomo_movie_parfile_input", "csp_tomo_movie_parfile_path",
    "csp_tomo_reference_model_input", "csp_tomo_reference_model_path",
    "data_parent_path", "data_path_path",
    "detect_nn2d_ref_input", "detect_nn2d_ref_path",
    "detect_nn3d_ref_input", "detect_nn3d_ref_path",
    "detect_ref_path", "detect_ref_input", "detect_files_path",
    "dose_weighting_weights_path", "gain_reference_path",
    "import_motion_star_input", "import_motion_star_path",
    "import_refine_star_input", "import_refine_star_path",
    "import_tomo_star_input", "import_tomo_star_path",
    "import_tilt_series_star_path", "import_tilt_series_star_input",
    "import_tomo_motion_star_path", "import_tomo_motion_star_input",
    "metric_maskth_input", "metric_maskth_path",
    "model_fit_path", "refine_maskth_input", "refine_maskth_path",
    "refine_model_path", "refine_model_input",
    "refine_parfile_path", "refine_parfile_input",
    "refine_parfile_tomo_path", "refine_parfile_tomo_input",
    "sharpen_cistem_input_map_input", "sharpen_cistem_input_map_path",
    "sharpen_input_map_input", "sharpen_input_map_path",
    "sharpen_mask_input", "sharpen_mask_path", "sharpen_mtf_path",
    "sharpen_relion_first_half_path", "sharpen_relion_mask_path",
    "sharpen_relion_mtf_path", "sharpen_relion_second_half_path",
    "slurm_class2d_queue_input", "slurm_daemon_queue_input",
    "slurm_merge_queue_input", "slurm_queue_gpu_input", "slurm_queue_input",
    "sva_parfile_path", "sva_parfile_input",
    "clean_parfile_path", "clean_parfile_input",
    "mask_model_path", "mask_model_input",
    "tomo_pick_files_path", "import_relion_path_path", "data_path_mdoc_path",
    "tomo_pick_pytom_mask_file_input", "tomo_pick_pytom_mask_file_path",
    "tomo_pick_pytom_template_input", "tomo_pick_pytom_template_path",
    "tomo_srf_detect_ref_path", "tomo_vir_detect_ref_path",
]

# stems with no same-named engine param: route to the engine equivalent
_TWIN_STEM_OVERRIDES = {
    "refine_model": "model_path",
    "refine_parfile": "csp_parfile",
    "refine_parfile_tomo": "csp_parfile_tomo",
    "sva_parfile": "csp_parfile",
    "clean_parfile": "csp_parfile",
    "mask_model": "mask_file",
    "detect_ref": "detect_nn_model",
    "detect_files": "tomo_pick_files",
    "dose_weighting_weights": "dose_weight_weights",
    "tomo_srf_detect_ref": "tomo_pick_ref",
    "tomo_vir_detect_ref": "tomo_pick_ref",
}


def _install_twins():
    for twin in _TWIN_IDS:
        stem = twin[:-len("_path")] if twin.endswith("_path") \
            else twin[:-len("_input")]
        stem = _TWIN_STEM_OVERRIDES.get(stem, stem)
        if stem in REFERENCE_ALIASES:  # resolve alias chains at build time
            REFERENCE_ALIASES[twin] = REFERENCE_ALIASES[stem]
        else:
            REFERENCE_ALIASES[twin] = (stem, None)


_install_twins()


def apply_reference_aliases(params: dict) -> dict:
    """Translate explicitly-set reference-spelled parameters into this
    framework's namespace. A key participates only when its value is not
    None (unset aliases never clobber engine values). Returns a NEW dict."""
    out = dict(params)
    for src, (targets, fn) in REFERENCE_ALIASES.items():
        val = params.get(src)
        if val in (None, ""):
            continue
        if fn is not None:
            val = fn(val)
            if val is None:
                continue
        if isinstance(targets, str):
            targets = (targets,)
        for t in targets:
            out[t] = val
    return out


def apply_block_overrides(params: dict, block: str) -> dict:
    """Translate a block tab's values into the engine namespace. Unset tab
    values (None) leave the engine value alone. Returns a NEW dict."""
    if not block:
        return params
    if block not in BLOCK_FIELDS:
        raise ValueError(
            f"unknown csp block '{block}' (known: {sorted(BLOCK_FIELDS)})")
    out = dict(params)
    switches = dict(micrographs=None, particles=None, ctf=None)
    for field in BLOCK_FIELDS[block]:
        val = params.get(f"{block}_{field}")
        if val in (None, ""):
            continue
        if field in ("refine_micrographs", "refine_particles", "refine_ctf"):
            switches[field.split("_", 1)[1]] = bool(val)
            continue
        # Powell-optimizer units -> gradient-optimizer units: the
        # reference's OptimizerMaxIter counts Powell iterations (default 5,
        # each with internal line searches) where csp_OptimizerIters counts
        # single gradient steps (default 20); OptimizerStepLength is a raw
        # parameter-space step (default 20.0) where csp_OptimizerStepLength
        # is a normalized-gradient factor (default 0.3). Scale so the
        # reference defaults land on the engine defaults and user intent
        # transfers proportionally.
        if field == "OptimizerMaxIter":
            val = int(round(float(val) * 4.0))
        elif field == "OptimizerStepLength":
            val = float(val) * (0.3 / 20.0)
        target = _SHARED_FIELDS[field]
        if target is not None:
            out[target] = val
    forced = _BLOCK_MODES.get(block, {})
    if forced.get("frames"):
        out["csp_frames"] = True
    else:
        sw = {k: (forced.get(k) if forced.get(k) is not None else v)
              for k, v in switches.items()}
        if any(v is not None for v in sw.values()):
            out["csp_refine_modes"] = block_mode_schedule(
                bool(sw["micrographs"]), bool(sw["particles"]),
                bool(sw["ctf"]))
    if block == "csp_tomo_classification" and int(
            out.get("class_num") or 1) > 1:
        # classification blocks default the eulers/shifts passes into the
        # schedule the reference way (refineeulers/refineshifts counts)
        ne = int(out.get("class3d_refineeulers") or 0)
        ns = int(out.get("class3d_refineshifts") or 0)
        out["csp_refine_modes"] = ":".join(
            ["2"] * max(ns, 0) + ["1"] * max(ne, 0)) or "2:1"
    return out
