"""Command-line entry point of the port: the `spr`, `tomo`, `extract`,
`gain`, `refine`, `classify2d`, `classify3d`, `clean`, `kselection`,
`postprocess`, `fsc` and `mask` modes on a CUDA device.

    python -m pyp_tpu_torch.cli spr -data_path 'movies/*.mrc' -scope_pixel 1.0 ...
    python -m pyp_tpu_torch.cli tomo -data_path 'series/*.mrc' -scope_pixel 1.0 ...
    python -m pyp_tpu_torch.cli extract -extract_box 128
    python -m pyp_tpu_torch.cli gain -data_path 'movies/*.mrc'
    python -m pyp_tpu_torch.cli refine -refine_maxiter 4 -refine_goldstandard ...
    python -m pyp_tpu_torch.cli refine -refine_abinit [-abinit_engine classic] ...
    python -m pyp_tpu_torch.cli classify2d -class_num 8 [-class_engine gather]
    python -m pyp_tpu_torch.cli classify3d -class_num 2 -class3d_iters 3 ...
    python -m pyp_tpu_torch.cli clean -clean_particles -clean_mode percentile
    python -m pyp_tpu_torch.cli kselection -keep_classes 1,3
    python -m pyp_tpu_torch.cli postprocess -sharpen_locres ...
    python -m pyp_tpu_torch.cli fsc half1.mrc half2.mrc [-fsc_mask mask.mrc]
    python -m pyp_tpu_torch.cli mask -mask_method auto|sphere|file ...

`spr` preprocesses every movie `-data_path` matches (frame alignment, CTF
estimation, picking) into one `<name>.meta.npz` bundle each, resuming
from the bundles it finds; `tomo` aligns, CTF-fits, reconstructs and
picks every tilt series -data_path matches (MRC stacks with a .tlt or
.rawtlt sidecar, or SerialEM .mdoc files of tilt movies) into a
`<name>.meta.npz` bundle and `<name>.rec.mrc` each; `extract` windows
the picked particles of all bundles into stack.mrc + stack.cistem;
`gain` estimates a gain reference from raw movies. `refine` reads
stack.mrc, stack.cistem and initial_model.mrc (or -model_path) from the
project directory, like `pyp_tpu refine`, and runs the refinement loop
with the engine the parameters name (`-refine_engine frm`, the default, or `gather`); without
an initial model, `-refine_abinit` first builds one by ab initio
(`-abinit_engine frm`, the default, or `classic`) and writes it to
initial_model.mrc. `classify2d` writes classes_2d.mrc and the
best_2d_class column; `classify3d` writes per-class maps under maps/;
`clean -clean_particles` deactivates particles by score, position, class
or tilt (without -clean_particles it removes intermediates);
`kselection` keeps the listed classes or symmetry-expands the table.
Parameters persist in the same project file (.pyp_tpu_config.toml,
written and read by `config.params` in the same format as the JAX
package's). `postprocess` sharpens the newest half maps under maps/
(mask-corrected FSC, Guinier B, optional local resolution); `fsc` writes
<out>.txt (and <out>.png with matplotlib) for map pairs given as
arguments; `mask` writes <dataset>_mask.mrc. Each writes the files the
JAX package's mode writes. Every other mode is not ported yet and exits
non-zero; SLURM submission, the learned picker (`-detect_method nn`), the
micrograph denoiser (`-denoise_spr n2n`), `-prism_enable`, the trained
tomogram denoisers (`-denoise_method n2n|wedge`) and the membrane network
(`-tomo_vir_method nn`) raise NotImplementedError by name.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from pathlib import Path

import numpy as np

from pyp_tpu_torch.config import params as cfg
from pyp_tpu_torch.config.blocks import apply_reference_aliases
from pyp_tpu_torch.utils import get_logger

logger = get_logger("cli")

# the JAX package's modes; PORTED below names the ones the port has
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


def _discover_items(params):
    pattern = params.get("data_path") or ""
    suffix = str(params.get("data_suffix") or "")
    items = []
    for path in sorted(glob.glob(pattern)):
        if suffix and suffix not in Path(path).name:
            continue
        items.append({"name": Path(path).stem, "path": path})
    # separate mdoc glob (reference data_path_mdoc): tomo datasets whose
    # .mdoc files live apart from the frame movies
    mdoc_glob = str(params.get("data_path_mdoc") or "")
    if mdoc_glob:
        have = {i["name"] for i in items}
        for path in sorted(glob.glob(mdoc_glob)):
            name = Path(path).stem.replace(".mrc", "")
            if name not in have:
                items.append({"name": name, "path": path})
    # saved filter selection: keep only items the filter kept
    sel = str(params.get("filter_sel") or "")
    if sel:
        from pyp_tpu_torch.analysis.filters import load_selection

        keep = load_selection(sel, ".",
                              str(params.get("data_set") or "dataset"))
        items = [it for it in items if it["name"] in keep]
    # dataset subsetting (large-project splits): process [first, last)
    first = int(params.get("data_first_item") or 0)
    last = int(params.get("data_last_item") or -1)
    if first or last >= 0:
        items = items[first:(None if last < 0 else last)]
    return items


def mode_spr(argv, device="cuda"):
    """Per-micrograph preprocessing of every movie -data_path matches, as
    a swarm of jobs on the local executor followed by the merge; prints
    the merge summary."""
    params = _project_params(argv)
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.pipeline import spr
    from pyp_tpu_torch.sched import JobGraph, LocalExecutor

    items = _discover_items(params)
    if not items:
        logger.error("no input files match data_path=%r", params.get("data_path"))
        return 1
    # refusals come before any job runs: the executor would record an
    # exception of a job as that job's failure
    if slurm_requested(params):
        raise NotImplementedError(
            "SLURM submission (slurm_queue / slurm_host / slurm_submit) of "
            "spr is not ported; run it on the local executor")
    if params.get("prism_enable"):
        raise NotImplementedError(
            "prism_enable (micrograph quality scoring) is not ported")
    spr.check_ported(params)
    dev = resolve_device(device)

    graph = JobGraph("spr")
    graph.swarm(
        "sprswarm", items,
        work_fn=lambda item: spr.process_micrograph(item, params, device=dev),
        merge_fn=lambda results, missing: spr.spr_merge(results, missing),
        max_retries=int(params.get("slurm_retries") or 2),
        merge_retries=int(params.get("slurm_merge_retries") or 2),
    )
    # intra-node worker pool: with more than one task the micrographs run
    # in threads on the one card
    LocalExecutor(max_workers=int(params.get("slurm_local_tasks") or 0)
                  or int(params.get("slurm_tasks") or 1)).run(graph)
    merge = graph.jobs["sprswarm.merge"]
    print(json.dumps(merge.result, indent=1, default=str))
    return 0 if merge.status == "done" else 1


def mode_tomo(argv, device="cuda"):
    """Per-series tomography (`pipeline/tomo.process_tilt_series`) of every
    item -data_path (or -data_path_mdoc) matches, as a swarm of jobs on the
    local executor followed by the merge; prints the merge summary. An
    .mdoc item's tilt movies are frame-aligned and assembled first; an MRC
    stack takes its angles from a .tlt/.rawtlt sidecar, else
    linspace(-60, 60)."""
    params = _project_params(argv)
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.pipeline import tomo as tomo_pipe
    from pyp_tpu_torch.sched import JobGraph, LocalExecutor

    items = _discover_items(params)
    if not items:
        logger.error("no input files match data_path=%r", params.get("data_path"))
        return 1
    # refusals come before any job runs
    if slurm_requested(params):
        raise NotImplementedError(
            "SLURM submission (slurm_queue / slurm_host / slurm_submit) of "
            "tomo is not ported; run it on the local executor")
    tomo_pipe.check_ported(params)
    dev = resolve_device(device)

    def load_item(item):
        if str(item["path"]).endswith(".mdoc"):
            # raw-movie ingestion: per-tilt frame alignment + assembly
            item.update(tomo_pipe.assemble_tilt_series(item["path"], params,
                                                       device=dev))
            return tomo_pipe.process_tilt_series(item, params, device=dev)
        # pre-assembled stack; tilt angles from a sidecar .tlt/.rawtlt
        for ext in (".tlt", ".rawtlt"):
            tlt = Path(item["path"]).with_suffix(ext)
            if tlt.exists():
                item["angles"] = np.loadtxt(tlt)
                break
        else:
            n = mrc.read_header(item["path"]).nz
            item["angles"] = np.linspace(-60, 60, n)
        return tomo_pipe.process_tilt_series(item, params, device=dev)

    graph = JobGraph("tomo")
    graph.swarm(
        "tomoswarm", items, work_fn=load_item,
        merge_fn=lambda results, missing: tomo_pipe.tomo_merge(results, missing),
    )
    LocalExecutor(max_workers=int(params.get("slurm_local_tasks") or 0)
                  or int(params.get("slurm_tasks") or 1)).run(graph)
    merge = graph.jobs["tomoswarm.merge"]
    print(json.dumps(merge.result, indent=1, default=str))
    return 0 if merge.status == "done" else 1


def mode_extract(argv, device="cuda"):
    params = _project_params(argv)
    from pyp_tpu_torch.pipeline import spr

    names = sorted(
        p.name.replace(".meta.npz", "") for p in Path(".").glob("*.meta.npz")
    )
    stack, table = spr.extract_stack([{"name": n} for n in names], params,
                                     device=device)
    if stack is None:
        logger.error("no picked particles found in project dir")
        return 1
    print(json.dumps({"particles": len(stack), "stack": "stack.mrc"}))
    return 0


def mode_gain(argv, device="cuda"):
    """Estimate a gain reference from raw counting movies (the reference's
    pypgain mode)."""
    params = _project_params(argv)
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.pipeline.spr import estimate_gain

    paths = sorted(glob.glob(params.get("data_path") or ""))
    if not paths:
        logger.error("no input files match data_path=%r", params.get("data_path"))
        return 1
    gain = estimate_gain(paths, max_movies=int(params.get("gain_movies") or 10),
                         device=device)
    out = params.get("gain_reference") or "gain.mrc"
    mrc.write(gain, out)
    print(json.dumps({"gain": out, "shape": list(gain.shape),
                      "movies": min(len(paths), int(params.get("gain_movies") or 10))}))
    return 0


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
        initial = _ab_initio_model(stack, table, params, device)
        mrc.write(initial, "initial_model.mrc",
                  pixel_size=float(params["scope_pixel"]))
    else:
        # featureless sphere initial model (the reference's fallback)
        from pyp_tpu_torch.core.filters import soft_spherical_mask

        initial = soft_spherical_mask(n, n * 0.3, 5.0).numpy()
    dataset = params.get("data_set") or "dataset"
    table, final, history = ref_pipe.refine_loop(
        stack, table, initial, params, dataset=dataset, device=device)
    print(json.dumps({"iterations": history}, default=str))
    return 0


def _ab_initio_model(stack, table, params, device):
    """The initial model from scratch (`-refine_abinit` without an
    initial_model.mrc): `ops.ab_initio.ab_initio_frm` (abinit_engine frm,
    the default) or the classic subset engine `ab_initio`."""
    from pyp_tpu_torch.ops import ab_initio as abi
    from pyp_tpu_torch.pipeline.refine import table_to_ctf_params

    logger.info("no initial_model.mrc: running marginalized ab initio")
    common = dict(
        symmetry=str(params["particle_sym"]),
        n_rounds=int(params.get("abinit_rounds") or 10),
        start_res=float(params.get("abinit_start_res") or 40.0),
        end_res=float(params.get("abinit_end_res") or 12.0),
        angular_step=float(params.get("abinit_angular_step") or 15.0),
        seed=int(params.get("abinit_seed") or 0),
        voltage_kv=float(params["scope_voltage"]),
        cs_mm=float(params["scope_cs"]),
        amplitude_contrast=float(params["scope_wgh"]),
        device=device)
    ctf = table_to_ctf_params(table)
    pixel = float(params["scope_pixel"])
    if str(params.get("abinit_engine") or "frm") == "classic":
        initial, _poses = abi.ab_initio(
            stack, ctf, pixel,
            subset_frac=float(params.get("abinit_subset_frac") or 0.5),
            anneal=float(params.get("abinit_anneal") or 0.0), **common)
    else:
        initial, _poses = abi.ab_initio_frm(
            stack, ctf, pixel,
            top_t=int(params.get("abinit_top_t") or 8),
            beta0=float(params.get("abinit_beta0") or 20.0),
            beta_growth=float(params.get("abinit_beta_growth") or 1.4),
            hard_rounds=int(params.get("abinit_hard_rounds") or 3),
            polish_rounds=int(params.get("abinit_polish_rounds") or 2),
            soft_shifts=str(params.get("abinit_soft_shifts") or "zero"),
            seed_particles=int(params.get("abinit_random_particles") or 8),
            random_skip_ratio=float(
                params.get("abinit_random_skip_ratio") or 0.0),
            **common)
    return initial


def mode_classify2d(argv, device="cuda"):
    """2D classification of stack.mrc (`classify2d`, or the staged
    protocol with -class2d_staged): writes classes_2d.mrc and the
    best_2d_class column of stack.cistem."""
    params = _project_params(argv)
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.ops import refine2d
    from pyp_tpu_torch.pipeline.refine import _np, table_to_ctf_params

    stack = mrc.read("stack.mrc").astype(np.float32)
    table = cistem.read_parameters("stack.cistem")
    scope = dict(voltage_kv=float(params["scope_voltage"]),
                 cs_mm=float(params["scope_cs"]),
                 amplitude_contrast=float(params["scope_wgh"]),
                 device=device)
    if params.get("class2d_staged"):
        res = refine2d.classify2d_staged(
            stack, table_to_ctf_params(table), params,
            float(params["scope_pixel"]), **scope)
    else:
        res = refine2d.classify2d(
            stack, table_to_ctf_params(table),
            int(params.get("class_num") or 10),
            float(params["scope_pixel"]),
            iters=int(params.get("class_2d_iters") or 10),
            high_res=float(params.get("class_rhcls") or 10.0),
            low_res=float(params.get("class_rlcls") or 100.0),
            shift_extent=float(params.get("class_shift") or 5.0),
            shift_step=float(params.get("class_shift_step") or 2.0),
            psi_step=float(params.get("class_psi_step") or 15.0),
            seed=int(params.get("class_seed") or 0),
            engine=str(params.get("class_engine") or "polar"),
            wiener=float(params.get("class_wiener") or 10.0), **scope)
    mrc.write(_np(res.class_avgs), "classes_2d.mrc",
              pixel_size=float(params["scope_pixel"]))
    table["best_2d_class"] = _np(res.assignments) + 1
    cistem.write_parameters(table, "stack.cistem")
    print(json.dumps({
        "classes": int(res.class_avgs.shape[0]),
        "occupancy": _np(res.occupancy).tolist(),
    }))
    return 0


def mode_classify3d(argv, device="cuda"):
    """K-class 3D classification of stack.mrc from initial_model.mrc (or
    a featureless sphere) and the table's poses; writes the per-class
    maps under maps/ and the classes into stack.cistem."""
    params = _project_params(argv)
    from pyp_tpu_torch.core.filters import soft_spherical_mask
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.pipeline import classify3d as c3d

    stack = mrc.read("stack.mrc").astype(np.float32)
    table = cistem.read_parameters("stack.cistem")
    init_path = Path("initial_model.mrc")
    if init_path.exists():
        initial = mrc.read(init_path).astype(np.float32)
    else:
        n = stack.shape[-1]
        initial = soft_spherical_mask(n, n * 0.3, 5.0).numpy()
    dataset = params.get("data_set") or "dataset"
    table, refs, occ, history = c3d.classify3d_loop(
        stack, table, initial, params, dataset=dataset, device=device)
    cistem.write_parameters(table, "stack.cistem")
    print(json.dumps({"iterations": history}, default=str))
    return 0


def _clean_particles(params, device):
    """The particle-cleaning branch of `clean` (-clean_particles):
    deactivate particles by score rule (otsu, fixed, percentile, shape),
    position duplicates, class selection, tilt window and projection
    count; optionally drop them, export their coordinates, write cluster
    stacks and a check reconstruction."""
    from pyp_tpu_torch.analysis import scores as sc
    from pyp_tpu_torch.io import cistem, mrc

    table = cistem.read_parameters("stack.cistem")
    mode_rule = str(params.get("clean_mode") or "otsu")
    if params.get("clean_spr_auto"):
        # automatic bimodal threshold wins over any fixed/percentile rule
        mode_rule = "otsu"
    if mode_rule == "shape":
        # group-local score shaping: percentile cutoffs inside each
        # (view, defocus) group
        table, keep = sc.shape_scores(
            table,
            n_angles=int(params.get("clean_shape_angles") or 25),
            n_defocuses=int(params.get("clean_shape_defocuses") or 25),
            threshold=1.0 - float(
                params.get("clean_percentile") or 20.0) / 100.0)
    else:
        cut = None
        if mode_rule == "fixed":
            cut = float(params.get("clean_min_score") or 0.0)
        elif mode_rule == "percentile":
            cut = float(np.percentile(
                np.asarray(table["score"]),
                float(params.get("clean_percentile") or 20.0)))
        if cut is None:
            cut = float(sc.score_threshold(
                np.asarray(table["score"], dtype=np.float64), "otsu"))
        table, keep = sc.particle_cleaning(
            table, score_cut=cut,
            min_occ=float(params.get("clean_min_occ") or 0.0))
    if params.get("plot_per_item", True) and "score" in table:
        try:
            from pyp_tpu_torch.analysis.plots import histogram_particle_scores

            histogram_particle_scores(
                np.asarray(table["score"]),
                cut if mode_rule != "shape" else float(np.min(
                    np.asarray(table["score"])[keep])) if keep.any()
                else 0.0,
                "clean_scores.png", title=f"clean ({mode_rule})")
        except (ImportError, OSError, ValueError) as e:
            logger.warning("clean score plot skipped: %s", e)
    dist = float(params.get("clean_dist") or 0.0)
    if dist > 0 and "original_x_position" in table:
        pos = np.stack([np.asarray(table["original_y_position"]),
                        np.asarray(table["original_x_position"])], 1)
        keep_d = sc.remove_duplicates(pos, np.asarray(table["score"]), dist)
        act = np.asarray(table["image_is_active"]).astype(bool) & keep_d
        table["image_is_active"] = act.astype(np.int64)
        keep = keep & keep_d
    # class selection: keep only particles of the listed 3D classes. As
    # in the JAX package it reads the reference_3d column, which
    # classify3d does not write (it writes best_2d_class)
    cls_sel = str(params.get("clean_class_selection") or "").strip()
    if cls_sel and "reference_3d" in table:
        wanted = {int(c) for c in cls_sel.replace(":", ",").split(",")
                  if c != ""}
        keep &= np.isin(np.asarray(table["reference_3d"]).astype(int),
                        sorted(wanted))
        if not params.get("clean_class_merge_alignment", True):
            logger.warning(
                "clean_class_merge_alignment=False requested: per-class "
                "alignments are already per-particle here; selection keeps "
                "each particle's own parameters either way")
    # tilt-angle window: projections outside it deactivate
    min_tilt = float(params.get("clean_mintilt") if params.get(
        "clean_mintilt") not in (None, "") else -90.0)
    max_tilt = float(params.get("clean_maxtilt") if params.get(
        "clean_maxtilt") not in (None, "") else 90.0)
    if (min_tilt > -90.0 or max_tilt < 90.0) and "tilt_angle" in table:
        ta = np.asarray(table["tilt_angle"], dtype=np.float64)
        keep &= (ta >= min_tilt) & (ta <= max_tilt)
    # particles left with too few active projections drop entirely
    min_proj = int(params.get("clean_min_num_projections") or 1)
    if min_proj > 1 and "particle_index" in table:
        keep &= sc.min_projections_keep(table["particle_index"], keep,
                                        min_proj)
    if "image_is_active" in table:
        table["image_is_active"] = keep.astype(np.int64)
    if "occupancy" in table:
        occ = np.asarray(table["occupancy"]).copy()
        occ[~keep] = 0.0
        table["occupancy"] = occ
    if params.get("clean_discard"):
        # permanent removal; the default keeps rows at occupancy 0
        table = table.select(keep)
    cistem.write_parameters(table, "stack.cistem")
    if params.get("clean_export_clean") and "original_x_position" in table:
        # cleaned coordinates for re-extraction
        sel_dir = Path("frealign/selected_particles")
        sel_dir.mkdir(parents=True, exist_ok=True)
        act = (np.asarray(table["image_is_active"]).astype(bool)
               if "image_is_active" in table
               else np.ones(table.n_rows, dtype=bool))
        cols = [np.asarray(table["original_x_position"])[act],
                np.asarray(table["original_y_position"])[act]]
        if "original_z_position" in table:
            cols.append(np.asarray(table["original_z_position"])[act])
        np.savetxt(sel_dir / "clean.spk", np.stack(cols, axis=1), fmt="%.2f")
    if params.get("clean_cluster_stacks") and Path("stack.mrc").exists():
        # per-(view, defocus) group stacks for visual inspection
        imgs_c = mrc.read("stack.mrc")
        if imgs_c.shape[0] != table.n_rows and imgs_c.shape[0] == len(keep):
            imgs_c = imgs_c[keep]    # clean_discard dropped rows
        sc.generate_cluster_stacks(
            imgs_c, table,
            n_angles=int(params.get("clean_shape_angles") or 25),
            n_defocuses=int(params.get("clean_shape_defocuses") or 25),
            out_dir="clusters", base="stack")
    if params.get("clean_check_reconstruction") and Path("stack.mrc").exists():
        # sanity reconstruction from the cleaned table
        from pyp_tpu_torch.ops import reconstruct as rec
        from pyp_tpu_torch.pipeline.refine import (_np, table_to_ctf_params,
                                                   table_to_poses)

        imgs = mrc.read("stack.mrc")
        if params.get("clean_discard"):
            imgs = imgs[keep]    # table rows were dropped
        pixel = (float(table["pixel_size"][0]) if "pixel_size" in table
                 else float(params.get("scope_pixel") or 1.0))
        wts = (np.asarray(table["occupancy"], np.float32) / 100.0
               if "occupancy" in table else keep.astype(np.float32))
        out = rec.reconstruct(
            np.asarray(imgs, np.float32), table_to_poses(table, pixel),
            table_to_ctf_params(table), pixel,
            subset=(np.arange(table.n_rows) % 2).astype(np.int32),
            weights=wts, symmetry=str(params.get("particle_sym") or "C1"),
            voltage_kv=float(params.get("scope_voltage") or 300.0),
            cs_mm=float(params.get("scope_cs") or 2.7),
            amplitude_contrast=float(params.get("scope_wgh") or 0.07),
            device=device)
        Path("maps").mkdir(exist_ok=True)
        mrc.write(_np(out.volume).astype(np.float32), "maps/clean_check.mrc",
                  pixel_size=pixel)
    print(json.dumps({"kept": int(keep.sum()), "total": int(len(keep))}))
    return 0


def mode_clean(argv, device="cuda"):
    """With -clean_particles, particle cleaning (`_clean_particles`);
    otherwise removal of regenerable intermediates: swarm scripts, stream
    stacks, and with -clean_all also metadata bundles and maps/."""
    import shutil

    params = _project_params(argv, persist=False)
    if params.get("clean_particles"):
        return _clean_particles(params, device)
    deep = "-clean_all" in argv
    removed = []
    for pattern in ["swarm", "stream_stack.mrc", "stream_classes.png"]:
        p = Path(pattern)
        if p.is_dir():
            shutil.rmtree(p)
            removed.append(str(p) + "/")
        elif p.exists():
            p.unlink()
            removed.append(str(p))
    if deep:
        for p in (list(Path(".").glob("*.meta.npz"))
                  + list(Path(".").glob("*.meta.json"))):
            p.unlink()
            removed.append(str(p))
        if Path("maps").is_dir():
            shutil.rmtree("maps")
            removed.append("maps/")
    usage = shutil.disk_usage(".")
    print(json.dumps({"removed": removed, "deep": deep,
                      "free_gb": round(usage.free / 2**30, 1)}))
    return 0


def mode_kselection(argv, device="cuda"):
    """Keep only particles of the given classes (-keep_classes 1,3,5), or
    with -expand_symmetry <group> symmetry-expand the particle table. Host
    only: `device` is accepted for the common signature."""
    params = _project_params(argv)
    from pyp_tpu_torch.analysis.scores import expand_symmetry, select_classes
    from pyp_tpu_torch.io import cistem

    sym = str(params.get("expand_symmetry") or "")
    if sym:
        table = cistem.read_parameters("stack.cistem")
        out = expand_symmetry(table, sym)
        cistem.write_parameters(out, "stack.cistem")
        print(json.dumps({"expanded": out.n_rows, "from": table.n_rows,
                          "symmetry": sym}))
        return 0
    spec = str(params.get("keep_classes") or "")
    if not spec:
        logger.error("kselection needs -keep_classes <comma list>")
        return 1
    keep = {int(tok) for tok in spec.replace(",", " ").split()}
    table = cistem.read_parameters("stack.cistem")
    table, mask = select_classes(table, keep)
    cistem.write_parameters(table, "stack.cistem")
    print(json.dumps({"kept": int(mask.sum()), "total": int(len(mask)),
                      "classes": sorted(keep)}))
    return 0


def mode_postprocess(argv, device="cuda"):
    params = _project_params(argv)
    from pyp_tpu_torch.postprocess import core as post

    dataset = params.get("data_set") or "dataset"
    out = post.postprocess_latest(dataset, params, device=device)
    print(json.dumps(out, default=str))
    return 0


def mode_fsc(argv, device="cuda"):
    """FSC between consecutive map pairs given as positionals, with the
    mask-corrected FSC where -fsc_mask names a mask; resolutions at 0.5
    and 0.143; <out>.txt and, with matplotlib, <out>.png
    (-fsc_out, default "fsc")."""
    from pyp_tpu_torch import as_f32, resolve_device
    from pyp_tpu_torch.core import fsc as fsc_mod
    from pyp_tpu_torch.io import mrc

    dev = resolve_device(device)
    maps, rest, prev_flag = [], [], False
    for a in argv:
        if (not prev_flag and not a.startswith("-")
                and (a.endswith(".mrc") or a.endswith(".rec"))):
            maps.append(a)           # positional map; flag values stay put
        else:
            rest.append(a)
            prev_flag = a.startswith("-")
            continue
        prev_flag = False
    params = _project_params(rest, persist=False)
    if len(maps) < 2 or len(maps) % 2 != 0:
        print("usage: pyp_tpu fsc half1.mrc half2.mrc [h1b.mrc h2b.mrc ...] "
              "[-fsc_mask mask.mrc] [-fsc_out fsc]")
        return 1
    mask = (as_f32(mrc.read(str(params["fsc_mask"])), dev)
            if params.get("fsc_mask") else None)
    out_base = str(params.get("fsc_out") or "fsc")
    curves, labels, results, freqs, pixel = [], [], [], None, 0.0
    for i in range(0, len(maps), 2):
        h1 = as_f32(mrc.read(maps[i]), dev)
        h2 = as_f32(mrc.read(maps[i + 1]), dev)
        pixel = float(mrc.read_header(maps[i]).pixel_size) or float(
            params.get("scope_pixel") or 1.0)
        if mask is not None:
            from pyp_tpu_torch.postprocess.core import masked_fsc

            freqs, curve = masked_fsc(h1, h2, mask, pixel)
        else:
            freqs, curve = fsc_mod.fsc(h1, h2)
        freqs = freqs.cpu().numpy()
        curves.append(curve.cpu().numpy())
        label = f"{Path(maps[i]).stem} vs {Path(maps[i + 1]).stem}"
        labels.append(label)
        results.append({
            "pair": label,
            "res_0.5_A": float(fsc_mod.resolution_at_threshold(
                freqs, curves[-1], pixel, 0.5)),
            "res_0.143_A": float(fsc_mod.resolution_at_threshold(
                freqs, curves[-1], pixel, 0.143)),
        })
    np.savetxt(out_base + ".txt", np.stack([freqs] + curves, axis=1),
               header="freq_cyc_per_px " + " ".join(
                   lb.replace(" ", "_") for lb in labels))
    try:
        from pyp_tpu_torch.analysis import plots

        plots.plot_fsc(freqs, curves, pixel, out_base + ".png", labels=labels)
    except (ImportError, OSError, ValueError) as e:
        logger.warning("FSC plot skipped: %s", e)
    print(json.dumps({"pairs": results, "masked": mask is not None,
                      "out": out_base}))
    return 0


def mode_mask(argv, device="cuda"):
    """A 3D mask from the newest maps/ half-map pair (or -model_path):
    sphere, file or auto (-mask_method), optionally inverted, normalized
    and floored (-mask_outside_weight); writes <dataset>_mask.mrc."""
    params = _project_params(argv)
    from pyp_tpu_torch import as_f32, resolve_device
    from pyp_tpu_torch.core.filters import soft_spherical_mask
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.postprocess.core import auto_mask

    dev = resolve_device(device)
    src = Path(params.get("model_path") or "")
    if params.get("model_path") and not src.is_file():
        logger.error("mask: -model_path %s is not a file", src)
        return 1
    if not params.get("model_path"):
        maps = sorted(Path("maps").glob("*_half1.mrc"))
        if not maps:
            logger.error("mask: no -model_path and no maps/*_half1.mrc")
            return 1
        h1 = mrc.read(maps[-1]).astype(np.float32)
        h2 = mrc.read(str(maps[-1]).replace("half1", "half2")).astype(np.float32)
        vol, pixel = h1 + h2, mrc.read_header(maps[-1]).pixel_size
    else:
        vol = mrc.read(src).astype(np.float32)
        pixel = mrc.read_header(src).pixel_size
    method = str(params.get("mask_method") or "auto")
    n = vol.shape[-1]
    if method == "sphere":
        rad_px = float(params.get("mask_radius") or 0.0) / pixel or n * 0.4
        mask = soft_spherical_mask(
            n, rad_px, float(params.get("mask_edge_width") or 5.0),
            device=dev).cpu().numpy()
    elif method == "file":
        mask = mrc.read(params["mask_file"]).astype(np.float32)
    else:
        mask = auto_mask(
            as_f32(vol, dev), pixel_size=pixel,
            lowpass_a=float(params.get("mask_lowpass") or 15.0),
            threshold_sigmas=float(params.get("mask_threshold") or 1.0),
            dilation_px=int(params.get("mask_dilation") or 3),
            soft_px=int(params.get("mask_edge_width") or 6),
            mw_kda=float(params.get("mask_mw")
                         or params.get("particle_mw") or 0.0)).cpu().numpy()
    if params.get("mask_invert"):
        mask = 1.0 - mask
    if params.get("mask_normalized"):
        # stretch to the full [0, 1] range
        lo, hi = float(mask.min()), float(mask.max())
        mask = (mask - lo) / max(hi - lo, 1e-9)
    ow = float(params.get("mask_outside_weight") or 0.0)
    if ow > 0:
        # keep a fraction of the outside density: m' = w + (1-w) m
        mask = ow + (1.0 - ow) * mask
    out = f"{params.get('data_set') or 'dataset'}_mask.mrc"
    mrc.write(mask.astype(np.float32), out, pixel_size=pixel)
    print(json.dumps({"mask": out, "coverage":
                      round(float((mask > 0.5).mean()), 4)}))
    return 0


PORTED = {"spr": mode_spr, "tomo": mode_tomo, "extract": mode_extract,
          "gain": mode_gain,
          "refine": mode_refine, "classify2d": mode_classify2d,
          "classify3d": mode_classify3d, "clean": mode_clean,
          "kselection": mode_kselection, "postprocess": mode_postprocess,
          "fsc": mode_fsc, "mask": mode_mask}


def main(argv=None, device="cuda"):
    """Entry point: `main([mode, ...], device=...)` for the ported modes
    (spr, tomo, extract, gain, refine, classify2d, classify3d, clean,
    kselection, postprocess, fsc, mask). Returns the exit code; other
    modes are not yet ported and return 2."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    mode, rest = argv[0], argv[1:]
    if mode in PORTED:
        return PORTED[mode](rest, device=device)
    if mode in MODES:
        logger.error("mode %r is not yet ported to pyp_tpu_torch", mode)
    else:
        logger.error("unknown mode %r", mode)
    return 2


if __name__ == "__main__":
    sys.exit(main())
