"""Command-line entry point of the port: every mode of the JAX package
(cli.PORTED == cli.MODES), the ones with device work on a CUDA device.

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
    python -m pyp_tpu_torch.cli csp -data_path 'series/*.mrc' -csp_box 64 ...
    python -m pyp_tpu_torch.cli polish -data_path 'movies/*.mrc' ...
    python -m pyp_tpu_torch.cli sva -sva_box 48 [-sva_ref ref.mrc] ...
    python -m pyp_tpu_torch.cli sprtrain -train_steps 300 ...
    python -m pyp_tpu_torch.cli tomotrain -tomo_spk_rad 100 ...
    python -m pyp_tpu_torch.cli mine -mine_clusters 8 ...
    python -m pyp_tpu_torch.cli prism -prism_steps 300 ...
    python -m pyp_tpu_torch.cli heterogeneity [-het_eval] ...
    python -m pyp_tpu_torch.cli stream -data_path 'watch/*.mrc' [-class2d_enable] ...
    python -m pyp_tpu_torch.cli workflow workflows/spa_tutorial.toml -data_path ...
    python -m pyp_tpu_torch.cli import_star particles.star
    python -m pyp_tpu_torch.cli export_star [-data_mode tomo]
    python -m pyp_tpu_torch.cli export_session
    python -m pyp_tpu_torch.cli filter -filter_criteria "ctf_res<8" -filter_name good
    python -m pyp_tpu_torch.cli report
    python -m pyp_tpu_torch.cli byp picks.mod|mic.box|particles.star|stack.cistem ...
    python -m pyp_tpu_torch.cli boxedit -edit_name mic -edit_remove_circle y:x:r
    python -m pyp_tpu_torch.cli tomoedit -edit_name ts -edit_exclude_tilts 0:40
    python -m pyp_tpu_torch.cli params
    python -m pyp_tpu_torch.cli worker swarm/spr_00000.json

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
arguments; `mask` writes <dataset>_mask.mrc. `csp` refines the tilt
geometry and particle poses of every `tomo` bundle with picks against
initial_model.mrc (or -csp_reference_model) and writes the subtomogram
average's maps under maps/, the refined xf/tlt/csp_scores into the
bundles and an ArtiaX star per series; `polish` refines per-particle
frame trajectories of the SPA movies against the newest map and rewrites
stack.mrc; `sva` aligns and averages subvolumes at the 3D picks of every
*.rec.mrc. `sprtrain` trains the learned picker on the project's picks
(picker_model.npz, which `spr -detect_method nn` reads) and `tomotrain`
on the tomograms' .spk picks (picker_model_tomo.npz); `mine` clusters a
contrastive embedding of every tomogram's dense grid (<name>_clusterKK.spk
and mine_gallery.json); `prism` scores every micrograph's typicality into
its bundle (prism_score, prism_embeddings.npz; `spr -prism_enable` runs
it after the merge); `heterogeneity` trains the latent model on stack.mrc
at its refined poses, or on the tilt stacks `csp -csp_save_stacks`
writes, and decodes volumes along a principal direction (het_model.npz,
heterogeneity_latents.npz, het_volume_XX.mrc). `stream` runs the
session daemon (`stream/daemon`): it watches -data_path, preprocesses
each new movie as `spr` does, re-classifies the accumulated particles in
2D, and obeys the pypd.stop/restart/clear flag files; `workflow` runs a
.toml block sequence through these modes (`sched/workflow`). The host
modes do no device work: `import_star` / `export_star` carry RELION
particle, tomogram and motion stars in and out of the project,
`export_session` writes a session's RELION micrographs and autopick stars,
`filter` saves a selection of items by metric criteria, `report` writes
<dataset>_report.html, `byp` converts box, model, star, cbox, HDF and
.cistem files, `boxedit` and `tomoedit` edit a bundle's picks and tilts,
and `params` prints the project's parameters. Each writes the files the
JAX package's mode writes.

SLURM: with -slurm_queue, -slurm_host or -slurm_submit, `spr`, `tomo` and
`csp` write (and with -slurm_submit submit) a swarm array of one element
per item plus a dependent merge, `sprtrain`, `tomotrain` and `stream` one
job, and `refine` a distributed script over -slurm_nodes nodes, one rank
per card (`sched/bridge`), the JAX package's scripts; `worker` runs one
element's payload. `polish` and `sva` ignore the SLURM parameters and run
here, as in the JAX package. A process the scheduler started with
PYP_TPU_COORDINATOR set joins its torch.distributed group first
(`parallel.init_distributed`): `refine` and `csp` then split their work
over the group's ranks, and rank 0 alone writes the project files.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from pathlib import Path

import numpy as np

from pyp_tpu_torch import parallel
from pyp_tpu_torch.config import params as cfg
from pyp_tpu_torch.config.blocks import apply_reference_aliases
from pyp_tpu_torch.sched.bridge import slurm_requested  # noqa: F401
from pyp_tpu_torch.utils import Timer, get_logger

logger = get_logger("cli")

# the JAX package's modes; PORTED below maps each to the port's function
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
    if persist and parallel.distributed():
        # rank 0 alone writes the project file; the others read the same
        # parameters once it is written
        if parallel.is_writer():
            params = cfg.update_parameters(work_dir, explicit)
        parallel.barrier()
        persist = parallel.is_writer()
        if persist:
            return apply_reference_aliases(params)
    if not persist:
        saved = {**defaults, **(cfg.load_parameters(work_dir) or {})}
        saved.update(explicit)
        return apply_reference_aliases(saved)
    # aliases land AFTER persistence, so the project file keeps the user's
    # spelling
    return apply_reference_aliases(cfg.update_parameters(work_dir, explicit))


def _maybe_slurm_swarm(mode, argv, params, items):
    """Route per-item modes through SLURM when -slurm_* selects it:
    emit/submit the array + dependent merge and return its report (the
    merge element re-runs the mode, whose resume-aware stages reduce)."""
    from pyp_tpu_torch.sched import bridge

    if not bridge.slurm_requested(params):
        return None
    report = bridge.submit_swarm(mode, items, params, argv)
    print(json.dumps(report, indent=1))
    return 0


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
    rc = _maybe_slurm_swarm("spr", argv, params, items)
    if rc is not None:
        return rc
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
    if merge.status == "done" and params.get("prism_enable"):
        # prism tab enable card: quality assessment runs as part of
        # preprocessing (scores land in metadata for the filter mode)
        logger.info("prism_enable: scoring micrograph quality")
        mode_prism([], device=dev)
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
    rc = _maybe_slurm_swarm("tomo", argv, params, items)
    if rc is not None:
        return rc
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
    from pyp_tpu_torch.sched import bridge

    if bridge.slurm_requested(params):
        # multi-node refinement: one sbatch, slurm_nodes nodes of one rank
        # per card joined into a torch.distributed group through
        # PYP_TPU_COORDINATOR / NUM_PROCS / PROC_ID / LOCAL_RANK
        script = bridge.write_distributed_refine_script(
            params, int(params.get("slurm_nodes") or 1), "refine",
            bridge.strip_slurm_flags(argv))
        ex = bridge.select_executor(params)[1]
        jid = ex.sbatch(script)
        print(json.dumps({"script": str(script), "job_id": jid}))
        return 0
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.pipeline import refine as ref_pipe

    stack = mrc.read("stack.mrc").astype(np.float32)
    table = cistem.read_parameters("stack.cistem")
    n = stack.shape[-1]
    model_path = Path(params.get("model_path") or "initial_model.mrc")
    init_path = model_path if model_path.exists() else Path("initial_model.mrc")
    if init_path.exists():
        initial = mrc.read(init_path).astype(np.float32)
    elif params.get("refine_abinit") and not params.get("abinit_skip"):
        initial = _ab_initio_model(stack, table, params, device)
        if parallel.is_writer():
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


def _csp_load_item(item, params):
    """Load one tilt-series' data + picks for a CSP pass. Returns (item2
    dict, meta, params-with-spin-default, nz) or None if the series has no
    usable metadata/picks. The picks are scaled by the bundle's binning and
    centred on tomo_rec_thickness (the port's tomogram has exactly that
    many unbinned slices); random start eulers are seeded from a stable
    hash of the series name."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.pipeline.csp import stable_seed

    meta = ItemMetadata(item["name"], ".", mode="tomo").load()
    if not (meta.exists() and "box" in meta and "tlt" in meta):
        logger.warning("skipping %s: no tomo metadata/picks", item["name"])
        return None
    tilts = mrc.read(item["path"]).astype(np.float32)
    binning = float(meta.scalars.get("binning", 1.0))
    picks = meta["box"][:, :3] * binning  # unbinned voxel coords (z, y, x)
    nz = float(params.get("tomo_rec_thickness") or tilts.shape[-1])
    center = np.array([nz / 2, tilts.shape[-2] / 2, tilts.shape[-1] / 2])
    coords = picks - center
    pf = str(params.get("csp_parfile") or "")
    ext_eulers = None
    if pf:
        # external parameter-table initialization (csp block `parfile`):
        # per-series <dir>/<name>.cistem or a single table file
        from pyp_tpu_torch.io import cistem

        cand = Path(pf)
        if cand.is_dir():
            cand = cand / f"{item['name']}.cistem"
        if cand.exists():
            t = cistem.read_parameters(cand)
            if t.n_rows == len(coords):
                ext_eulers = np.stack(
                    [t["phi"], t["theta"], t["psi"]], 1).astype(np.float32)
            else:
                logger.warning(
                    "csp_parfile %s: %d rows vs %d picks — ignored",
                    cand, t.n_rows, len(coords))
    if ext_eulers is not None:
        eulers = ext_eulers
    elif "spk_eulers" in meta and len(meta["spk_eulers"]) == len(coords):
        # surface-normal orientation priors: the spin about the spike axis
        # is free, so the spin ring runs unless a step was set
        eulers = np.asarray(meta["spk_eulers"], dtype=np.float32)
        if not float(params.get("csp_spin_search") or 0.0):
            params = {**params, "csp_spin_search": 15.0}
    elif params.get("tomo_pick_rand", True):
        rng = np.random.RandomState(stable_seed(item["name"]))
        eulers = rng.uniform(0, 360, (len(coords), 3)).astype(np.float32)
    else:
        # deterministic zero-euler start: the searches do the work
        eulers = np.zeros((len(coords), 3), dtype=np.float32)
    item2 = {"name": item["name"], "tilts": tilts, "coords": coords,
             "eulers": eulers, "angles": meta["tlt"]}
    return item2, meta, params, nz


def _csp_post_series(name, tilts, refined, meta, params, nz, device):
    """Post-refinement per-series exports (the ArtiaX star, tilt stacks)."""
    from pyp_tpu_torch.io.metadata import ItemMetadata

    if params.get("export_artiax", True):
        # per-series "ministar" for ChimeraX/ArtiaX mapped-back display
        from pyp_tpu_torch.io.relion_tomo import export_artiax_star

        meta2 = ItemMetadata(name, ".", mode="tomo").load()
        tb = max(1, int(params.get("tomo_rec_binning") or 8))
        rec_shape = (int(nz) // tb, tilts.shape[-2] // tb,
                     tilts.shape[-1] // tb)
        export_artiax_star(
            name, refined.particle_pos.cpu().numpy(),
            refined.particle_eulers.cpu().numpy(), rec_shape, tb,
            Path("artiax") / f"{name}_K1.star",
            scores=(meta2["csp_scores"] if "csp_scores" in meta2 else None))
    if params.get("csp_save_stacks"):
        _export_tilt_stacks(name, tilts, refined, meta, params, device)


def _csp_one_series(item, params, ref, device):
    """cspswarm element: one tilt-series refinement + accumulator dump to
    disk (the per-series csp job whose dumps cspmerge sums)."""
    from pyp_tpu_torch.ops.reconstruct import save_accumulators
    from pyp_tpu_torch.pipeline import csp as csp_pipe

    dump = Path("swarm") / f"{item['name']}.acc.npz"
    if params.get("csp_resume") and dump.exists():
        # stage-level idempotency: a series whose dump survives is not
        # refined again
        logger.info("csp %s: resume — reusing %s", item["name"], dump)
        return {"name": item["name"], "dump": str(dump), "resumed": True}
    loaded = _csp_load_item(item, params)
    if loaded is None:
        return None
    item2, meta, params, nz = loaded
    refined, acc, scores = csp_pipe.csp_swarm_one(item2, params, ref, ".",
                                                  device=device)
    if parallel.is_writer():
        dump.parent.mkdir(exist_ok=True)
        save_accumulators(acc, dump)
        _csp_post_series(item["name"], item2["tilts"], refined, meta, params,
                         nz, device)
    logger.info("csp %s: scores %s", item["name"],
                [round(s, 3) for s in scores])
    return {"name": item["name"], "dump": str(dump),
            "particles": int(len(item2["coords"]))}


def _csp_series_batch(group, params, ref, device):
    """cspswarm bundle: a batch of tilt-series refined together
    (pipeline.csp.csp_swarm_batch) with their accumulators chained into
    one dump."""
    from pyp_tpu_torch.ops.reconstruct import save_accumulators
    from pyp_tpu_torch.pipeline import csp as csp_pipe

    loaded = [(_csp_load_item(it, params), it) for it in group]
    usable = [(l, it) for l, it in loaded if l is not None]
    if not usable:
        return None
    items2 = [l[0] for l, _ in usable]
    # spin default: any series with orientation priors turns the ring on
    # for the whole batch (one schedule per batch)
    batch_params = params
    for l, _ in usable:
        if l[2] is not params:
            batch_params = l[2]
            break
    refined_list, acc, scores_list, _pscores = csp_pipe.csp_swarm_batch(
        items2, batch_params, ref, ".", device=device)
    first = usable[0][1]["name"]
    dump = Path("swarm") / f"{first}.batch.acc.npz"
    if parallel.is_writer():
        dump.parent.mkdir(exist_ok=True)
        save_accumulators(acc, dump)
    total = 0
    for (l, it), refined, scores in zip(usable, refined_list, scores_list):
        item2, meta, _p2, nz = l
        if parallel.is_writer():
            _csp_post_series(it["name"], item2["tilts"], refined, meta,
                             batch_params, nz, device)
        logger.info("csp %s: scores %s", it["name"],
                    [round(s, 3) for s in scores])
        total += len(item2["coords"])
    return {"name": first, "dump": str(dump), "particles": int(total),
            "series": [it["name"] for _, it in usable]}


def _export_tilt_stacks(name, tilts, refined, meta, params, device):
    """Window every particle in every tilt at the refined geometry and save
    (stacks, poses, ctf, weights) for tilt-aware heterogeneity training
    (stacks/<name>_stack.npz)."""
    from pyp_tpu_torch import as_f32
    from pyp_tpu_torch.core.geometry import matrix_to_euler
    from pyp_tpu_torch.ops import csp as csp_ops

    T, ny, nx = tilts.shape
    box = int(params.get("csp_box") or 64)
    pixel = float(params["scope_pixel"])
    pred = csp_ops.project_positions(refined).cpu().numpy()     # (T, P, 2)
    depth = csp_ops.particle_depth(refined).cpu().numpy()       # (T, P)
    P = pred.shape[1]
    center = np.array([ny // 2, nx // 2])
    defocus = (np.asarray(meta["ctf"][:, :2], dtype=np.float32)
               if "ctf" in meta else np.full((T, 2), 20000.0, np.float32))
    ci = np.round(pred + center).astype(np.int32)
    stacks = csp_ops.cut_windows(as_f32(tilts, refined.tilt_angles.device),
                                 ci, box).transpose(0, 1).cpu().numpy()
    phi, theta, psi = matrix_to_euler(csp_ops.effective_rotations(refined))
    eulers = np.stack([a.cpu().numpy() for a in (phi, theta, psi)],
                      -1)                                         # (T, P, 3)
    # effective window centre exactly as the windowing clamps it
    starts = np.clip(ci - box // 2, 0, [ny - box, nx - box])
    resid = (pred + center) - (starts + box // 2)               # (T, P, 2)
    poses = np.zeros((P, T, 5), dtype=np.float32)
    poses[:, :, :3] = eulers.transpose(1, 0, 2)
    # stored shift s centres content sitting at offset -s
    poses[:, :, 3:5] = -resid.transpose(1, 0, 2)
    df = 0.5 * (defocus[:, 0] + defocus[:, 1])[:, None] + depth * pixel
    ctf = np.zeros((P, T, 4), dtype=np.float32)
    ctf[:, :, 0] = ctf[:, :, 1] = df.T
    out = Path("stacks")
    out.mkdir(exist_ok=True)
    # uncompressed: the windows are noise to zlib, which took ~a minute
    # for 60 particles x 41 tilts at box 256
    np.savez(
        out / f"{name}_stack.npz", stacks=stacks.astype(np.float32),
        poses=poses, ctf=ctf, weights=np.ones((P, T), dtype=np.float32))
    logger.info("saved %d tilt stacks for %s", P, name)


def _csp_resumed_merge(items, params, device):
    """With -csp_resume, a project in which every series has its dump and
    the merged maps are newer than every dump is complete: the merge is
    not run again (it would write the same maps), and the summary's
    resolution is read from the half maps written. None otherwise."""
    from pyp_tpu_torch import as_f32
    from pyp_tpu_torch.core import fsc as fsc_mod
    from pyp_tpu_torch.io import mrc

    if not params.get("csp_resume") or not items:
        return None
    stem = Path("maps") / f"{params.get('data_set') or 'dataset'}_csp_02"
    outs = [Path(f"{stem}{s}.mrc") for s in ("", "_half1", "_half2")]
    dumps = [Path("swarm") / f"{it['name']}.acc.npz" for it in items]
    if not all(p.exists() for p in outs + dumps):
        return None
    if min(p.stat().st_mtime for p in outs) < max(p.stat().st_mtime
                                                  for p in dumps):
        return None
    h1, h2 = (as_f32(mrc.read(p), device) for p in outs[1:])
    freqs, curve = fsc_mod.fsc(h1, h2)
    res = float(fsc_mod.resolution_at_threshold(
        freqs.cpu(), curve.cpu(), float(params["scope_pixel"]), 0.143))
    logger.info("csp: resume — every series and the merge are done")
    return {"resolution": res, "series": len(dumps), "missing": [],
            "resumed": True}


def mode_csp(argv, device="cuda"):
    """CSPT refinement over preprocessed tilt-series: the cspswarm ->
    cspmerge job graph (per-series refinement + accumulator dumps, or
    batches of -csp_batch_series series refined together, then one merge
    summing the dumps on the card). With -csp_resume a series whose dump
    exists is not refined again, and a project whose merge is newer than
    every dump is not merged again (_csp_resumed_merge)."""
    params = _project_params(argv)
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.config.blocks import apply_block_overrides
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.ops.reconstruct import load_accumulators
    from pyp_tpu_torch.pipeline import csp as csp_pipe
    from pyp_tpu_torch.sched import JobGraph, LocalExecutor

    if not params.get("csp_parfile") and params.get("csp_parfile_tomo"):
        params = {**params, "csp_parfile": params["csp_parfile_tomo"]}
    block = str(params.get("csp_block") or "")
    if block:
        # per-block stage overrides (the reference's [tabs.csp_tomo_*])
        params = apply_block_overrides(params, block)
        logger.info("csp block %s: modes %s", block,
                    params.get("csp_refine_modes"))
    items = _discover_items(params)
    rc = _maybe_slurm_swarm("csp", argv, params, items)
    if rc is not None:
        return rc
    dev = resolve_device(device)
    ref_path = Path(str(params.get("csp_reference_model") or "")
                    or "initial_model.mrc")
    if not ref_path.exists():
        logger.error("csp needs %s (reference map)", ref_path)
        return 1
    ref = mrc.read(ref_path).astype(np.float32)
    box = int(params.get("csp_box") or ref.shape[-1])
    resumed = _csp_resumed_merge(items, params, dev)
    if resumed is not None:
        print(json.dumps(resumed, indent=1, default=str))
        return 0

    def merge_fn(results, missing):
        parallel.barrier()  # rank 0 wrote the dumps
        accs = [load_accumulators(r["dump"], device=dev)
                for r in results.values() if r]
        if not accs:
            raise RuntimeError("no tilt-series with picks found")
        out, res = csp_pipe.csp_merge(accs, box, params, ".",
                                      params.get("data_set") or "dataset")
        return {"resolution": res, "series": len(accs), "missing": missing}

    graph = JobGraph("csp")
    # series batching: B series per batch (csp_swarm_batch) unless a
    # per-series-only path is requested (patch grids, frame refinement)
    bsz = int(params.get("csp_batch_series") or 1)
    grid_str = str(params.get("csp_Grid") or "").strip()
    has_grid = bool(grid_str) and np.prod(
        [int(v) for v in grid_str.replace(",", ":").split(":")]) > 1
    batchable = bsz > 1 and not params.get("csp_frames") and not has_grid
    retries = dict(max_retries=int(params.get("slurm_retries") or 2),
                   merge_retries=int(params.get("slurm_merge_retries") or 2))
    if batchable and len(items) > 1:
        groups = [items[i:i + bsz] for i in range(0, len(items), bsz)]
        graph.swarm("cspswarm", groups,
                    work_fn=lambda group: _csp_series_batch(group, params,
                                                            ref, dev),
                    merge_fn=merge_fn, **retries)
    else:
        graph.swarm("cspswarm", items,
                    work_fn=lambda item: _csp_one_series(item, params, ref,
                                                         dev),
                    merge_fn=merge_fn, **retries)
    LocalExecutor(max_workers=int(params.get("slurm_local_tasks") or 0)
                  or int(params.get("slurm_tasks") or 1)).run(graph)
    merge = graph.jobs["cspswarm.merge"]
    print(json.dumps(merge.result, indent=1, default=str))
    return 0 if merge.status == "done" else 1


def mode_polish(argv, device="cuda"):
    """Per-particle movie refinement: re-extract particles from raw frames
    at drift-corrected positions, refine per-frame trajectories against the
    latest map, and rebuild stack.mrc dose-weighted, each polished particle
    normalized as `extract` normalizes it."""
    params = _project_params(argv)
    import torch

    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.ops import polish as polish_ops
    from pyp_tpu_torch.ops.extract import normalize_particles
    from pyp_tpu_torch.pipeline.refine import (table_to_ctf_params,
                                               table_to_poses)
    from pyp_tpu_torch.pipeline.spr import apply_gain, load_movie

    dev = resolve_device(device)
    table = cistem.read_parameters("stack.cistem")
    dataset = params.get("data_set") or "dataset"
    maps = sorted(Path("maps").glob(f"{dataset}_r??_??.mrc"))
    if not maps:
        logger.error("polish needs refined maps under maps/")
        return 1
    ref = mrc.read(maps[-1]).astype(np.float32)
    pixel = float(params["scope_pixel"])
    box = int(params["extract_box"])
    films = np.asarray(table["particle_group"]).astype(int)
    items = _discover_items(params)
    poses = table_to_poses(table, pixel)
    ctf = table_to_ctf_params(table)
    new_stack = np.array(mrc.read("stack.mrc"), dtype=np.float32, copy=True)
    n_polished = 0
    for film, item in enumerate(items, start=1):
        sel = np.where(films == film)[0]
        meta = ItemMetadata(item["name"], ".", mode="spr").load()
        if len(sel) == 0 or "box" not in meta:
            continue
        with Timer(f"polish {item['name']}"):
            frames = apply_gain(load_movie(item["path"]), params)
            coords = meta["box"][:, :2].astype(np.int32)[: len(sel)]
            drift = meta["drift"] if "drift" in meta else None
            stack_p, traj = polish_ops.polish(
                frames, coords, poses[sel], ctf[sel], ref, pixel, box,
                global_shifts=drift,
                reg_weight=float(params.get("polish_reg") or 2.0),
                spatial_sigma=float(params.get("polish_spatial_sigma") or 0.0),
                iters=int(params.get("polish_iters") or 30),
                lr=float(params.get("polish_lr") or 0.15), device=dev)
            # the polished particles replace extracted ones: normalized as
            # `extract` normalizes them (the JAX mode writes the raw frame
            # average, background offset and all, into the normalized stack)
            sign = -1.0 if params.get("extract_inv", True) else 1.0
            new_stack[sel] = sign * normalize_particles(stack_p).cpu().numpy()
        n_polished += len(sel)
        logger.info("polish %s: %d particles, trajectory RMS %.4f px",
                    item["name"], len(sel),
                    float(torch.sqrt(torch.mean(traj * traj))))
        if params.get("plot_per_item", True):
            # per-particle trajectory overlay (reference plot_trajectories)
            try:
                from pyp_tpu_torch.analysis.plots import (
                    plot_local_trajectories)

                plot_local_trajectories(
                    coords, traj.cpu().numpy(), frames.shape[-2:],
                    f"{item['name']}_trajectories.png")
            except (ImportError, OSError, ValueError) as e:
                logger.warning("trajectory plot skipped: %s", e)
    mrc.write(new_stack, "stack.mrc", pixel_size=pixel)
    print(json.dumps({"polished": n_polished}))
    return 0


def mode_sva(argv, device="cuda"):
    """Legacy subvolume averaging: gather subvolumes at the 3D picks of
    every reconstructed tomogram (*.rec.mrc), align them to a reference
    (-sva_ref, or reference-free from the raw average) with the bank-
    rotation FFT matcher, and write the wedge-compensated average
    (<dataset>_sva.mrc), per-class averages with -sva_classes > 1, and
    sva_alignment.npz."""
    params = _project_params(argv)
    import torch

    from pyp_tpu_torch import as_f32, resolve_device
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.ops import sva as sva_ops
    from pyp_tpu_torch.ops.extract import subvolume_gather

    dev = resolve_device(device)
    box = int(params.get("sva_box") or 48)
    # extraction boundary (extract_bnd): cut a larger window, keep box³
    bnd = max(int(params.get("extract_bnd") or 0), box)
    subs, names = [], []
    for rec in sorted(glob.glob("*.rec.mrc")):
        name = Path(rec).name[: -len(".rec.mrc")]
        meta = ItemMetadata(name, ".", mode="tomo").load()
        if "box" not in meta:
            continue
        vol = mrc.read(rec).astype(np.float32)
        coords = np.asarray(meta["box"])[:, :3]
        ok = np.all((coords >= box // 2)
                    & (coords < np.asarray(vol.shape) - box // 2), axis=1)
        if not ok.any():
            continue
        got = subvolume_gather(as_f32(vol, dev),
                               np.round(coords[ok]).astype(np.int64), bnd)
        if bnd > box:
            lo = (bnd - box) // 2
            got = got[:, lo:lo + box, lo:lo + box, lo:lo + box]
        subs.append(got)
        names.extend(f"{name}:{i}" for i in np.nonzero(ok)[0])
    if not subs:
        logger.error("sva: no *.rec.mrc with 3D picks found")
        return 1
    subs = torch.cat(subs)
    ref = None
    if params.get("sva_ref"):
        ref = mrc.read(str(params["sva_ref"])).astype(np.float32)

    def _pair(key, default):
        v = str(params.get(key) or default)
        a, b = (float(x) for x in v.replace(":", ",").split(","))
        return (a, b)

    wedge = float(params.get("sva_wedge") or 60.0)
    res = sva_ops.sva_iterate(
        subs, reference=ref,
        iters=int(params.get("sva_iters") or 3),
        angular_step=float(params.get("sva_ang") or 30.0),
        symmetry=str(params.get("particle_sym") or "C1"),
        shift_extent=int(params.get("sva_shift") or 8),
        wedge_deg=wedge,
        lowpass=_pair("sva_lowpass", "0.25,0.05"),
        highpass=_pair("sva_highpass", "0,0"),
        mask_rad=float(params.get("sva_mask_rad") or 0.0),
        mask_sigma=float(params.get("sva_mask_sigma") or 4.0),
        centering_iters=int(params.get("sva_centering_iters") or 0),
        keep_fraction=float(params.get("sva_keep_fraction") or 1.0),
        local_refine=bool(params.get("sva_local", True)), device=dev)
    out = f"{params.get('data_set') or 'dataset'}_sva.mrc"
    pix = float(params["scope_pixel"]) * int(params.get("tomo_rec_binning")
                                             or 1)
    mrc.write(res.average.cpu().numpy().astype(np.float32), out,
              pixel_size=pix)
    angles, shifts = res.angles.cpu().numpy(), res.shifts.cpu().numpy()
    scores = res.scores.cpu().numpy()
    report = {"subvolumes": int(len(subs)), "average": out,
              "mean_score": float(np.mean(scores))}
    labels = None
    K = int(params.get("sva_classes") or 1)
    if K > 1:
        labels, class_avgs = sva_ops.classify_subvolumes(
            subs, angles, shifts, K, wedge_deg=wedge, device=dev)
        stem = str(params.get("data_set") or "dataset")
        for k, avg in enumerate(class_avgs):
            mrc.write(avg.cpu().numpy().astype(np.float32),
                      f"{stem}_sva_class{k:02d}.mrc", pixel_size=pix)
        report["classes"] = [int(np.sum(labels == k)) for k in range(K)]
    np.savez("sva_alignment.npz", names=np.asarray(names), angles=angles,
             shifts=shifts, scores=scores,
             **({"labels": labels} if labels is not None else {}))
    print(json.dumps(report))
    return 0


def mode_sprtrain(argv, device="cuda"):
    """Train the NN particle picker from this project's picks (the
    reference's sprtrain entry): micrograph averages + box coordinates ->
    U-Net heatmap model saved to picker_model.npz, which
    `-detect_method nn` then uses."""
    params = _project_params(argv)
    from pyp_tpu_torch.sched import bridge

    if bridge.slurm_requested(params):
        print(json.dumps(bridge.submit_training("sprtrain", params, argv),
                         indent=1))
        return 0
    from pyp_tpu_torch import as_f32, resolve_device
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.models import io as mio
    from pyp_tpu_torch.models import picker as nn_picker

    dev = resolve_device(device)
    mics, coords = [], []
    for p in sorted(Path(".").glob("*.meta.npz")):
        meta = ItemMetadata(p.name.replace(".meta.npz", ""), ".",
                            mode="spr").load()
        if meta.is_done("box") and meta.is_done("average") and \
                len(meta["box"]):
            mics.append(np.asarray(meta["average"], dtype=np.float32))
            coords.append(np.asarray(meta["box"])[:, :2])
    if not mics:
        logger.error("sprtrain: no micrographs with picks in project dir")
        return 1
    pixel = float(params["scope_pixel"])
    radius_px = max(4, int(float(params["detect_rad"]) / pixel))
    tb = int(params.get("train_bin") or 1)
    if tb > 1:
        # training binning: Fourier-crop inputs and scale picks/radius to
        # the small grid
        from pyp_tpu_torch.core.fft import fourier_crop

        mics = [fourier_crop(as_f32(m, dev), (m.shape[0] // tb,
                                              m.shape[1] // tb))
                .cpu().numpy().astype(np.float32) for m in mics]
        coords = [np.asarray(c, dtype=np.float32) / tb for c in coords]
        radius_px = max(2, radius_px // tb)
    patch = int(params.get("train_patch") or 128)
    with Timer("picker training"):
        model = nn_picker.train_picker(
            mics, coords, radius_px, patch=patch,
            steps=int(params.get("train_steps") or 300),
            batch=int(params.get("train_batch") or 16),
            lr=float(params.get("train_lr") or 3e-4),
            seed=int(params.get("train_seed") or 0),
            features=(8, 16, 32), device=dev)
    mio.save_params(model.params, "picker_model.npz", patch=patch)
    print(json.dumps({"micrographs": len(mics),
                      "particles": int(sum(len(c) for c in coords)),
                      "model": "picker_model.npz"}))
    return 0


def mode_tomotrain(argv, device="cuda"):
    """Train the NN picker for tomograms from .spk picks (tomotrain):
    per-slice heatmap supervision around each 3D pick, written to
    picker_model_tomo.npz."""
    params = _project_params(argv)
    from pyp_tpu_torch.sched import bridge

    if bridge.slurm_requested(params):
        print(json.dumps(bridge.submit_training("tomotrain", params, argv),
                         indent=1))
        return 0
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.io import boxfiles, mrc
    from pyp_tpu_torch.models import io as mio
    from pyp_tpu_torch.models import picker as nn_picker

    dev = resolve_device(device)
    pixel = float(params["scope_pixel"])
    rad_px = max(3, int(float(params["tomo_spk_rad"]) / max(
        pixel * int(params.get("tomo_rec_binning") or 8), 1e-6)))
    slices, coords = [], []
    for rec_path in sorted(Path(".").glob("*.rec.mrc")):
        spk = rec_path.with_name(rec_path.name.replace(".rec.mrc", ".spk"))
        if not spk.exists():
            continue
        # detect_nn3d use_denoised: train on the denoised tomogram when one
        # exists beside the raw reconstruction
        den = rec_path.with_name(rec_path.name.replace(".rec.mrc",
                                                       ".den.mrc"))
        if params.get("detect_nn3d_use_denoised", True) and den.exists():
            rec_path = den
        vol = mrc.read(rec_path).astype(np.float32)
        picks = boxfiles.read_spk(spk)          # (N, >=3) (z, y, x)
        for z in np.unique(np.round(picks[:, 0]).astype(int)):
            if not (0 <= z < vol.shape[0]):
                continue
            sel = np.abs(picks[:, 0] - z) < rad_px
            slices.append(vol[z])
            coords.append(picks[sel][:, 1:3])
    if not slices:
        logger.error("tomotrain: no *.rec.mrc with matching .spk picks")
        return 1
    patch = int(params.get("train_patch") or 128)
    steps = int(params.get("train_steps") or 300)
    if params.get("detect_nn3d_num_epochs"):
        # one "epoch" covers the slice set with ~100 sampled patches
        steps = int(params["detect_nn3d_num_epochs"]) * 100
    with Timer("picker training"):
        model = nn_picker.train_picker(
            slices, coords, rad_px, patch=patch, steps=steps,
            batch=int(params.get("train_batch") or 16),
            lr=float(params.get("train_lr") or 3e-4),
            seed=int(params.get("train_seed") or 0),
            features=(8, 16, 32), device=dev)
    mio.save_params(model.params, "picker_model_tomo.npz", patch=patch)
    print(json.dumps({"slices": len(slices), "model":
                      "picker_model_tomo.npz"}))
    return 0


def mode_mine(argv, device="cuda"):
    """Label-free tomogram pattern mining (the reference's milotrain/
    miloeval): train the contrastive miner on the project's tomograms,
    cluster a dense sweep of each, and write per-cluster coordinates
    (<name>_cluster<k>.spk) + a JSON gallery."""
    params = _project_params(argv)
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.io import boxfiles, mrc
    from pyp_tpu_torch.models import miner

    dev = resolve_device(device)
    # the JAX mode's precedence: *.rec.mrc, else mrc/*.mrc where mrc/ is a
    # directory
    recs = sorted(Path(".").glob("*.rec.mrc")) or sorted(
        Path("mrc").glob("*.mrc")) if Path("mrc").is_dir() else sorted(
        Path(".").glob("*.rec.mrc"))
    if not recs:
        logger.error("no tomogram volumes (*.rec.mrc or mrc/*.mrc) found")
        return 1
    vols = [mrc.read(p).astype(np.float32) for p in recs]
    patch = int(params.get("mine_patch") or 16)
    with Timer("miner training"):
        model = miner.train_miner(
            vols, patch=patch,
            n_steps=int(params.get("mine_steps") or 300),
            embed_dim=int(params.get("mine_embed_dim") or 32),
            batch=int(params.get("mine_batch") or 64),
            lr=float(params.get("mine_lr") or 1e-3),
            temperature=float(params.get("mine_temperature") or 0.2),
            seed=int(params.get("mine_seed") or 0), device=dev)
    gallery = {}
    K = int(params.get("mine_clusters") or 8)
    for p, vol in zip(recs, vols):
        name = p.name.replace(".rec.mrc", "").replace(".mrc", "")
        with Timer("mining"):
            clusters, _labels, _coords = miner.mine_tomogram(
                model, vol, n_clusters=K, device=dev)
        entry = []
        for k, c in enumerate(clusters):
            if c["size"]:
                boxfiles.write_spk(c["coords"], f"{name}_cluster{k:02d}.spk")
            entry.append({"cluster": k, "size": c["size"],
                          "exemplars": np.asarray(c["exemplars"]).tolist()})
        gallery[name] = entry
    Path("mine_gallery.json").write_text(json.dumps(gallery, indent=1))
    print(json.dumps({"tomograms": len(recs), "clusters": K,
                      "gallery": "mine_gallery.json"}))
    return 0


def mode_prism(argv, device="cuda"):
    """Self-supervised micrograph quality assessment (the prismPYP role):
    learn the dataset's real+Fourier appearance, score every micrograph
    by typicality, and write prism_score into each item's metadata (and
    prism_embeddings.npz); the filter mode does the consensus filtering."""
    params = _project_params(argv)
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.analysis.filters import discover_bundles
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.models import quality as qual

    dev = resolve_device(device)
    mode = "tomo" if params.get("data_mode") == "tomo" else "spr"
    mics, kept_names = [], []
    for name in discover_bundles("."):
        meta = ItemMetadata(name, ".", mode=mode).load()
        if "average" in meta:
            mics.append(np.asarray(meta["average"], dtype=np.float32))
            kept_names.append(name)
    if len(mics) < 2:
        logger.error("prism: need >=2 items with averages (found %d)",
                     len(mics))
        return 1
    stack = np.stack(mics)
    with Timer("quality training"):
        model = qual.train_quality(
            stack,
            size=int(params.get("prism_size") or 128),
            latent_dim=int(params.get("prism_latent") or 16),
            steps=int(params.get("prism_steps") or 300),
            batch=int(params.get("prism_batch") or 16),
            lr=float(params.get("prism_lr") or 1e-3),
            seed=int(params.get("prism_seed") or 0),
            momentum=float(params.get("prism_momentum") or 0.0),
            weight_decay=float(params.get("prism_weight_decay") or 0.0),
            log_every=int(params.get("prism_print_freq") or 0), device=dev)
    scores = qual.quality_scores(model, stack, device=dev)
    emb = qual.embed_quality(model, stack, device=dev).cpu().numpy()
    for name, s in zip(kept_names, scores):
        meta = ItemMetadata(name, ".", mode=mode).load()
        meta.scalars["prism_score"] = float(s)
        meta.save()
    np.savez("prism_embeddings.npz", names=np.asarray(kept_names),
             embeddings=emb, scores=scores)
    print(json.dumps({"items": len(kept_names),
                      "score_min": round(float(scores.min()), 3),
                      "score_median": round(float(np.median(scores)), 3),
                      "embeddings": "prism_embeddings.npz"}))
    return 0


def _het_kwargs(params, batch):
    return dict(
        latent_dim=int(params.get("het_latent") or 8),
        steps=int(params.get("het_steps") or 500),
        batch=int(params.get("het_batch") or batch),
        lr=float(params.get("het_lr") or 1e-3),
        low_res=float(params.get("het_rlref") or 60.0),
        high_res=float(params.get("het_rhref") or 8.0),
        kl_weight=float(params.get("het_kl") or 1e-3),
        seed=int(params.get("het_seed") or 0),
        hidden=int(params.get("het_hidden") or 128),
        voltage_kv=float(params["scope_voltage"]),
        cs_mm=float(params["scope_cs"]),
        w=float(params["scope_wgh"]))


def mode_heterogeneity(argv, device="cuda"):
    """Continuous heterogeneity analysis on the refined stack (the
    reference's heterogeneitytrain/eval around cryoDRGN): train the
    per-particle latent encoder + Fourier-slice decoder at the refined
    poses (or, with -het_eval, reuse het_model.npz), embed every particle
    and decode volumes along a principal latent direction. With tilt
    stacks (stacks/*_stack.npz from `csp -csp_save_stacks`, or
    -het_input) the tilt-aware branch runs instead."""
    params = _project_params(argv)
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.models import heterogeneity as het
    from pyp_tpu_torch.pipeline.refine import (table_to_ctf_params,
                                               table_to_poses)

    dev = resolve_device(device)
    pixel = float(params["scope_pixel"])
    tilt_glob = sorted(glob.glob(
        str(params.get("het_input") or "stacks/*_stack.npz")))
    # the JAX mode's precedence, kept as it is
    if tilt_glob and not Path("stack.mrc").exists() or params.get("het_input"):
        return _heterogeneity_tilt(tilt_glob, params, pixel, dev)

    stack = mrc.read("stack.mrc").astype(np.float32)
    table = cistem.read_parameters("stack.cistem")
    if params.get("het_eval") and Path("het_model.npz").exists():
        # heterogeneityeval role: reuse the trained checkpoint
        model = het.load_model("het_model.npz")
        logger.info("heterogeneity: loaded het_model.npz (eval only)")
    else:
        with Timer("heterogeneity training"):
            model = het.train_heterogeneity(
                stack, table_to_poses(table, pixel),
                table_to_ctf_params(table), pixel, device=dev,
                **_het_kwargs(params, 32))
        het.save_model(model, "het_model.npz")
    latents = het.embed(model, stack, device=dev).cpu().numpy()
    return _het_report(latents, model, params, pixel, stack, dev)


def _heterogeneity_tilt(stack_files, params, pixel, dev):
    """The tomoDRGN-role branch: the tilt-aware latent model on the
    per-particle tilt stacks `csp -csp_save_stacks` exports."""
    from pyp_tpu_torch.models import heterogeneity as het

    if not stack_files:
        logger.error("heterogeneity: no tilt stacks (stacks/*_stack.npz); "
                     "run csp with -csp_save_stacks first")
        return 1
    parts = [np.load(f) for f in stack_files]
    stacks = np.concatenate([p["stacks"] for p in parts])
    poses = np.concatenate([p["poses"] for p in parts])
    ctf = np.concatenate([p["ctf"] for p in parts])
    weights = np.concatenate([p["weights"] for p in parts])
    if params.get("het_eval") and Path("het_model.npz").exists():
        model = het.load_model("het_model.npz")
        logger.info("heterogeneity: loaded het_model.npz (eval only)")
    else:
        with Timer("heterogeneity training"):
            model = het.train_heterogeneity_tilt(
                stacks, poses, ctf, pixel, tilt_weights=weights, device=dev,
                **_het_kwargs(params, 8))
        het.save_model(model, "het_model.npz")
    latents = het.embed_tilt(model, stacks, device=dev).cpu().numpy()
    return _het_report(latents, model, params, pixel, stacks, dev)


def _het_report(latents, model, params, pixel, stacks, dev):
    """heterogeneity_latents.npz, het_volume_XX.mrc along the chosen PC
    between its 5th and 95th percentiles, and the summary line."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.models import heterogeneity as het

    np.savez("heterogeneity_latents.npz", latents=latents)
    scores, comps, svals = het.latent_pca(latents, n_components=2)
    nvol = int(params.get("het_volumes") or 5)
    mean_z = latents.mean(axis=0)
    pc = max(0, int(params.get("het_pc") or 1) - 1)
    for i, q in enumerate(np.linspace(5, 95, nvol)):
        z = mean_z + comps[pc] * np.percentile(scores[:, pc], q)
        vol = het.decode_volume(model, z, device=dev).cpu().numpy()
        mrc.write(vol.astype(np.float32), f"het_volume_{i:02d}.mrc",
                  pixel_size=pixel)
    total_var = latents.var(axis=0).sum() * max(len(latents) - 1, 1)
    report = {"particles": int(len(stacks))}
    if stacks.ndim == 4:
        report["tilts"] = int(stacks.shape[1])
    report.update({"latent_dim": int(latents.shape[1]), "volumes": nvol,
                   "pc1_explained": float(svals[0] ** 2 / max(total_var,
                                                              1e-9))})
    print(json.dumps(report))
    return 0


def mode_import_star(argv, device="cuda"):
    """RELION star -> project metadata. SPA particles.star -> stack.cistem;
    tomo stars (reference TomoStar2meta[V5], pyp_metadata.py:763+):
    tomograms.star -> per-series tlt/xf/ctf metadata, RELION5 particles
    star -> <name>.next coords + eulers tables. Host only: `device` is
    accepted for the common signature."""
    from pyp_tpu_torch.io import cistem, relion, relion_tomo

    # reference-compatible flags (rlp -import_refine_star/-import_tomo_star,
    # docs/cli/*_import_export.rst) join any positional star paths
    flagged = []
    ip = _project_params(argv, persist=False)
    for key in ("import_refine_star", "import_tomo_star",
                "import_motion_star"):
        v = str(ip.get(key) or "")
        if v:
            flagged.append(v)
    positional = [a for a in argv if not a.startswith("-")
                  and a.endswith(".star")]
    paths = [p for p in positional if p not in flagged] + flagged
    if not paths:
        logger.error("usage: import_star <file.star> [more.star ...] or "
                     "-import_refine_star/-import_tomo_star <file.star>")
        return 2

    # declared format (import_format, the csp_tomo_free block field): the
    # dispatch below is content-based; a declared format that disagrees
    # with the detected one is surfaced instead of silently honored
    declared = str(ip.get("import_format") or "none")
    declared_ver = str(ip.get("import_tomo_star_version") or "")
    report = {}
    for path in paths:
        text = Path(path).read_text()
        detected = ("tomo" if "_rlnTomoProjX" in text else "spa")
        if declared_ver:
            # declared RELION star dialect (import tab tomo_star_version):
            # content detection wins, disagreement is surfaced
            ver_detected = "5" if ("_rlnTomoName" in text
                                   or "_rlnTomoProjX" in text) else "4"
            if declared_ver.lstrip("relion") not in ("", ver_detected):
                logger.warning(
                    "import_tomo_star_version=%s declared but %s uses the "
                    "RELION %s tomo dialect — importing by content",
                    declared_ver, path, ver_detected)
        if declared not in ("none", "") and declared.lower() not in (
                "relion", "relion5", "star", detected):
            logger.warning("import_format=%s declared but %s looks like a "
                           "%s star file — importing by content", declared,
                           path, detected)
        if "_rlnTomoProjX" in text:
            series, gparams = relion_tomo.import_tomograms_star(path)
            from pyp_tpu_torch.io.metadata import ItemMetadata

            for s in series:
                meta = ItemMetadata(s["name"], ".", mode="tomo").load()
                meta["tlt"] = s["tilt_angles"]
                T = len(s["tilt_angles"])
                xf = np.zeros((T, 3), dtype=np.float32)
                meta["xf"] = xf
                ctf = np.zeros((T, 6), dtype=np.float32)
                ctf[:, :2] = s["defocus"]
                ctf[:, 2] = s["astig_angle"]
                meta["ctf"] = ctf
                meta.save()
            cfg.update_parameters(".", gparams)
            report[path] = {"tomograms": len(series), **{
                k: v for k, v in gparams.items() if k.startswith("scope")}}
        elif "_rlnTomoName" in text:
            parts = relion_tomo.import_particles_star_v5(path)
            np.savez("imported_particles.npz", **{
                k: v for k, v in parts.items() if k != "optics"})
            report[path] = {"particles": len(parts["tomo_names"]),
                            "file": "imported_particles.npz"}
        elif "_rlnAccumMotionTotal" in text:
            # corrected_micrographs star (-import_motion_star): record
            # RELION's accumulated-motion stats per micrograph — they
            # become filterable metadata metrics. Micrographs absent from
            # the project are reported, not materialized as empty bundles.
            from pyp_tpu_torch.io import star as star_mod
            from pyp_tpu_torch.io.metadata import ItemMetadata

            blocks = star_mod.read(path)
            loop = next(b["loop"] for b in blocks.values()
                        if "rlnMicrographName" in b["loop"])
            names = [Path(m).stem for m in loop["rlnMicrographName"]]
            have_project_items = any(Path(".").glob("*.meta.npz"))
            matched, unmatched = 0, 0
            for i, nm in enumerate(names):
                meta = ItemMetadata(nm, ".", mode="spr")
                if have_project_items and not meta.load().exists():
                    unmatched += 1
                    continue
                meta.load()
                for col, key in (("rlnAccumMotionTotal", "motion_total"),
                                 ("rlnAccumMotionEarly", "motion_early"),
                                 ("rlnAccumMotionLate", "motion_late")):
                    if col in loop:
                        meta.scalars[key] = float(loop[col][i])
                meta.save()
                matched += 1
            report[path] = {"micrographs": matched, "unmatched": unmatched}
        elif "_rlnCoordinateX" not in text and "_rlnAngleRot" not in text:
            report[path] = {"skipped": "unrecognized star (no particles, "
                            "tomograms, or motion table)"}
        else:
            table, optics = relion.import_star(path)
            cistem.write_parameters(table, "stack.cistem")
            report[path] = {"particles": table.n_rows, "optics": optics}
    print(json.dumps(report, default=str))
    return 0


def mode_export_star(argv, device="cuda"):
    """stack.cistem -> RELION particles.star (the export_star mode).
    With -data_mode tomo, exports tomograms.star + RELION5 particles star
    from the project's tilt-series metadata (the reference's meta2Star tomo
    branch, pyp_metadata.py:1148). Host only: `device` is accepted for the
    common signature."""
    params = _project_params(argv)
    from pyp_tpu_torch.io import cistem, relion

    if str(params.get("data_mode") or "spr") == "tomo":
        from pyp_tpu_torch.io import relion_tomo
        from pyp_tpu_torch.io.metadata import ItemMetadata

        series, parts = [], None
        for meta_path in sorted(Path(".").glob("*.meta.npz")):
            name = meta_path.name.replace(".meta.npz", "")
            meta = ItemMetadata(name, ".", mode="tomo").load()
            if not meta.is_done("tlt"):
                continue
            tlt = np.asarray(meta["tlt"]).reshape(-1)
            T = len(tlt)
            xf6 = np.zeros((T, 6), dtype=np.float32)
            xf6[:, 0] = xf6[:, 3] = 1.0
            if meta.is_done("xf"):
                xfm = np.asarray(meta["xf"])
                xf6[:, 4:6] = xfm[:, :2]
            ctf = (np.asarray(meta["ctf"]) if meta.is_done("ctf")
                   else np.zeros((T, 6), dtype=np.float32))
            series.append({
                "name": name, "tilt_angles": tlt, "xf": xf6,
                "defocus": ctf[:, :2], "astig_angle": ctf[:, 2],
                "order": np.arange(T, dtype=np.float32),
                "image_dims": (int(params.get("tomo_rec_thickness") or 2048),
                               int(params.get("tomo_rec_thickness") or 2048)),
            })
        if not series:
            logger.error("no tilt-series metadata (*_meta.npz with tlt) found")
            return 1
        loc = Path(str(params.get("export_location") or "."))
        loc.mkdir(parents=True, exist_ok=True)
        rt_out = relion_tomo.export_tomograms_star(
            series, params, str(loc / "tomograms.star"))
        report = {"tomograms.star": len(series)}
        if Path("imported_particles.npz").exists():
            d = dict(np.load("imported_particles.npz", allow_pickle=True))
            d["tomo_names"] = list(d["tomo_names"])
            relion_tomo.export_particles_star_v5(
                d, params, str(loc / "particles.star"))
            report["particles.star"] = len(d["tomo_names"])
        print(json.dumps(report))
        return 0

    table = cistem.read_parameters("stack.cistem")
    loc = Path(str(params.get("export_location") or "."))
    loc.mkdir(parents=True, exist_ok=True)
    out = str(loc / "particles.star")
    relion.export_star(
        table, out, pixel_size=float(params["scope_pixel"]),
        voltage=float(params["scope_voltage"]), cs=float(params["scope_cs"]),
        w=float(params["scope_wgh"]),
        image_name_fmt=str(params.get("export_image_fmt")
                           or "{i}@stack.mrcs"),
        optics_group=int(params.get("export_optics_group") or 1),
    )
    print(json.dumps({"particles": table.n_rows, "star": out}))
    return 0


def mode_params(argv, device="cuda"):
    """Print the project's parameters (the project file updated with the
    flags given). Host only: `device` is accepted for the common
    signature."""
    params = _project_params(argv)
    print(json.dumps(params, indent=1, default=str))
    return 0


def mode_filter(argv, device="cuda"):
    """Create a micrograph/tilt-series filter selection (the reference's
    table-view Filters, docs/guide/filters.rst): evaluate metric criteria
    over every item's metadata bundle, apply manual include/exclude
    overrides, and save a selection downstream modes load via -filter_sel.

      pyp_tpu_torch.cli filter -filter_criteria "ctf_res<8 drift<60" -filter_name good
      pyp_tpu_torch.cli refine ... -filter_sel good

    Host only: `device` is accepted for the common signature.
    """
    params = _project_params(argv)
    from pyp_tpu_torch.analysis.filters import apply_filter, save_selection

    mode = "tomo" if params.get("data_mode") == "tomo" else "spr"
    crit = str(params.get("filter_criteria") or "")
    inc = [t for t in str(params.get("filter_include") or "").replace(
        ",", " ").split() if t]
    exc = [t for t in str(params.get("filter_exclude") or "").replace(
        ",", " ").split() if t]
    kept, table = apply_filter(".", crit, mode=mode, include=inc,
                               exclude=exc)
    name = str(params.get("filter_name") or "filter1")
    ds = str(params.get("data_set") or "dataset")
    out = save_selection(f"{ds}_{name}.filter.json", kept, crit, table)
    print(json.dumps({"filter": out, "kept": len(kept),
                      "total": len(table), "criteria": crit}))
    return 0


def mode_byp(argv, device="cuda"):
    """Box/model interop utilities (the reference's bin/run/byp):
    dispatch on the input file's extension like the reference does.

      byp picks.mod -extract_box 128      # mod2box: IMOD picks -> .box
      byp mic.boxx                        # box2mod: .box/.boxx -> IMOD .mod
      byp particles.star                  # relion2box: star -> .box per film
      byp stack.mrc -to_hdf               # mrc stack -> EMAN2 HDF
      byp stack.hdf                       # EMAN2 HDF -> mrc stack
      byp stack.cistem                    # cistem2par: -> FREALIGN .par

    Host only: `device` is accepted for the common signature.
    """
    if not argv or argv[0].startswith("-"):
        logger.error("usage: byp <file.mod|.box|.boxx|.star> [params]")
        return 2
    src = Path(argv[0])
    params = _project_params(argv[1:])
    box = int(params.get("extract_box") or 128)
    from pyp_tpu_torch.io import boxfiles, imod

    scaling = float(params.get("convert_scaling") or 1.0)
    zheight = float(params.get("convert_z") or 256)
    depth = float(params.get("convert_depth") or 256)
    if src.suffix == ".cistem":
        # cistem2par: alignment table -> FREALIGN .par (the reference's
        # parfile hand-off format); refine_parfile_compress writes .par.bz2
        from pyp_tpu_torch.io import cistem as _cistem
        from pyp_tpu_torch.io import parfile as _parfile

        table = _cistem.read_parameters(src)
        pf = _parfile.from_cistem_table(
            table, variant=str(params.get("refine_metric") or "new")
            .replace("cc3m", "new").replace("frealignx", "frealignx"))
        out = src.with_suffix(
            ".par.bz2" if params.get("refine_parfile_compress") else ".par")
        _parfile.write(pf, out)
        print(json.dumps({"mode": "cistem2par", "rows": table.n_rows,
                          "output": str(out)}))
        return 0
    if src.suffix == ".cbox":
        # crYOLO picks -> IMOD model (reference pyp_convert_coord
        # cryolo2mod, analysis/geometry/pyp_convert_coord.py:83): rescale
        # from the cryolo tomogram grid and re-center z on the pyp depth
        centers, cbox_size, conf = boxfiles.read_cbox(src)
        pts = centers / scaling
        pts[:, 2] = pts[:, 2] - zheight / (2 * scaling) + depth / 2
        out = src.with_suffix(".mod")
        imod.write_point_model(out, pts)
        boxfiles.write_spk(np.stack([pts[:, 2], pts[:, 1], pts[:, 0]], 1),
                           src.with_suffix(".spk"))
        print(json.dumps({"mode": "cryolo2mod", "picks": int(len(pts)),
                          "mod": str(out)}))
        return 0
    if src.suffix == ".mod" and params.get("to_cbox"):
        # IMOD model -> crYOLO picks (mod2cryolo,
        # pyp_convert_coord.py:122): inverse of the transform above
        pts = imod.read_points(src)            # (N, 3) x, y, z
        xyz = np.array(pts[:, :3], dtype=np.float64)
        xyz[:, 2] = xyz[:, 2] - depth / 2 + zheight / (2 * scaling)
        xyz *= scaling
        out = src.with_suffix(".cbox")
        boxfiles.write_cbox(xyz, box * scaling, out)
        print(json.dumps({"mode": "mod2cryolo", "picks": int(len(pts)),
                          "cbox": str(out)}))
        return 0
    if src.suffix == ".mod":
        pts = imod.read_points(src)            # (N, 3) x, y, z
        coords_yx = np.stack([pts[:, 1], pts[:, 0]], axis=1)
        out = src.with_suffix(".box")
        boxfiles.write_box(coords_yx, box, out)
        print(json.dumps({"mode": "mod2box", "picks": int(len(pts)),
                          "box": str(out)}))
        return 0
    if src.suffix in (".box", ".boxx"):
        if src.suffix == ".boxx":
            coords_yx, boxsize, inside, kept = boxfiles.read_boxx(src)
            sel = np.asarray(kept, dtype=bool)
            coords_yx = np.asarray(coords_yx)[sel]
        else:
            coords_yx, boxsize = boxfiles.read_box(src)
            coords_yx = np.asarray(coords_yx)
        pts = np.stack([coords_yx[:, 1], coords_yx[:, 0],
                        np.zeros(len(coords_yx))], axis=1)
        out = src.with_suffix(".mod")
        imod.write_point_model(out, pts)
        print(json.dumps({"mode": "box2mod", "picks": int(len(pts)),
                          "mod": str(out)}))
        return 0
    if src.suffix in (".hdf", ".h5"):
        # EMAN2 -> mrc (refine/eman role)
        from pyp_tpu_torch.io import eman, mrc

        stack, apix = eman.read_hdf(src)
        out = src.with_suffix(".mrc")
        mrc.write(stack, out, pixel_size=apix)
        print(json.dumps({"mode": "hdf2mrc", "images": int(len(stack)),
                          "mrc": str(out)}))
        return 0
    if src.suffix in (".mrc", ".mrcs") and params.get("to_hdf"):
        from pyp_tpu_torch.io import eman

        out = eman.export_particles_hdf(
            src, src.with_suffix(".hdf"),
            apix=float(params.get("scope_pixel") or 1.0))
        print(json.dumps({"mode": "mrc2hdf", "hdf": out}))
        return 0
    if src.suffix == ".star":
        from pyp_tpu_torch.io import relion

        table, _optics = relion.import_star(str(src))
        films = np.asarray(table["particle_group"]).astype(int) \
            if "particle_group" in table else np.zeros(table.n_rows, int)
        n_files = 0
        for f in np.unique(films):
            sel = films == f
            coords_yx = np.stack([
                np.asarray(table["original_y_position"])[sel],
                np.asarray(table["original_x_position"])[sel]], axis=1)
            boxfiles.write_box(coords_yx, box, src.parent / f"film{f:04d}.box")
            n_files += 1
        print(json.dumps({"mode": "relion2box", "films": n_files,
                          "particles": int(table.n_rows)}))
        return 0
    logger.error("byp: unsupported input %s", src.suffix)
    return 2


def mode_boxedit(argv, device="cuda"):
    """Edit particle picks (the reference's boxedit,
    bin/run/pyp:3612): remove picks inside a circle, threshold by score,
    or replace with an imported .box file. Host only: `device` is accepted
    for the common signature."""
    params = _project_params(argv, persist=False)
    from pyp_tpu_torch.io import boxfiles
    from pyp_tpu_torch.io.metadata import ItemMetadata

    name = str(params.get("edit_name") or "")
    if not name:
        logger.error("boxedit needs -edit_name <micrograph>")
        return 2
    meta = ItemMetadata(name, ".", mode="spr").load()
    box = np.asarray(meta["box"]) if meta.is_done("box") else np.zeros((0, 3))
    n0 = len(box)
    imp = str(params.get("edit_import_box") or "")
    if imp:
        coords, _w = boxfiles.read_box(imp)   # (N, 2) centers (y, x)
        box = np.concatenate([coords, np.ones((len(coords), 1))], axis=1)
    spec = str(params.get("edit_remove_circle") or "")
    if spec and len(box):
        cy, cx, r = (float(v) for v in spec.replace(",", ":").split(":"))
        d2 = (box[:, 0] - cy) ** 2 + (box[:, 1] - cx) ** 2
        box = box[d2 > r * r]
    thr = float(params.get("edit_min_score") or 0.0)
    if thr > 0 and box.shape[1] > 2:
        box = box[box[:, 2] >= thr]
    meta["box"] = box.astype(np.float32)
    meta.save()
    print(json.dumps({"name": name, "picks_before": n0,
                      "picks_after": int(len(box))}))
    return 0


def mode_tomoedit(argv, device="cuda"):
    """Edit tilt-series metadata (the reference's tomoedit,
    bin/run/pyp:3526): exclude tilts and/or drop virions; the resume-aware
    pipeline honors the exclusion on the next run (with the relevant
    _force flags). Host only: `device` is accepted for the common
    signature."""
    params = _project_params(argv, persist=False)
    from pyp_tpu_torch.io.metadata import ItemMetadata

    name = str(params.get("edit_name") or "")
    if not name:
        logger.error("tomoedit needs -edit_name <tilt-series>")
        return 2
    meta = ItemMetadata(name, ".", mode="tomo").load()
    report = {"name": name}
    spec = str(params.get("edit_exclude_tilts") or "")
    if spec:
        drop = sorted({int(t) for t in spec.replace(",", ":").split(":")})
        keep = None
        for key in ("tlt", "xf", "ctf", "order"):
            if meta.is_done(key):
                arr = np.asarray(meta[key])
                if keep is None:
                    keep = np.setdiff1d(np.arange(len(arr)), drop)
                meta[key] = arr[keep[keep < len(arr)]]
        report["excluded_tilts"] = drop
    if params.get("edit_drop_virions"):
        if meta.is_done("vir"):
            meta["vir"] = np.zeros((0, 5), dtype=np.float32)
        report["virions_dropped"] = True
    meta.save()
    print(json.dumps(report))
    return 0


def mode_export_session(argv, device="cuda"):
    """Streaming session -> RELION export (the reference's `pex` /
    export_session env mode, bin/run/pyp:5121 weak_meta2Star): for the
    selected micrographs (a *.micrographs list file in the export dir,
    else every processed item in the session), write
    relion/<data_set>_micrographs.star (optics + per-micrograph CTF) and
    per-micrograph _autopick.star coordinate files. Host only: `device` is
    accepted for the common signature."""
    params = _project_params(argv, persist=False)
    from pyp_tpu_torch.io import star
    from pyp_tpu_torch.io.metadata import ItemMetadata

    session = str(params.get("data_parent") or ".")
    sp = {**params, **(cfg.load_parameters(session) or {})}
    data_set = str(sp.get("data_set") or "session")
    mode = str(sp.get("data_mode") or "spr")

    lists = sorted(glob.glob("*.micrographs"))
    if lists:
        wanted = [ln.strip() for ln in open(lists[0]) if ln.strip()]
    else:
        wanted = sorted(p.name[: -len(".meta.npz")] for p in
                        Path(session).glob("*.meta.npz"))
    out_dir = Path("relion")
    out_dir.mkdir(exist_ok=True)

    names, df1, df2, ang, fom = [], [], [], [], []
    n_coords = 0
    for name in wanted:
        meta = ItemMetadata(name, session, mode=mode).load()
        if "ctf" not in meta:
            continue
        c = np.atleast_2d(np.asarray(meta["ctf"]))
        names.append(f"{name}.mrc")
        df1.append(float(c[0, 0]))
        df2.append(float(c[0, 1]))
        ang.append(float(c[0, 2]))
        fom.append(float(c[0, 4]) if c.shape[1] > 4 else float(c[0, 3]))
        if "box" in meta and len(np.asarray(meta["box"])):
            box = np.atleast_2d(np.asarray(meta["box"]))
            star.write({"root": {"fields": {}, "loop": {
                "rlnCoordinateX": box[:, 1].astype(np.float64),
                "rlnCoordinateY": box[:, 0].astype(np.float64),
                "rlnAutopickFigureOfMerit": (
                    box[:, -1] if box.shape[1] > 2
                    else np.ones(len(box))).astype(np.float64),
            }}}, out_dir / f"{name}_autopick.star")
            n_coords += len(box)
    if not names:
        logger.error("export_session: no processed micrographs with CTF "
                     "under %s", session)
        return 1
    n = len(names)
    star.write({
        "optics": {"fields": {}, "loop": {
            "rlnOpticsGroup": np.array([1]),
            "rlnMicrographPixelSize": np.array([float(sp["scope_pixel"])]),
            "rlnVoltage": np.array([float(sp["scope_voltage"])]),
            "rlnSphericalAberration": np.array([float(sp["scope_cs"])]),
            "rlnAmplitudeContrast": np.array([float(sp["scope_wgh"])]),
        }},
        "micrographs": {"fields": {}, "loop": {
            "rlnMicrographName": np.array(names, dtype=object),
            "rlnOpticsGroup": np.ones(n, dtype=np.int64),
            "rlnDefocusU": np.array(df1),
            "rlnDefocusV": np.array(df2),
            "rlnDefocusAngle": np.array(ang),
            "rlnCtfFigureOfMerit": np.array(fom),
        }},
    }, out_dir / f"{data_set}_micrographs.star")
    print(json.dumps({"micrographs": n, "coordinates": n_coords,
                      "star": str(out_dir / f"{data_set}_micrographs.star")}))
    return 0


def mode_report(argv, device="cuda"):
    """Static HTML project report (the web dashboards' file-based
    counterpart): per-item metric histograms + table, refinement FSC
    curves, model-fit track — one self-contained <dataset>_report.html
    (without matplotlib, its tables without figures). Host only: `device`
    is accepted for the common signature."""
    params = _project_params(argv, persist=False)
    from pyp_tpu_torch.analysis.report import build_report

    mode = "tomo" if params.get("data_mode") == "tomo" else "spr"
    out = build_report(".", str(params.get("data_set") or "dataset"),
                       mode=mode)
    print(json.dumps({"report": out}))
    return 0


def mode_workflow(argv, device="cuda"):
    """Run a pre-defined block sequence from a .toml workflow file (the
    reference's Workflows, docs/guide/workflows.rst):

      pyp_tpu_torch.cli workflow spa_tutorial.toml -data_path "/data/*.tif"

    Flags after the file fill the workflow's `{ ask = true }` arguments and
    are also appended to every block's invocation. Every block's mode runs
    on `device`."""
    from pyp_tpu_torch.sched.workflow import run_workflow

    paths = [a for a in argv if not a.startswith("-")
             and a.endswith(".toml")]
    if not paths:
        logger.error("usage: workflow <file.toml> [-arg value ...]")
        return 2
    def _is_number(tok):
        try:
            float(tok)
            return True
        except ValueError:
            return False

    overrides = {}
    rest = [a for a in argv if a not in paths]
    i = 0
    while i < len(rest):
        tok = rest[i]
        if tok.startswith("-") and not _is_number(tok):
            key = tok.lstrip("-")
            nxt = rest[i + 1] if i + 1 < len(rest) else None
            # a following token is this flag's value unless it is itself a
            # flag (negative numbers are values, not flags)
            if nxt is not None and (not nxt.startswith("-")
                                    or _is_number(nxt)):
                overrides[key] = nxt
                i += 2
                continue
            overrides[key] = True
        i += 1
    report = run_workflow(paths[0], overrides, extra_argv=rest,
                          device=device)
    print(json.dumps({"workflow": paths[0], "blocks": report}))
    return 0 if all(b["rc"] == 0 for b in report) else 1


def mode_stream(argv, device="cuda"):
    """Launch the on-the-fly session daemon (streampyp role): watch
    data_path for new movies, process each, incrementally re-classify, on
    `device`. With the SLURM parameters the daemon is submitted as one
    long scheduler job instead."""
    params = _project_params(argv)
    from pyp_tpu_torch.stream.daemon import SessionDaemon, SessionManager

    sessions_dir = str(params.get("stream_sessions_dir") or "")
    if sessions_dir:
        # multi-session mode: one process multiplexes every
        # {group}/{session}/session.toml under the root
        mgr = SessionManager(
            sessions_dir, defaults=params,
            poll_interval=float(params.get("stream_poll_interval") or 5.0),
            device=device)
        max_iter = params.get("stream_max_iterations")
        idle_exit = params.get("stream_idle_exit")
        results = mgr.run(
            max_iterations=int(max_iter) if max_iter else None,
            idle_exit=int(idle_exit) if idle_exit else None)
        print(json.dumps({k: len(v) for k, v in results.items()}))
        return 0
    pattern = params.get("data_path") or ""
    if not pattern:
        logger.error("stream needs -data_path <watch glob>")
        return 1
    if Path(pattern).is_dir():
        # directory + filename pattern (reference movie tab pattern /
        # source): the session watches <dir>/<movie_pattern>
        pattern = str(Path(pattern)
                      / str(params.get("movie_pattern") or "*.tif"))
    from pyp_tpu_torch.sched import bridge

    if bridge.slurm_requested(params):
        # the daemon itself runs as one long scheduler job (resources from
        # the slurm daemon tier)
        print(json.dumps(bridge.submit_daemon(params, argv), indent=1))
        return 0
    daemon = SessionDaemon(
        pattern, params,
        poll_interval=float(params.get("stream_poll_interval") or 5.0),
        classify_every=int(params.get("stream_classify_every") or 0),
        n_classes=int(params.get("class_num") or 10),
        device=device,
    )
    max_iter = params.get("stream_max_iterations")
    idle_exit = params.get("stream_idle_exit")
    daemon.run(
        max_iterations=int(max_iter) if max_iter else None,
        idle_exit=int(idle_exit) if idle_exit else None,
    )
    print(json.dumps({"processed": len(daemon.processed),
                      "classified": daemon.class_result is not None}))
    return 0


def mode_worker(argv, device="cuda"):
    """SLURM array element entry: run a serialized job payload
    ({"mode", "argv"}) with PYP_TPU_WORKER set, so it executes and never
    re-submits; the variable is restored after (the JAX package leaves it
    set, which a caller in the same process would inherit)."""
    payload = json.loads(Path(argv[0]).read_text())
    prev = os.environ.get("PYP_TPU_WORKER")
    os.environ["PYP_TPU_WORKER"] = "1"
    try:
        return main([payload["mode"]] + payload.get("argv", []),
                    device=device)
    finally:
        if prev is None:
            del os.environ["PYP_TPU_WORKER"]
        else:
            os.environ["PYP_TPU_WORKER"] = prev


PORTED = {"spr": mode_spr, "tomo": mode_tomo, "extract": mode_extract,
          "gain": mode_gain,
          "refine": mode_refine, "classify2d": mode_classify2d,
          "classify3d": mode_classify3d, "clean": mode_clean,
          "kselection": mode_kselection, "postprocess": mode_postprocess,
          "fsc": mode_fsc, "mask": mode_mask, "csp": mode_csp,
          "polish": mode_polish, "sva": mode_sva,
          "sprtrain": mode_sprtrain, "tomotrain": mode_tomotrain,
          "mine": mode_mine, "prism": mode_prism,
          "heterogeneity": mode_heterogeneity,
          "import_star": mode_import_star, "export_star": mode_export_star,
          "params": mode_params, "filter": mode_filter, "byp": mode_byp,
          "boxedit": mode_boxedit, "tomoedit": mode_tomoedit,
          "export_session": mode_export_session, "report": mode_report,
          "workflow": mode_workflow, "stream": mode_stream,
          "worker": mode_worker}


def main(argv=None, device="cuda"):
    """Entry point: `main([mode, ...], device=...)` for every mode
    (cli.PORTED). Returns the exit code; an unknown mode returns 2. With
    PYP_TPU_COORDINATOR set (a rank of the distributed refine script) the
    process first joins its torch.distributed group on `device`. A project
    file that sets `notify_mongo_uri` mirrors the log there, and
    `notify_email` mails the end of the spr, tomo, refine, csp and
    classify3d modes, as in the JAX package. With PYP_TPU_RANK_REPORT set
    to a directory, each process writes rank<r>.json there when its mode
    returns: its rank, the group's backend and the kernel launches."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    mode, rest = argv[0], argv[1:]
    if mode in PORTED:
        # a rank of a distributed run joins its group before any device
        # work (no-op for single-process runs)
        parallel.init_distributed(device=device)
        # observability (the notify tab): log mirroring and completion mail
        saved = cfg.load_parameters(".") or {}
        mongo_uri = str(saved.get("notify_mongo_uri") or "")
        if mongo_uri:
            from pyp_tpu_torch.utils.notify import attach_mongo_sink

            attach_mongo_sink(mongo_uri,
                              webid=str(saved.get("notify_webid") or ""))
        rc = PORTED[mode](rest, device=device)
        email = str(saved.get("notify_email") or "")
        rule = str(saved.get("notify_on") or "always")
        if rule == "never" or (rule == "fail" and rc == 0):
            email = ""
        if email and mode in ("spr", "tomo", "refine", "csp", "classify3d"):
            from pyp_tpu_torch.utils.notify import send_email

            send_email(email, f"pyp_tpu {mode} "
                       f"{'done' if rc == 0 else 'FAILED'}",
                       f"mode={mode} rc={rc} cwd={Path.cwd()}",
                       smtp_host=str(saved.get("notify_smtp") or "localhost"))
        if os.environ.get("PYP_TPU_RANK_REPORT"):
            _rank_report(os.environ["PYP_TPU_RANK_REPORT"], mode, rc)
        return rc
    logger.error("unknown mode %r", mode)
    return 2


def _rank_report(out_dir, mode, rc):
    """rank<r>.json in `out_dir`: this process's rank, world size and
    backend, the mode's exit code and the kernel launches it counted."""
    import torch.distributed as dist

    from pyp_tpu_torch.ops import kernels

    rank = dist.get_rank() if parallel.distributed() else 0
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "mode": mode, "rc": rc,
        "world_size": dist.get_world_size() if parallel.distributed() else 1,
        "backend": dist.get_backend() if parallel.distributed() else None,
        "launches": {"shift_scored_match":
                     kernels.shift_scored_match.launches}}))


if __name__ == "__main__":
    sys.exit(main())
