"""Workflow runner: pre-defined sequences of blocks from .toml files.

The reference's Workflows feature (docs/guide/workflows.rst) executes a
block graph defined in TOML — each block names a blockId, an optional
parent, and an args table whose `{ ask = true }` entries are filled in at
import time. Here the same files drive the CLI: each block resolves to a
`pyp_tpu_torch` mode, blocks run in dependency order in the project
directory, and ask-args come from command-line overrides. The port of
pyp_tpu/sched/workflow.py; the modes run on `device` ("cuda" unless the
caller asks for the CPU), and a preprocessing block also extracts its
particles (`BLOCK_THEN`), which the JAX package's runner does not, so
that a refinement block after it finds its stack.

Example (the docs' own shape):

    name = "Test workflow"
    [blocks.rawdata]
    blockId = "sp-rawdata"
    [blocks.rawdata.args]
    data_path = { ask = true }
    scope_pixel = 0.66

    [blocks.preprocessing]
    blockId = "sp-preprocessing"
    parent = "rawdata"
    [blocks.preprocessing.args]
    detect_rad = 75
"""

from __future__ import annotations

import tomllib

# blockId -> CLI mode (None = parameter-only block, e.g. raw data).
# sp-/tomo- ids follow the documented naming; a block may also set
# `mode = "..."` explicitly to bypass the registry.
BLOCK_MODES = {
    "sp-rawdata": None,
    "tomo-rawdata": None,
    "sp-preprocessing": "spr",
    "tomo-preprocessing": "tomo",
    "sp-coarse-refinement": "refine",
    "sp-refinement": "refine",
    "sp-fine-refinement": "refine",
    "sp-classification": "classify2d",
    "sp-3d-classification": "classify3d",
    "tomo-picking": "tomo",
    "tomo-segmentation": "tomo",
    "tomo-refinement": "csp",
    "tomo-coarse-refinement": "csp",
    "sp-masking": "mask",
    "tomo-masking": "mask",
    "sp-postprocessing": "postprocess",
    "tomo-postprocessing": "postprocess",
    "sp-filtering": "filter",
    "tomo-filtering": "filter",
    "sp-heterogeneity": "heterogeneity",
    "tomo-heterogeneity": "heterogeneity",
}
# blockId -> the mode that runs after the block's own when that returned
# 0, with the same arguments: nextPYP's single-particle preprocessing
# block ends with extracted particles, and `spr` alone writes none
BLOCK_THEN = {"sp-preprocessing": "extract"}


def load_workflow(path) -> dict:
    with open(path, "rb") as f:
        wf = tomllib.load(f)
    if "blocks" not in wf or not wf["blocks"]:
        raise ValueError(f"workflow {path} has no [blocks.*]")
    return wf


def order_blocks(blocks: dict) -> list:
    """Topological order honoring `parent` links; file order breaks ties."""
    done, ordered = set(), []
    pending = list(blocks)
    while pending:
        progressed = False
        for key in list(pending):
            parent = blocks[key].get("parent")
            if parent is None or parent in done:
                ordered.append(key)
                done.add(key)
                pending.remove(key)
                progressed = True
        if not progressed:
            raise ValueError(
                f"workflow parent cycle or missing parent among {pending}")
    return ordered


def resolve_args(block: dict, overrides: dict, block_key: str) -> dict:
    """Materialize a block's args; `{ ask = true }` entries must be
    supplied in `overrides` (by arg name)."""
    out = {}
    missing = []
    for k, v in (block.get("args") or {}).items():
        if isinstance(v, dict) and v.get("ask"):
            if k in overrides:
                out[k] = overrides[k]
            else:
                missing.append(k)
        else:
            out[k] = v
    if missing:
        raise ValueError(
            f"block {block_key!r} needs values for {missing} "
            f"(pass -{missing[0]} ... on the command line)")
    return out


def run_workflow(path, overrides: dict, runner=None,
                 extra_argv=None, device="cuda") -> list:
    """Execute every block in order. Returns a per-block report list.

    runner(mode, argv) defaults to the port's CLI dispatcher on `device`
    (which raises without a card unless the caller asks for the CPU);
    parameter-only blocks persist their args to the project so later
    blocks inherit them."""
    from pyp_tpu_torch import cli as cli_mod
    from pyp_tpu_torch import resolve_device
    from pyp_tpu_torch.config import params as cfg

    if runner is None:
        resolve_device(device)
        runner = lambda mode, argv: cli_mod.main(  # noqa: E731
            [mode] + argv, device=device)
    wf = load_workflow(path)
    blocks = wf["blocks"]
    report = []
    for key in order_blocks(blocks):
        block = blocks[key]
        args = resolve_args(block, overrides, key)
        bid = str(block.get("blockId") or "")
        mode = block.get("mode", BLOCK_MODES.get(bid, "__unknown__"))
        if mode == "__unknown__":
            raise ValueError(
                f"block {key!r}: unknown blockId {bid!r} and no explicit "
                f"mode; known: {sorted(BLOCK_MODES)}")
        argv = []
        for k, v in args.items():
            if isinstance(v, bool):
                argv += [f"-{k}"] if v else [f"-no_{k}"]
            else:
                argv += [f"-{k}", str(v)]
        if mode is None:
            # parameter-only block: persist args for downstream blocks
            cfg.update_parameters(".", args)
            report.append({"block": key, "mode": "params",
                           "args": len(args), "rc": 0})
            continue
        argv = argv + list(extra_argv or [])
        rc = runner(mode, argv)
        row = {"block": key, "mode": mode, "rc": int(rc)}
        then = BLOCK_THEN.get(bid) if "mode" not in block else None
        if not rc and then:
            rc = runner(then, argv)
            row.update(then=then, rc=int(rc))
        report.append(row)
        if rc:
            break
    return report
