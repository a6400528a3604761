"""Does `spr` give the same bits whatever the card's free memory?

Several ops split their work by `torch.cuda.mem_get_info`, and concurrent
SLURM elements on one card lower each other's free memory. This script
makes the three synthetic movies of `tools/e2e_spr` (4096², 40 frames),
runs `spr` on them in this process at full free memory, again with most
of the card held by a placeholder tensor, and through the SLURM swarm
with both array elements at once (bash runs `swarm/sprswarm.sbatch` as
the scheduler would). Each movie's average, drift, CTF and picks are held
bit for bit against the first run. One JSON line per movie and run, then
a summary; exits 1 if any differs.

    python -m pyp_tpu_torch.tools.spr_free_memory [--held 0.55 0.76]

`--held` gives the shares of the card's total memory to hold, one run
each. Needs a card.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from pyp_tpu_torch import cli
from pyp_tpu_torch.io.metadata import ItemMetadata
from pyp_tpu_torch.tools import e2e_spa, e2e_spr

# the directory the workers import the package from: this process's
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
BOTH_ELEMENTS = ('SLURM_ARRAY_TASK_ID=1 bash "$0" & a=$!; '
                 'SLURM_ARRAY_TASK_ID=2 bash "$0" & b=$!; '
                 'wait $a; ra=$?; wait $b; exit $((ra | $?))')


def _spr(argv, cwd):
    os.makedirs(cwd)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv, device="cuda")
    finally:
        os.chdir(here)
    if rc != 0:
        raise RuntimeError(f"spr in {cwd} returned {rc}")


def _compare(ref, other):
    """Differences of one movie's bundle from the reference's."""
    row = {"average_pixels_differing": int((ref["average"]
                                            != other["average"]).sum()),
           "average_max_abs_diff": float(np.abs(ref["average"]
                                                - other["average"]).max()),
           "drift_equal": bool(np.array_equal(ref["drift"], other["drift"])),
           "ctf_equal": bool(np.array_equal(ref["ctf"], other["ctf"])),
           "picks_equal": bool(np.array_equal(ref["box"], other["box"]))}
    scores = np.sort(ref["box"][:, 2])
    row["closest_scores_apart"] = (float(np.diff(scores).min())
                                   if len(scores) > 1 else None)
    row["equal"] = (row["average_pixels_differing"] == 0 and row["drift_equal"]
                    and row["ctf_equal"] and row["picks_equal"])
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--held", type=float, nargs="*", default=[0.55, 0.76],
                    help="shares of the card's memory to hold, a run each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as root:
        return 0 if _check(root, args.held) else 1


def _check(root, shares):
    """Run `spr` at each held share and as the swarm under `root`; print
    the rows; True when every run equals the first."""
    movies = os.path.join(root, "movies")
    volume = e2e_spa.phantom(np.random.RandomState(0), 128, 1.0, 5.0, "cuda")
    kw = {k: v for k, v in e2e_spr.MOVIES.items() if k != "n_movies"}
    e2e_spr.write_movies(movies, volume, n_movies=e2e_spr.MOVIES["n_movies"],
                         device="cuda", **kw)
    spr_argv = e2e_spr.SPR_ARGS + ["-data_path",
                                   os.path.join(movies, "movie_*.mrc")]
    total = torch.cuda.mem_get_info()[1]
    runs = {}
    for share in [0.0] + list(shares):
        torch.cuda.empty_cache()
        held = (torch.empty(int(share * total), dtype=torch.uint8,
                            device="cuda") if share else None)
        name = f"held_{share:.2f}"
        runs[name] = torch.cuda.mem_get_info()[0] / 2 ** 30
        _spr(spr_argv, os.path.join(root, name))
        del held
    torch.cuda.empty_cache()
    swarm = os.path.join(root, "swarm_both_at_once")
    _spr(spr_argv + ["-slurm_queue", "q", "-slurm_bundle", "2"], swarm)
    subprocess.run(["bash", "-c", BOTH_ELEMENTS, "swarm/sprswarm.sbatch"],
                   cwd=swarm, check=True,
                   env={**os.environ, "PYTHONPATH": PACKAGE_ROOT})
    runs[os.path.basename(swarm)] = None
    names = sorted(f[:-4] for f in os.listdir(movies) if f.endswith(".mrc"))
    ref_run = next(iter(runs))
    all_equal = True
    for movie in names:
        ref = ItemMetadata(movie, os.path.join(root, ref_run)).load()
        for run, free in list(runs.items())[1:]:
            row = _compare(ref, ItemMetadata(movie, os.path.join(root, run))
                           .load())
            all_equal &= row["equal"]
            print(json.dumps({"movie": movie, "run": run,
                              "free_GiB": free, **row}), flush=True)
    print(json.dumps({"reference": ref_run, "free_GiB": runs,
                      "all_equal": all_equal}), flush=True)
    return all_equal


if __name__ == "__main__":
    sys.exit(main())
