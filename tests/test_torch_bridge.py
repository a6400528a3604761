"""SLURM in the port (`pyp_tpu_torch/sched/bridge.py`, the SLURM half of
`sched/executor.py`, the `worker` mode): the JAX package's emission
scenarios (tests/test_bridge.py) run through both CLIs, each in its own
project directory — the `spr`, `tomo` and `csp` swarms, the `sprtrain`
and `tomotrain` jobs, the stream daemon's job and the distributed
`refine` script. Every .sbatch, .swarm and payload text must be the JAX
package's once the directory and the module name are replaced; the only
other difference allowed is the distributed script's rank-per-card lines.
Also: `worker` runs an emitted payload, the walltime helpers agree with
JAX's, and `polish` and `sva` ignore the SLURM parameters, as in the JAX
package."""

import json
import os

import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.sched import bridge as jbridge
from pyp_tpu.sched import executor as jexec
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.io import mrc as tmrc
from pyp_tpu_torch.io.metadata import ItemMetadata
from pyp_tpu_torch.sched import bridge as tbridge
from pyp_tpu_torch.sched import executor as texec

SLURM = ["-slurm_queue", "gpuq", "-slurm_bundle", "2", "-slurm_gres",
         "tpu:1"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_movie(path, n=32, frames=3, seed=0):
    rng = np.random.RandomState(seed)
    tmrc.write(rng.rand(frames, n, n).astype(np.float32), path)


def _inputs(root, mode):
    """The files a scenario discovers: three movies, series or tilt stacks
    (the swarms route before reading them)."""
    stem = {"spr": "mov", "tomo": "ts", "csp": "ts"}.get(mode)
    if stem:
        for i in range(3):
            _write_movie(root / f"{stem}_{i}.mrc", seed=i)
        return ["-data_path", str(root / f"{stem}_*.mrc")]
    if mode == "stream":
        (root / "watch").mkdir()
        return ["-data_path", str(root / "watch" / "*.tif")]
    return []


def _emit(cli, root, argv, monkeypatch, **kw):
    root.mkdir()
    monkeypatch.chdir(root)
    argv = [argv[0]] + _inputs(root, argv[0]) + argv[1:]
    assert cli.main(argv, **kw) == 0
    out = {}
    for p in sorted((root / "swarm").iterdir()):
        text = p.read_text().replace(str(root), "<DIR>").replace(
            "pyp_tpu_torch.cli", "pyp_tpu.cli")
        out[p.name] = json.loads(text) if p.suffix == ".json" else text
    return out


SCENARIOS = {
    "spr": ["spr"] + SLURM,
    "tomo": ["tomo"] + SLURM + ["-slurm_tomo_walltime", "2:00:00"],
    "csp": ["csp", "-slurm_queue", "q", "-slurm_merge_memory", "64",
            "-slurm_max_cpus", "8", "-slurm_tasks", "2"],
    "sprtrain": ["sprtrain", "-slurm_queue", "q", "-slurm_train_gres",
                 "gpu:1", "-slurm_queue_gpu", "gq", "-train_steps", "5"],
    "tomotrain": ["tomotrain", "-slurm_submit", "-slurm_train_walltime",
                  "3:00:00"],
    "stream": ["stream", "-slurm_queue", "q", "-slurm_daemon_memory", "8"],
    "refine": ["refine", "-slurm_queue", "q", "-slurm_nodes", "2",
               "-refine_dang", "5"],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scripts_and_payloads_are_the_jax_packages(scenario, tmp_path,
                                                   monkeypatch):
    monkeypatch.delenv("PYP_TPU_WORKER", raising=False)
    argv = SCENARIOS[scenario]
    jout = _emit(jcli, tmp_path / "jax", argv, monkeypatch)
    tout = _emit(tcli, tmp_path / "port", argv, monkeypatch, device="cpu")
    assert sorted(tout) == sorted(jout)
    if "refinedist.sbatch" in tout:
        # the named difference: one rank per card (with no gpu:N in the
        # gres, one rank per node, as the JAX package's script has)
        tout["refinedist.sbatch"] = tout["refinedist.sbatch"].replace(
            "#SBATCH --ntasks-per-node=1\n", "").replace(
            " PYP_TPU_LOCAL_RANK=$SLURM_LOCALID", "")
    assert tout == jout
    if scenario == "spr":
        # 3 movies in elements of 2, each element a worker of the port
        assert "#SBATCH --array=1-2" in tout["sprswarm.sbatch"]
        cmds = (tmp_path / "port" / "swarm" / "sprswarm.swarm").read_text()
        assert cmds.count("-m pyp_tpu_torch.cli worker ") == 3


def test_distributed_refine_script_places_one_rank_per_card(tmp_path,
                                                            monkeypatch):
    """The JAX package's script but for the module and the rank-per-card
    lines: 2 nodes x 4 cards = 8 ranks, each pinning its SLURM_LOCALID."""
    argv = ["refine", "-slurm_queue", "q", "-slurm_nodes", "2",
            "-slurm_gres", "gpu:4"]
    jout = _emit(jcli, tmp_path / "jax", argv, monkeypatch)
    tout = _emit(tcli, tmp_path / "port", argv, monkeypatch, device="cpu")
    assert tout["refine_dist.json"] == jout["refine_dist.json"]
    jl = jout["refinedist.sbatch"].splitlines()
    tl = tout["refinedist.sbatch"].splitlines()
    assert "#SBATCH --ntasks=2" in jl
    assert "#SBATCH --ntasks=8" in tl and "#SBATCH --ntasks-per-node=4" in tl
    srun = [x for x in tl if x.startswith("srun ")]
    assert len(srun) == 1 and "PYP_TPU_LOCAL_RANK=$SLURM_LOCALID" in srun[0]
    assert srun[0].replace(" PYP_TPU_LOCAL_RANK=$SLURM_LOCALID", "") in jl

    def rest(lines):
        return [x for x in lines if not x.startswith(("#SBATCH --ntasks",
                                                      "srun "))]
    assert rest(tl) == rest(jl)
    assert tbridge.ranks_per_node({"slurm_gres": "gpu:h100:2"}) == 2
    assert tbridge.ranks_per_node({"slurm_gres": "tpu:1"}) == 1


def test_worker_runs_a_payload(tmp_path, monkeypatch):
    """The emitted element of one 32² movie, run by `worker`: the movie's
    bundle is written here, and nothing is submitted again."""
    monkeypatch.delenv("PYP_TPU_WORKER", raising=False)
    monkeypatch.chdir(tmp_path)
    _write_movie(tmp_path / "mov_0.mrc")
    assert tcli.main(["spr", "-data_path", str(tmp_path / "mov_*.mrc"),
                      "-scope_pixel", "1.0"] + SLURM, device="cpu") == 0
    assert not list(tmp_path.glob("*.meta.npz"))
    # the worker marks its process while it runs (the project file keeps
    # slurm_queue), and unmarks it after
    monkeypatch.setenv("PYP_TPU_WORKER", "")
    assert tcli.main(["worker", str(tmp_path / "swarm" / "spr_00000.json")],
                     device="cpu") == 0
    assert os.environ["PYP_TPU_WORKER"] == ""
    assert (tmp_path / "mov_0.meta.npz").exists()
    assert ItemMetadata("mov_0", tmp_path).load().is_done("average")
    assert sorted(p.name for p in (tmp_path / "swarm").iterdir()) == [
        "spr_00000.json", "spr_merge.json", "sprmerge.sbatch",
        "sprmerge.swarm", "sprswarm.sbatch", "sprswarm.swarm"]


@pytest.mark.parametrize("walltime", [
    "24:00:00", "4:00:00", "30:00", "45", "2-12:30:00", "0-00:01:00",
    "7-00:00:00"])
def test_walltime_helpers_agree(walltime):
    assert texec.get_total_seconds(walltime) == \
        jexec.get_total_seconds(walltime)
    s = texec.get_total_seconds(walltime)
    assert texec.format_walltime(s) == jexec.format_walltime(s)
    for n, bundle in ((1, 1), (40, 2), (3, 7)):
        assert texec.scale_walltime(walltime, n, bundle) == \
            jexec.scale_walltime(walltime, n, bundle)


def test_slurm_requested_and_flags_are_the_jax_packages(monkeypatch):
    monkeypatch.delenv("PYP_TPU_WORKER", raising=False)
    argv = ["-data_path", "x/*.mrc", "-slurm_queue", "gpuq", "-slurm_submit",
            "-refine_dang", "5", "-slurm_nodes", "4", "-no_slurm_verbose"]
    assert tbridge.strip_slurm_flags(argv) == jbridge.strip_slurm_flags(argv)
    for p in ({"slurm_queue": "q"}, {"slurm_host": "h"}, {}):
        assert tbridge.slurm_requested(p) == jbridge.slurm_requested(p)
    assert tcli.slurm_requested is tbridge.slurm_requested
    monkeypatch.setenv("PYP_TPU_WORKER", "1")
    assert not tbridge.slurm_requested({"slurm_queue": "q"})


def _tomogram(root):
    """A 48³ tomogram with four 3D picks, for `sva`."""
    root.mkdir()
    rng = np.random.RandomState(3)
    tmrc.write(rng.randn(48, 48, 48).astype(np.float32),
               root / "ts01.rec.mrc")
    meta = ItemMetadata("ts01", root, mode="tomo")
    meta["box"] = np.array([[16, 16, 16], [24, 30, 20], [30, 20, 28],
                            [20, 28, 30]], np.float32)
    meta.save()


def test_polish_and_sva_ignore_the_slurm_parameters(tmp_path, monkeypatch):
    """As in the JAX package, `polish` and `sva` run here with the SLURM
    parameters set: `sva` writes the same average as without them, and in
    an empty project both modes fail as the JAX package's do, with no
    script written."""
    monkeypatch.delenv("PYP_TPU_WORKER", raising=False)
    args = ["-sva_box", "16", "-sva_iters", "1", "-sva_ang", "60",
            "-sva_shift", "2", "-scope_pixel", "2.0"]
    avg = {}
    for label, extra in (("local", []), ("slurm", SLURM)):
        _tomogram(tmp_path / label)
        monkeypatch.chdir(tmp_path / label)
        assert tcli.main(["sva"] + args + extra, device="cpu") == 0
        avg[label] = tmrc.read(tmp_path / label / "dataset_sva.mrc")
        assert not (tmp_path / label / "swarm").exists()
    np.testing.assert_array_equal(avg["slurm"], avg["local"])
    # an empty project: polish finds no stack.cistem, sva no tomogram
    for cli, kw in ((jcli, {}), (tcli, {"device": "cpu"})):
        for mode in ("polish", "sva"):
            work = tmp_path / f"{mode}_{cli.__name__}"
            work.mkdir()
            monkeypatch.chdir(work)
            if mode == "polish":
                with pytest.raises(FileNotFoundError, match="stack.cistem"):
                    cli.main([mode] + SLURM, **kw)
            else:
                assert cli.main([mode] + SLURM, **kw) == 1
            assert not (work / "swarm").exists()
