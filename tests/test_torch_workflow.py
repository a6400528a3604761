"""The port's workflow runner (`sched/workflow`) and `workflow` mode
against `pyp_tpu.sched.workflow`: block order, parent cycles, asked
arguments, negative-number overrides and the argv each block's mode gets
are the same; the project files both write are the same bytes. The one
difference is deliberate: a preprocessing block also runs `extract`
(`BLOCK_THEN`), so that the SPA tutorial's refinement finds its stack;
the JAX runner's refinement block fails there for want of stack.mrc.
Also one end-to-end run of a two-block workflow through the port's CLI on
the CPU, and one through spr + extract on a small movie."""

import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.sched import workflow as jwf
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.sched import workflow as twf

REPO = Path(__file__).resolve().parents[1]

WF = """
name = "test workflow"

[blocks.second]
blockId = "sp-filtering"
parent = "rawdata"
[blocks.second.args]
filter_name = "wf"
data_set = { ask = true }
filter_criteria = "ctf_res<8"

[blocks.rawdata]
blockId = "sp-rawdata"
[blocks.rawdata.args]
scope_pixel = 0.66
data_path = { ask = true }
plot_per_item = false
"""


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_history(monkeypatch):
    monkeypatch.setenv("PYP_TPU_NO_HISTORY", "1")


def test_parsing_is_the_same(tmp_path):
    p = tmp_path / "wf.toml"
    p.write_text(WF)
    assert twf.load_workflow(p) == jwf.load_workflow(p)
    blocks = twf.load_workflow(p)["blocks"]
    assert twf.order_blocks(blocks) == jwf.order_blocks(blocks) == [
        "rawdata", "second"]
    for mod in (twf, jwf):
        with pytest.raises(ValueError, match="cycle"):
            mod.order_blocks({"a": {"parent": "b"}, "b": {"parent": "a"}})
        with pytest.raises(ValueError, match="data_path"):
            mod.resolve_args(blocks["rawdata"], {}, "rawdata")
        with pytest.raises(ValueError, match="no \\[blocks"):
            (tmp_path / "empty.toml").write_text('name = "x"\n')
            mod.load_workflow(tmp_path / "empty.toml")
    over = {"data_path": "/x/*.tif", "data_set": "ds"}
    for key in blocks:
        assert twf.resolve_args(blocks[key], over, key) == jwf.resolve_args(
            blocks[key], over, key)
    assert twf.BLOCK_MODES == jwf.BLOCK_MODES


def _record(mod, path, overrides, extra, cwd):
    calls = []
    here = os.getcwd()
    os.chdir(cwd)
    try:
        report = mod.run_workflow(path, overrides, extra_argv=extra,
                                  runner=lambda m, a: calls.append((m, a))
                                  or 0)
    finally:
        os.chdir(here)
    return report, calls


@pytest.mark.parametrize("which", ["test", "spa_tutorial"])
def test_blocks_get_the_same_argv(which, tmp_path):
    if which == "test":
        path = tmp_path / "wf.toml"
        path.write_text(WF)
        over, extra = {"data_path": "/x/*.tif", "data_set": "ds"}, []
    else:
        path = REPO / "workflows" / "spa_tutorial.toml"
        over = {"data_path": "m/*.mrc", "scope_pixel": "1.0"}
        extra = ["-detect_rad", "45", "-no_extract_inv", "-model_path",
                 "init.mrc", "-refine_searchx", "-3.5"]
    out = {}
    for name, mod in (("jax", jwf), ("port", twf)):
        (tmp_path / name).mkdir()
        out[name] = _record(mod, path, over, extra, tmp_path / name)
    (jrep, jcalls), (trep, tcalls) = out["jax"], out["port"]
    if which == "test":
        assert (trep, tcalls) == (jrep, jcalls)
    else:
        # the port's preprocessing block also extracts, with the same argv
        assert [c for c in tcalls if c[0] != "extract"] == jcalls
        spr_argv = next(a for m, a in jcalls if m == "spr")
        assert ("extract", spr_argv) in tcalls
        assert [r["mode"] for r in trep] == [r["mode"] for r in jrep] == [
            "params", "spr", "refine", "postprocess"]
        assert trep[1]["then"] == "extract"
    # parameter-only blocks persisted the same project file
    assert (tmp_path / "port" / ".pyp_tpu_config.toml").read_bytes() == \
        (tmp_path / "jax" / ".pyp_tpu_config.toml").read_bytes()


def _cli(main, argv, cwd):
    here = os.getcwd()
    os.chdir(cwd)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(here)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1])


def test_cli_runs_the_same_two_blocks(tmp_path):
    """A parameter block with a negative-number override, then a filter
    block, through both packages' `workflow` mode: the same report, the
    same project file and the same selection."""
    from pyp_tpu.io.metadata import ItemMetadata

    wf = WF.replace("scope_pixel = 0.66", "scope_pixel = 0.66\n"
                    "tomo_rec_zshift = { ask = true }")
    out = {}
    for name, main in (("jax", jcli.main),
                       ("port", lambda a: tcli.main(a, device="cpu"))):
        root = tmp_path / name
        root.mkdir()
        (root / "wf.toml").write_text(wf)
        for i, res in enumerate((5.0, 9.0)):
            meta = ItemMetadata(f"m{i}", root, mode="spr")
            meta["ctf"] = np.array([15000.0, 14000.0, 0.0, 0.0, 0.9, res])
            meta.save()
        out[name] = _cli(main, ["workflow", "wf.toml", "-data_path",
                                "/x/*.tif", "-data_set", "ds",
                                "-tomo_rec_zshift", "-5"], root)
    assert out["port"] == out["jax"]
    rc, rep = out["port"]
    assert rc == 0 and [b["rc"] for b in rep["blocks"]] == [0, 0]
    for f in (".pyp_tpu_config.toml", "ds_wf.filter.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    sel = json.loads((tmp_path / "port" / "ds_wf.filter.json").read_text())
    assert sel["keep"] == ["m0"]
    from pyp_tpu_torch.config import params as tparams

    saved = tparams.load_parameters(tmp_path / "port")
    assert float(saved["tomo_rec_zshift"]) == -5.0


def test_preprocessing_block_extracts(tmp_path):
    """raw data -> preprocessing through the port's CLI on one 2 x 256²
    movie: `spr` writes the bundle, then `extract` the stack the next
    block would refine."""
    from pyp_tpu_torch.io import cistem, mrc

    root = tmp_path / "p"
    root.mkdir()
    rng = np.random.RandomState(0)
    img = rng.randn(2, 256, 256).astype(np.float32)
    yy, xx = np.mgrid[:256, :256]
    for cy, cx in ((80, 80), (80, 176), (176, 80), (176, 176)):
        img -= 4.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 50.0)[None]
    mrc.write(img, root / "m0.mrc", pixel_size=2.0)
    (root / "wf.toml").write_text("""
[blocks.raw]
blockId = "sp-rawdata"
[blocks.raw.args]
data_path = { ask = true }
scope_pixel = 2.0
[blocks.pre]
blockId = "sp-preprocessing"
parent = "raw"
[blocks.pre.args]
detect_rad = 10
extract_box = 32
""")
    rc, rep = _cli(lambda a: tcli.main(a, device="cpu"),
                   ["workflow", "wf.toml", "-data_path", "m0.mrc",
                    "-movie_ali", "skip", "-ctf_tile", "64", "-detect_max",
                    "8", "-no_plot_per_item"], root)
    assert rc == 0, rep
    assert rep["blocks"][1] == {"block": "pre", "mode": "spr", "rc": 0,
                                "then": "extract"}
    stack = mrc.read(root / "stack.mrc")
    table = cistem.read_parameters(root / "stack.cistem")
    assert stack.shape[1:] == (32, 32) and len(stack) == table.n_rows > 0
