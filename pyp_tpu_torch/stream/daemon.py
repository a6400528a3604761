"""On-the-fly session daemon: watch, process, incrementally classify.

Rebuild of the reference's streaming layer (stream/pyp_daemon.py:65
`pyp_daemon`: watch the microscope output directory, transfer/compress new
movies, launch per-file processing; stream/fyp_daemon.py:765 `fyp_daemon`:
accumulate new particles and update 2D classes incrementally). Single
process, poll-based; each new file runs the same per-micrograph pipeline as
batch mode, and every `classify_every` new micrographs the accumulated
particle stack is re-classified (three iterations after the first pass's
six).

The port of pyp_tpu/stream/daemon.py: the daemon and the session manager
run the port's pipelines on `device` ("cuda" unless the caller asks for
the CPU; without a card they raise). Without matplotlib the class montage
is skipped with a warning and the occupancies are pushed with no image.
"""

from __future__ import annotations

import glob
import time
from pathlib import Path

import numpy as np

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.utils import get_logger

logger = get_logger("stream")


class SessionDaemon:
    def __init__(self, watch_pattern: str, params: dict, work_dir=".",
                 poll_interval: float = 5.0, classify_every: int = 0,
                 n_classes: int = 10, device="cuda"):
        self.device = resolve_device(device)
        self.watch_pattern = watch_pattern
        self.params = params
        self.work_dir = Path(work_dir)
        self.poll_interval = poll_interval
        # class2d tab streaming thresholds ([tabs.class2d], the fyp_daemon
        # accumulation contract): enable switches incremental 2D on, `min`
        # particles gate the first run, `inc` new particles space re-runs
        self.class2d_enable = bool(params.get("class2d_enable"))
        if self.class2d_enable and not classify_every:
            classify_every = 1  # particle thresholds drive the cadence
        self.classify_every = classify_every
        self.classify_min_particles = int(params.get("class2d_min") or 0)
        self.classify_inc_particles = int(params.get("class2d_inc") or 0)
        self._last_classify_particles = 0
        self.n_classes = int(params.get("class2d_num")
                             or params.get("stream_classes") or n_classes)
        self.processed: set[str] = set()
        self._raw_by_name: dict[str, str] = {}  # item -> raw path (retention)
        # item -> original watch-dir path: with transfer_operation=copy/link
        # the original stays in the watch dir and must re-enter `processed`
        # after a clear/restart reprocess, or scan() double-ingests it
        self._watch_by_name: dict[str, str] = {}
        self._settle: dict = {}  # path -> consecutive stable-size polls
        self.summaries: list[dict] = []
        self._last_classify_count = 0
        self.class_result = None
        from pyp_tpu_torch.stream.params import ParamsWatcher

        # live-retune protocol: the web platform (or operator) can drop/
        # update a session params file; changes merge in between polls
        # (streampyp/params.py role)
        self._params_watcher = ParamsWatcher(work_dir)
        # session metadata store (streampyp metadb daemon role)
        self.metadb = None
        self._db_ids = (str(params.get("stream_group") or "group"),
                        str(params.get("data_set") or "session"))
        uri = str(params.get("stream_metadb") or "")
        if uri:
            from pyp_tpu_torch.stream.metadb import MetaDB

            self.metadb = MetaDB(uri)
            self.metadb.write_session(*self._db_ids, {
                "pattern": watch_pattern, "status": "running",
            })

    def scan(self):
        """New files, oldest first, skipping ones still being written
        (size must be stable across two stats)."""
        new = []
        for path in sorted(glob.glob(self.watch_pattern)):
            if path in self.processed:
                continue
            p = Path(path)
            try:
                s1 = p.stat().st_size
                time.sleep(0.01)
                s2 = p.stat().st_size
            except FileNotFoundError:
                continue
            if s1 != s2 or s1 == 0:
                self._settle.pop(path, None)
                continue  # still transferring
            need = int(self.params.get("stream_settle_polls") or 1)
            seen = self._settle.get(path, 0) + 1
            if seen < need:
                self._settle[path] = seen
                continue  # stable, but not for long enough yet
            self._settle.pop(path, None)
            new.append(path)
        return new

    def process_one(self, path: str) -> dict:
        watch_path = path  # scan() matches THIS path — mark it processed even
        # when the transfer step rebinds `path` to the destination (copy/link
        # leave the original in the watch dir, which must not re-match)
        # transfer step (reference pyp_daemon: move off the microscope-side
        # watch dir before touching the data, stream/pyp_daemon.py:65)
        tdir = str(self.params.get("stream_transfer_dir") or "")
        if tdir:
            import shutil

            src_size = Path(path).stat().st_size
            Path(tdir).mkdir(parents=True, exist_ok=True)
            dst = Path(tdir) / Path(path).name
            # move/copy/link (reference stream tab transfer_operation;
            # link keeps the microscope-side copy and costs no IO)
            op = str(self.params.get("stream_transfer_operation") or "move")
            if op == "copy":
                shutil.copy2(path, dst)
            elif op == "link":
                if dst.exists():
                    dst.unlink()
                try:
                    dst.hardlink_to(path)
                except OSError:  # cross-device: fall back to symlink
                    dst.symlink_to(Path(path).resolve())
            else:
                shutil.move(path, dst)
            if (self.params.get("stream_transfer_verify")
                    and dst.stat().st_size != src_size):
                raise OSError(
                    f"transfer verification failed for {dst}: "
                    f"{dst.stat().st_size} != {src_size} bytes")
            path = str(dst)
        # name normalization: reprocessing after stream_compress feeds
        # 'foo.mrc.bz2' — strip the archive suffix BEFORE taking the stem so
        # the item keeps its original identity ('foo', not 'foo.mrc') and the
        # restart invalidation that just refreshed foo.meta.npz is consulted
        base = path[: -len(".bz2")] if path.endswith(".bz2") else path
        item = {"name": Path(base).stem, "path": path}
        # session mode (data_mode): tomo sessions assemble + process a
        # tilt-series per mdoc (or by file count when the session declares
        # its tilt scheme up front); spr sessions preprocess one micrograph
        num_tilts = int(self.params.get("stream_num_tilts") or 1)
        if (str(self.params.get("data_mode") or "spr") == "tomo"
                and path.endswith(".mdoc")):
            from pyp_tpu_torch.pipeline import tomo as tomo_pipe

            item.update(tomo_pipe.assemble_tilt_series(
                path, self.params, device=self.device))
            summary = tomo_pipe.process_tilt_series(
                item, self.params, self.work_dir, device=self.device)
        elif (str(self.params.get("data_mode") or "spr") == "tomo"
              and num_tilts > 1):
            # mdoc-less session: the scheme comes from the session params
            # (reference stream tab num_tilts / tilt_angles / tilt_order)
            done = self._collect_tilt(path, num_tilts)
            if done is None:
                self.processed.add(watch_path)
                return {"name": item["name"], "pending_tilts": True}
            from pyp_tpu_torch.pipeline import tomo as tomo_pipe

            summary = tomo_pipe.process_tilt_series(
                done, self.params, self.work_dir, device=self.device)
        else:
            from pyp_tpu_torch.pipeline import spr

            summary = spr.process_micrograph(item, self.params, self.work_dir,
                                             device=self.device)
        self.processed.add(watch_path)
        self.summaries.append(summary)
        self._raw_by_name[item["name"]] = path
        self._watch_by_name[item["name"]] = watch_path
        if self.metadb is not None:
            self.metadb.write_micrograph(*self._db_ids, item["name"], {
                k: v for k, v in summary.items()
                if isinstance(v, (int, float, str, bool))
            })
        if self.params.get("stream_compress") and Path(path).suffix in (
                ".mrc", ".tif", ".tiff", ".dm4"):
            # archive the raw movie (the reference's pbzip2 compression,
            # inout/image/core.py:1338); load_movie reads .bz2 directly
            import bz2

            with open(path, "rb") as f_in, bz2.open(path + ".bz2", "wb",
                                                    compresslevel=1) as f_out:
                f_out.write(f_in.read())
            Path(path).unlink()
        logger.info("stream: processed %s (%d particles)", item["name"],
                    summary.get("particles", 0))
        return summary

    def _collect_tilt(self, path: str, num_tilts: int):
        """Accumulate mdoc-less session tilts; return the assembled item
        once a series has all `num_tilts` files, else None. Series key =
        file stem with its trailing tilt counter stripped; angles come
        from stream_tilt_angles, acquisition order from stream_tilt_order
        (base-0, maps arrival order -> angle index)."""
        import re

        if not hasattr(self, "_pending_tilts"):
            self._pending_tilts = {}
        key = re.sub(r"[_\-][0-9]+$", "", Path(path).stem)
        group = self._pending_tilts.setdefault(key, [])
        group.append(path)
        if len(group) < num_tilts:
            logger.info("stream: %s tilt %d/%d collected", key,
                        len(group), num_tilts)
            return None
        del self._pending_tilts[key]
        angles_raw = str(self.params.get("stream_tilt_angles") or "")
        if angles_raw:
            angles = np.asarray([float(a) for a in angles_raw.split(",")],
                                dtype=np.float32)[:num_tilts]
        else:  # symmetric scheme fallback
            angles = np.linspace(-60.0, 60.0, num_tilts).astype(np.float32)
        order_raw = str(self.params.get("stream_tilt_order") or "")
        order = ([int(o) for o in order_raw.split(",")][:num_tilts]
                 if order_raw else list(range(num_tilts)))
        from pyp_tpu_torch.pipeline.spr import load_movie

        tilt_imgs = [None] * num_tilts
        tilt_angles = [0.0] * num_tilts
        for arrival, p in enumerate(group):
            idx = order[arrival] if arrival < len(order) else arrival
            frames = load_movie(p, self.params)
            tilt_imgs[idx] = np.asarray(frames, dtype=np.float32).mean(0)
            tilt_angles[idx] = float(angles[idx]) if idx < len(angles) else 0.0
        srt = np.argsort(np.asarray(tilt_angles))
        stack = np.stack([tilt_imgs[i] for i in srt])
        return {"name": key, "tilts": stack,
                "angles": np.asarray(tilt_angles, dtype=np.float32)[srt],
                "order": np.asarray(srt, dtype=np.float32)}

    def maybe_classify(self):
        """Incremental 2D classification over everything processed so far
        (the fyp_daemon role)."""
        if not self.classify_every:
            return None
        if len(self.summaries) - self._last_classify_count < self.classify_every:
            return None
        total_particles = sum(s.get("particles", 0) or 0
                              for s in self.summaries)
        if self.class2d_enable:
            if total_particles < self.classify_min_particles:
                return None
            if (self.classify_inc_particles and self._last_classify_particles
                    and total_particles - self._last_classify_particles
                    < self.classify_inc_particles):
                return None
        from pyp_tpu_torch.pipeline import spr as spr_pipe
        from pyp_tpu_torch.ops import refine2d
        from pyp_tpu_torch.pipeline.refine import table_to_ctf_params

        items = [{"name": s["name"]} for s in self.summaries]
        stack, table = spr_pipe.extract_stack(items, self.params, self.work_dir,
                                              out_stack="stream_stack.mrc",
                                              device=self.device)
        # class2d_min gates only the particle-threshold protocol; the plain
        # classify_every cadence needs just enough particles for the classes
        min_particles = (self.classify_min_particles if self.class2d_enable
                         else 0)
        if stack is None or len(stack) < max(
                self.n_classes * 2, min_particles):
            return None
        res = refine2d.classify2d(
            stack, table_to_ctf_params(table), self.n_classes,
            float(self.params["scope_pixel"]),
            iters=3 if self.class_result is not None else 6,
            high_res=float(self.params.get("class_rhcls") or 10.0),
            device=self.device,
        )
        self.class_result = res
        self._last_classify_count = len(self.summaries)
        self._last_classify_particles = total_particles
        from pyp_tpu_torch.analysis.plots import class_montage

        occupancy = res.occupancy.cpu().numpy()
        montage_path = self.work_dir / "stream_classes.png"
        try:
            class_montage(res.class_avgs.cpu().numpy(), montage_path,
                          occupancy=occupancy)
        except ImportError:
            # no matplotlib: the occupancies go out without an image
            logger.warning("stream: matplotlib is not installed; the class "
                           "montage is skipped")
            montage_path = ""
        # website contact-sheet push (the fyp_daemon montage update,
        # stream/fyp_daemon.py:406/:1268 -> Web.write_classes); the Web
        # client journals when no host is configured
        if not hasattr(self, "_web"):
            from pyp_tpu_torch.stream.web import Web

            self._web = Web(
                host=str(self.params.get("web_host") or "") or None,
                token=str(self.params.get("web_token") or "") or None)
        self._web.write_classes(
            str(self.params.get("data_set") or "session"),
            montage_path, occupancy.tolist())
        if self.metadb is not None:
            self.metadb.write_twod_classes(*self._db_ids, {
                "n_classes": int(self.n_classes),
                "occupancy": occupancy.tolist(),
                "particles": int(len(stack)),
            })
        logger.info("stream: updated %d classes from %d particles",
                    self.n_classes, len(stack))
        return res

    # ---- session control flags (reference pyp_daemon pypd.* protocol) ----
    # The web platform drops flag files into the session dir to control a
    # running daemon (stream/pyp_daemon.py:102-105 start/stop/clear/restart):
    #   pypd.stop     -> finish the current item and exit
    #   pypd.restart  -> re-read params (the flag file itself may carry a
    #                    TOML of new values), diff against the live set, and
    #                    invalidate exactly the stages whose params changed
    #                    so affected items reprocess (parameter_force_check +
    #                    clean_pkl_items roles)
    #   pypd.clear    -> wipe every derived product (metadata bundles,
    #                    stacks, montages), keep raw data, reprocess all
    # pypd.start is raised by the daemon itself once the watch loop is live.

    _FORCE_PREFIXES = (
        # changed param prefix -> the stage force flag it implies
        ("movie_", "movie_force"), ("ctf_", "ctf_force"),
        ("detect_", "detect_force"), ("tomo_rec_", "tomo_rec_force"),
        ("tomo_ali_", "tomo_ali_force"), ("tomo_vir_", "tomo_vir_force"),
        ("tomo_denoise_", "tomo_denoise_force"), ("tomo_mem_", "tomo_mem_force"),
        # stages present in the ItemMetadata schemas that a pypd.restart
        # param change must also invalidate (SPR 'denoised'; tomo spk picks)
        ("denoise_", "denoise_force"), ("tomo_spk_", "tomo_spk_force"),
    )

    def _flag(self, name: str) -> Path:
        return self.work_dir / f"pypd.{name}"

    def check_flags(self) -> bool:
        """Handle control-flag files; True means the daemon should exit."""
        if self._flag("stop").exists():
            logger.info("stream: stop flag detected — exiting")
            try:
                self._flag("stop").unlink()
            except OSError:
                pass
            if self.metadb is not None:
                self.metadb.write_session(*self._db_ids, {"status": "stopped"})
            return True
        if self._flag("restart").exists():
            self._do_restart()
        if self._flag("clear").exists():
            self._do_clear()
        return False

    def _do_restart(self):
        flag = self._flag("restart")
        new: dict = {}
        try:
            text = flag.read_text()
            if text.strip():
                import tomllib

                new = tomllib.loads(text)
        except Exception as e:  # noqa: BLE001 — malformed flag = plain restart
            logger.warning("stream: restart flag unreadable (%s)", e)
        changed = {k for k, v in new.items()
                   if self.params.get(k) != v and not k.endswith("_force")}
        self.params = {**self.params, **new}
        # a changed stage parameter implies that stage's force flag
        # (project_params.parameter_force_check role)
        forces = {f for k in changed
                  for pre, f in self._FORCE_PREFIXES if k.startswith(pre)}
        forces |= {k for k, v in new.items() if k.endswith("_force") and v}
        if forces:
            self._invalidate({f: True for f in forces})
        # force flags are one-shot: never leave them armed for the next poll
        for f in forces:
            self.params[f] = False
        try:
            flag.unlink()
        except OSError:
            pass
        logger.info("stream: restart applied (%d changed params, "
                    "invalidated: %s)", len(changed),
                    ",".join(sorted(forces)) or "nothing")

    def _invalidate(self, force_params: dict):
        """Drop the invalidated stages from every processed item's metadata
        bundle, then reprocess (clean_pkl_items role — the surviving entries
        resume via is_done, so only the invalidated stages recompute)."""
        from pyp_tpu_torch.io.metadata import ItemMetadata

        mode = str(self.params.get("data_mode") or "spr")
        for s in list(self.summaries):
            name = s.get("name")
            if not name:
                continue
            meta = ItemMetadata(name, self.work_dir, mode=mode).load()
            dropped = meta.refresh(force_params)
            if dropped:
                meta.save()
        self._reprocess_all()

    def _reprocess_all(self):
        """Re-run process_one over every known raw file. The scan glob can't
        requeue them (a move-mode transfer took them out of the watch dir),
        so the restart/clear paths drive reprocessing directly. Limitation:
        mdoc-less multi-file tilt series re-collect only if all their tilt
        files are re-fed, so those sessions reprocess per-mdoc/spr items only."""
        raws = dict(self._raw_by_name)
        watches = dict(self._watch_by_name)
        self.summaries.clear()
        self._raw_by_name.clear()
        self._watch_by_name.clear()
        self._last_classify_count = 0
        self._last_classify_particles = 0
        saved = str(self.params.get("stream_transfer_dir") or "")
        self.params["stream_transfer_dir"] = ""  # already transferred
        try:
            for name, raw in raws.items():
                p = Path(raw)
                if not p.exists() and Path(str(p) + ".bz2").exists():
                    p = Path(str(p) + ".bz2")  # post-processing compression
                if not p.exists():
                    continue
                try:
                    self.process_one(str(p))
                except Exception as e:  # noqa: BLE001
                    logger.warning("stream: reprocess failed on %s: %s",
                                   name, e)
                # copy/link transfers leave the ORIGINAL in the watch dir;
                # reprocessing ran on the destination, so re-mark the watch
                # path as processed or the next scan() ingests every item a
                # second time (duplicate summaries / doubled particle counts)
                w = watches.get(name)
                if w and w != str(p) and Path(w).exists():
                    self.processed.add(w)
                    self._watch_by_name[name] = w
        finally:
            self.params["stream_transfer_dir"] = saved

    def _do_clear(self):
        """Wipe derived products, keep raw data, reprocess from scratch
        (reference clear branch: empties ctf/ mrc/ pkl/ csp/ sva/ tomo/)."""
        removed = 0
        for pattern in ("*.meta.npz", "*.meta.json", "stream_stack.mrc",
                        "stream_classes.png", "*.rec.mrc", "*_stack.mrc"):
            for f in self.work_dir.glob(pattern):
                try:
                    f.unlink()
                    removed += 1
                except OSError:
                    pass
        self.processed.clear()
        self.class_result = None
        try:
            self._flag("clear").unlink()
        except OSError:
            pass
        logger.info("stream: clear applied (%d derived files removed)", removed)
        self._reprocess_all()

    def _enforce_retention(self):
        """Age/count retention for processed raw files (the reference's
        session cleanup: sessions outlive their usefulness on shared
        scratch; nextPYP prunes per-session data on a policy)."""
        days = float(self.params.get("stream_retention_days") or 0.0)
        max_items = int(self.params.get("stream_retention_max_items") or 0)
        if days <= 0 and max_items <= 0:
            return
        entries = []
        for name, raw in self._raw_by_name.items():
            p = Path(raw)
            for cand in (p, Path(str(p) + ".bz2")):
                if cand.exists():
                    entries.append((cand.stat().st_mtime, name, cand))
                    break
        entries.sort()
        doomed = []
        if days > 0:
            cutoff = time.time() - days * 86400.0
            doomed += [e for e in entries if e[0] < cutoff]
        if max_items > 0 and len(entries) > max_items:
            doomed += entries[: len(entries) - max_items]
        for _, name, raw in {id(e): e for e in doomed}.values():
            try:
                raw.unlink()
            except OSError:
                continue
            for suffix in (".meta.npz", ".meta.json"):
                f = self.work_dir / f"{name}{suffix}"
                if f.exists():
                    f.unlink()
            self._raw_by_name.pop(name, None)
            logger.info("stream: retention pruned %s", name)

    def step(self) -> int:
        """One poll: live-params refresh, disk guard, scan + process, classify.
        Returns the number of items processed (the SessionManager drives many
        sessions by interleaving their step() calls in one process)."""
        updates = self._params_watcher.refresh()
        if updates:
            self.params = {**self.params, **updates}
            if "class_num" in updates:
                self.n_classes = int(updates["class_num"])
            logger.info("stream: live params update (%d keys)", len(updates))
        # retention runs BEFORE the disk guard: pruning is exactly the
        # mechanism that frees space, so gating it behind the guard would
        # pause ingest permanently once the disk fills past the threshold
        self._enforce_retention()
        min_free = float(self.params.get("stream_min_free_gb") or 0.0)
        if min_free > 0:
            import shutil as _shutil

            free_gb = _shutil.disk_usage(self.work_dir).free / 2**30
            if free_gb < min_free:
                # disk guard (reference pyp_daemon space check): leave
                # arrivals in the watch dir until space is recovered
                logger.warning(
                    "stream: %.1f GB free < stream_min_free_gb=%.1f — "
                    "pausing ingest", free_gb, min_free)
                return 0
        new = self.scan()
        for path in new:
            try:
                self.process_one(path)
            except Exception as e:  # noqa: BLE001
                logger.warning("stream: failed on %s: %s", path, e)
                self.processed.add(path)  # don't retry forever
        if new:
            self.maybe_classify()
            self._enforce_retention()
        return len(new)

    def run(self, max_iterations: int | None = None, idle_exit: int | None = None):
        """Poll loop. max_iterations/idle_exit bound the loop for testing and
        for session end detection (the reference's daemon timeout)."""
        self._flag("start").touch()
        idle = 0
        it = 0
        while True:
            if self.check_flags():
                break
            n = self.step()
            if n:
                idle = 0
            else:
                idle += 1
                if idle_exit is not None and idle >= idle_exit:
                    break
                time.sleep(self.poll_interval)
            it += 1
            if max_iterations is not None and it >= max_iterations:
                break
        return self.summaries


class SessionManager:
    """Multi-session bookkeeping: one process multiplexing many live
    sessions (the reference runs one pyp_daemon SLURM job per session under
    a `{group}/{session}` tree, stream/pyp_daemon.py:88-93; the manager
    keeps that directory contract and adds in-process concurrency —
    discovery of new sessions between polls, per-session control flags,
    and a persisted `sessions.json` ledger of status/counts).

    Layout: `root/{group}/{session}/session.toml` declares the session
    (must carry `data_path`, the watch glob; every other key overrides the
    manager's defaults). Raw data lands in the session dir; derived
    products are written next to it. Dropping `pypd.stop` into a session
    dir retires that session without touching its neighbors.
    """

    def __init__(self, root, defaults: dict | None = None,
                 poll_interval: float = 5.0, device="cuda"):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.defaults = dict(defaults or {})
        self.poll_interval = poll_interval
        self.daemons: dict[tuple[str, str], SessionDaemon] = {}
        self.retired: set[tuple[str, str]] = set()
        self.ledger_path = self.root / "sessions.json"

    def discover(self) -> int:
        """Instantiate daemons for newly appeared session dirs."""
        import tomllib

        found = 0
        for cfg in sorted(self.root.glob("*/*/session.toml")):
            key = (cfg.parent.parent.name, cfg.parent.name)
            if key in self.daemons or key in self.retired:
                continue
            try:
                sess_params = tomllib.loads(cfg.read_text())
            except Exception as e:  # noqa: BLE001
                logger.warning("stream: bad session.toml in %s: %s",
                               cfg.parent, e)
                self.retired.add(key)
                continue
            params = {**self.defaults, **sess_params,
                      "stream_group": key[0], "data_set": key[1]}
            pattern = str(params.get("data_path") or "")
            if not pattern:
                logger.warning("stream: session %s/%s has no data_path",
                               *key)
                self.retired.add(key)
                continue
            if not Path(pattern).is_absolute():
                pattern = str(cfg.parent / pattern)
            try:
                # a bad typed value (non-numeric class2d_num, ...) must
                # retire only THIS session, not crash the manager loop and
                # take every healthy session down with it
                self.daemons[key] = SessionDaemon(
                    pattern, params, work_dir=cfg.parent,
                    poll_interval=self.poll_interval,
                    classify_every=int(params.get("stream_classify_every")
                                       or 0), device=self.device)
            except Exception as e:  # noqa: BLE001
                logger.warning("stream: session %s/%s failed to start: %s",
                               key[0], key[1], e)
                self.retired.add(key)
                continue
            self.daemons[key]._flag("start").touch()
            found += 1
            logger.info("stream: session %s/%s joined", *key)
        return found

    def _write_ledger(self):
        import json as _json

        ledger = {}
        for key, d in self.daemons.items():
            ledger["/".join(key)] = {
                "status": "running", "processed": len(d.processed),
                "items": len(d.summaries),
                "particles": sum(s.get("particles", 0) or 0
                                 for s in d.summaries),
            }
        for key in self.retired:
            ledger.setdefault("/".join(key), {"status": "stopped"})
        tmp = str(self.ledger_path) + ".tmp"
        Path(tmp).write_text(_json.dumps(ledger, indent=1, sort_keys=True))
        import os as _os

        _os.replace(tmp, self.ledger_path)

    def step(self) -> int:
        """One round: discover new sessions, poll every live one."""
        self.discover()
        total = 0
        for key, d in list(self.daemons.items()):
            if d.check_flags():
                self.retired.add(key)
                del self.daemons[key]
                logger.info("stream: session %s/%s retired", *key)
                continue
            total += d.step()
        self._write_ledger()
        return total

    def run(self, max_iterations: int | None = None,
            idle_exit: int | None = None):
        idle = 0
        it = 0
        while True:
            n = self.step()
            if n:
                idle = 0
            else:
                idle += 1
                if idle_exit is not None and idle >= idle_exit:
                    break
                time.sleep(self.poll_interval)
            it += 1
            if max_iterations is not None and it >= max_iterations:
                break
        return {"/".join(k): d.summaries for k, d in self.daemons.items()}
