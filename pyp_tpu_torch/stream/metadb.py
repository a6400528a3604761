"""Session metadata store — the streampyp metadb daemon role.

Rebuild of the reference's MetaDB (streampyp/metadb_daemon.py:11): the web
platform's live store of sessions, per-micrograph results, and 2D classes,
keyed by group/session ids. Backed by MongoDB when a mongodb:// uri is
given and pymongo is importable; otherwise by an atomic local JSON file
with the identical document layout (the web layer or a later sync ingests
it — same contract as utils.notify.MongoSink)."""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from pyp_tpu_torch.utils import get_logger

logger = get_logger("metadb")


class _FileStore:
    """Atomic JSON-file backing: {collection: {_id: doc}}."""

    def __init__(self, path):
        self.path = Path(path)
        self._data = {}
        if self.path.exists():
            self._data = json.loads(self.path.read_text())

    def _flush(self):
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent or "."),
                                   suffix=".metadb")
        with os.fdopen(fd, "w") as f:
            json.dump(self._data, f)
        os.replace(tmp, self.path)

    def coll(self, name):
        return self._data.setdefault(name, {})

    def replace_one(self, coll, _id, doc):
        doc = dict(doc)
        doc["_id"] = _id
        self.coll(coll)[_id] = doc
        self._flush()

    def update_one(self, coll, _id, fields):
        self.coll(coll).setdefault(_id, {"_id": _id}).update(fields)
        self._flush()

    def get(self, coll, _id):
        return self.coll(coll).get(_id)

    def delete_many(self, coll, prefix):
        c = self.coll(coll)
        for k in [k for k in c if k.startswith(prefix)]:
            del c[k]
        self._flush()

    def find_prefix(self, coll, prefix):
        return [v for k, v in sorted(self.coll(coll).items())
                if k.startswith(prefix)]


class MetaDB:
    """Sessions / Micrographs / TwoDClasses collections with the reference's
    id scheme (group/session[/item])."""

    def __init__(self, uri: str = ".pyp_tpu_metadb.json", timeout_ms=5000):
        self._mongo = None
        if str(uri).startswith("mongodb://"):
            try:
                import pymongo

                self._mongo = pymongo.MongoClient(
                    uri, serverSelectionTimeoutMS=timeout_ms).micromon
            except Exception as e:  # noqa: BLE001 — fall back to file store
                logger.warning("metadb mongo unavailable (%s); using file "
                               "store", e)
        self._file = None if self._mongo is not None else _FileStore(uri)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        if self._mongo is not None:
            self._mongo.client.close()
        return False

    # --- sessions ---------------------------------------------------------
    def write_session(self, group_id, session_id, doc):
        _id = f"{group_id}/{session_id}"
        if self._mongo is not None:
            self._mongo.sessions.replace_one({"_id": _id}, {**doc, "_id": _id},
                                             upsert=True)
        else:
            self._file.replace_one("sessions", _id, doc)

    def get_session(self, group_id, session_id):
        _id = f"{group_id}/{session_id}"
        if self._mongo is not None:
            return self._mongo.sessions.find_one({"_id": _id})
        return self._file.get("sessions", _id)

    # --- micrographs ------------------------------------------------------
    def write_micrograph(self, group_id, session_id, micrograph_id, doc):
        _id = f"{group_id}/{session_id}/{micrograph_id}"
        doc = {**doc, "groupId": group_id, "sessionId": session_id}
        if self._mongo is not None:
            self._mongo.micrographs.replace_one({"_id": _id}, {**doc, "_id": _id},
                                                upsert=True)
        else:
            self._file.replace_one("micrographs", _id, doc)

    def count_micrographs(self, group_id, session_id):
        if self._mongo is not None:
            return self._mongo.micrographs.count_documents(
                {"groupId": group_id, "sessionId": session_id})
        return len(self._file.find_prefix("micrographs",
                                          f"{group_id}/{session_id}/"))

    def micrographs(self, group_id, session_id):
        if self._mongo is not None:
            return list(self._mongo.micrographs.find(
                {"groupId": group_id, "sessionId": session_id}))
        return self._file.find_prefix("micrographs",
                                      f"{group_id}/{session_id}/")

    def delete_micrographs(self, group_id, session_id):
        if self._mongo is not None:
            self._mongo.micrographs.delete_many(
                {"groupId": group_id, "sessionId": session_id})
        else:
            self._file.delete_many("micrographs", f"{group_id}/{session_id}/")

    # --- 2D classes -------------------------------------------------------
    def write_twod_classes(self, group_id, session_id, doc):
        _id = f"{group_id}/{session_id}"
        if self._mongo is not None:
            self._mongo.twod_classes.replace_one(
                {"_id": _id}, {**doc, "_id": _id}, upsert=True)
        else:
            self._file.replace_one("twod_classes", _id, doc)

    def get_twod_classes(self, group_id, session_id):
        _id = f"{group_id}/{session_id}"
        if self._mongo is not None:
            return self._mongo.twod_classes.find_one({"_id": _id})
        return self._file.get("twod_classes", _id)
