"""Observability sinks: MongoDB-style log mirroring + email notification.

Roles of the reference's system/logging mongo handler
(pyp/system/logging/mongo_handler.py:19 — every log
record mirrored into a mongo collection keyed by webid) and user_comm
email notifications (job done/failed mails). The rebuild keeps the same
document schema; when pymongo isn't installed (this image), documents
append to a local JSONL spool with identical contents, so the web layer
(or a later sync) can ingest them."""

from __future__ import annotations

import getpass
import json
import logging
import socket
import time
from pathlib import Path

from pyp_tpu_torch.utils.log import _configure


class MongoSink(logging.Handler):
    """Mirror log records as mongo documents.

    uri: mongodb://... (requires pymongo) or a filesystem path for the
    JSONL spool fallback. Document fields follow the reference's handler:
    timestamp, level, logger, message, host, user, webid."""

    def __init__(self, uri: str, collection: str = "logs", webid: str = ""):
        super().__init__()
        self.webid = webid
        self._coll = None
        self._spool = None
        if uri.startswith("mongodb://"):
            try:
                import pymongo  # noqa: F401 — optional dependency

                client = pymongo.MongoClient(uri, serverSelectionTimeoutMS=2000)
                self._coll = client.get_default_database()[collection]
            except Exception as e:  # noqa: BLE001 — fall back to spool
                logging.getLogger("pyp_tpu_torch").warning(
                    "mongo sink unavailable (%s); spooling to jsonl", e)
        if self._coll is None:
            path = uri if not uri.startswith("mongodb://") else ".pyp_tpu_mongo.jsonl"
            self._spool = Path(path)

    def emit(self, record: logging.LogRecord):
        doc = {
            "timestamp": time.time(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "host": socket.gethostname(),
            "user": getpass.getuser(),
            "webid": self.webid,
        }
        try:
            if self._coll is not None:
                self._coll.insert_one(doc)
            else:
                with open(self._spool, "a") as f:
                    f.write(json.dumps(doc) + "\n")
        except Exception:  # noqa: BLE001 — logging must never raise
            self.handleError(record)


def attach_mongo_sink(uri: str, collection: str = "logs",
                      webid: str = "") -> MongoSink:
    """Attach a MongoSink to the pyp_tpu_torch root logger."""
    _configure()
    sink = MongoSink(uri, collection, webid)
    logging.getLogger("pyp_tpu_torch").addHandler(sink)
    return sink


def send_email(to: str, subject: str, body: str,
               smtp_host: str = "localhost", sender: str = None,
               smtp_factory=None) -> bool:
    """Job-completion/failure notification (user_comm role). Returns True
    on success. smtp_factory injects the SMTP class (tests)."""
    import smtplib
    from email.message import EmailMessage

    msg = EmailMessage()
    msg["From"] = sender or f"{getpass.getuser()}@{socket.gethostname()}"
    msg["To"] = to
    msg["Subject"] = subject
    msg.set_content(body)
    factory = smtp_factory or smtplib.SMTP
    try:
        with factory(smtp_host) as s:
            s.send_message(msg)
        return True
    except Exception as e:  # noqa: BLE001 — notification is best-effort
        logging.getLogger("pyp_tpu_torch").warning("email notification failed: %s", e)
        return False
