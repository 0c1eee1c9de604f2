"""Object-store-shaped durable tier for checkpoint streaming — the port
of ``dear_pytorch_tpu/utils/objectstore.py``, a copy.

The resilience stack's checkpoints are only as durable as the disk they
land on: per-host storage (``DEAR_CKPT_SHARED=0``) dies with the host,
and even shared NFS dies with the filesystem. The continuous-training
service (docs/RESILIENCE.md "Autoscaling") adds a **remote tier**: a
background uploader (`utils.checkpoint.CheckpointStreamer`) streams
committed step dirs to an object store, so a fully-lost fleet — or a
scale-from-zero cold start — restores from the remote tier alone with
zero loss past the newest uploaded step.

This module defines the store *shape* and its local-directory reference
implementation. The interface is deliberately the narrow waist every
real object store offers (GCS/S3 semantics, no rename, no append):

    put_bytes(key, data)     atomic whole-object write
    get_bytes(key) -> bytes  whole-object read (KeyError when absent)
    put_file(key, path)      upload one local file
    get_file(key, dest)      download one object to a local path
    list(prefix) -> [key]    every key under a prefix, **sorted
                             lexicographically by key** — pinned: readers
                             (feedback-log segment walks, version scans)
                             rely on the order being stable under
                             concurrent appenders
    delete_prefix(prefix)    best-effort recursive delete
    exists(key) -> bool
    put_bytes_if_absent(key, data) -> bool
                             first-writer-wins whole-object publish
                             (GCS ``ifGenerationMatch=0`` / S3
                             ``If-None-Match:*`` semantics)

A production deployment implements the same eight methods over its
bucket client; everything above the waist (manifest commit protocol,
retry, sha256 reverify, retention) lives in `utils.checkpoint` /
`online.feedback` and is backend-agnostic.

`LocalObjectStore` maps keys to files under a root directory with
tmp-then-``os.replace`` atomicity — a reader can never observe a torn
object, which is what lets ``MANIFEST.json`` act as the per-step commit
marker (a remote step exists iff its manifest does).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import List

__all__ = ["LocalObjectStore"]


class LocalObjectStore:
    """Local-directory object store (the GCS/S3 stand-in).

    Keys are '/'-separated and mirror onto a directory tree so the store
    stays human-debuggable (``ls`` the root to watch an upload land).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p not in ("", ".", "..")]
        return os.path.join(self.root, *parts)

    # -- the seven-method waist ----------------------------------------------

    def put_bytes(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # readers see the whole object or none

    def get_bytes(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            raise KeyError(key) from None

    def put_file(self, key: str, path: str) -> None:
        dest = self._path(key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        tmp = f"{dest}.tmp.{os.getpid()}"
        shutil.copyfile(path, tmp)
        os.replace(tmp, dest)

    def get_file(self, key: str, dest: str) -> None:
        src = self._path(key)
        if not os.path.isfile(src):
            raise KeyError(key)
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        tmp = f"{dest}.tmp.{os.getpid()}"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dest)

    def put_bytes_if_absent(self, key: str, data: bytes) -> bool:
        """First-writer-wins whole-object publish: write ``data`` under
        ``key`` unless a committed object is already there; returns True
        when this call created the object, False when it lost (the
        existing object is left intact either way). Atomic via the
        hard-link idiom (`resilience.cluster.FileTransport.decide_once`):
        the tmp file is complete before linking, so a reader can never
        observe a torn winner, and ``link`` fails with EEXIST when
        another writer won. Real bucket clients map this to conditional
        puts (GCS ``ifGenerationMatch=0``, S3 ``If-None-Match: *``).
        This is what makes duplicate segment publication idempotent for
        the feedback log's commit markers (`online.feedback`)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        except OSError:
            # filesystem without hard links (some FUSE mounts): exclusive
            # create of the final path — racier (a concurrent reader can
            # catch the value mid-write) but still first-writer-wins
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                return True
            except FileExistsError:
                return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def list(self, prefix: str) -> List[str]:
        """Every committed key under ``prefix`` (in-flight tmp files
        excluded), as full keys relative to the store root, **sorted
        lexicographically by key** — the ordering contract concurrent
        appenders and segment-walking readers rely on."""
        base = self._path(prefix)
        if not os.path.isdir(base):
            return []
        out = []
        for dirpath, _dirs, files in os.walk(base):
            for fn in files:
                if ".tmp." in fn:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def delete_prefix(self, prefix: str) -> None:
        shutil.rmtree(self._path(prefix), ignore_errors=True)

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))
