"""Object-store staging — the bulk-data plane for partition dispatch.

The reference moves partition shards pod→pod with ``kubectl cp``
through the Kubernetes API server (tools/dispatch.py:13-20,
launch.py:37-45), paying the apiserver for every byte, once per worker.
SURVEY §2's TPU-native prescription is object storage: the launcher
PUTs each artifact into a bucket once, workers GET it straight from the
store — the API server (and the launcher's uplink) carries only
control messages, and an artifact shared by N workers is uploaded once
instead of N times.

Two store backends behind one URL scheme:

- ``file://`` (or a bare path) — filesystem-rooted bucket emulation:
  the store root is any shared directory (NFS, a GCS fuse mount, tmpfs
  in tests). The fully-exercised backend in this environment (zero
  egress).
- ``gs://`` — shells out to ``gcloud storage`` (or ``gsutil``) when
  installed; gated behind a tool probe since neither ships in this
  image.

:class:`ObjectStoreFabric` composes a store with a *control* fabric:
``exec`` passes through unchanged; ``copy``/``copy_batch`` PUT once per
unique source then EXEC one small pull command per worker (the worker
reads the store directly). Objects are keyed by a digest of the
source's (path, size, mtime), so repeated dispatches of unchanged
artifacts skip the upload too.

The port's copy of the JAX package's ``launcher/objstore.py``,
torch-free, with its names, flags and environment variables.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

from dgl_operator_tpu_torch.launcher.fabric import Fabric, FabricError
from dgl_operator_tpu_torch.launcher import console

OBJECT_STORE_ENV = "TPU_OPERATOR_OBJECT_STORE"


class ObjectStoreError(FabricError):
    pass


def _source_key(path: str) -> str:
    """Stable object key for a local source file: digest of identity +
    freshness (abspath, size, mtime) so unchanged files dedupe across
    dispatches while edits re-upload, followed by the basename so the
    store stays human-navigable."""
    st = os.stat(path)
    h = hashlib.sha1(
        f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}"
        .encode()).hexdigest()[:12]
    return f"{h}/{os.path.basename(path)}"


class FSObjectStore:
    """Filesystem-rooted bucket: PUT snapshots (copy + atomic rename)
    into ``root``; the returned URL is ``file://<abs>`` so any worker
    with the mount can GET it with a plain copy."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def put(self, src: str) -> str:
        if not os.path.isfile(src):
            raise ObjectStoreError(f"object-store put: not a file: {src}")
        key = _source_key(src)
        dst = os.path.join(self.root, key)
        if not os.path.exists(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            # always a COPY snapshot (tmp + atomic replace), never a
            # hardlink: a staged object's bytes must stay immutable
            # even if the source is later rewritten in place while a
            # worker's GET is mid-flight (object-store semantics — a
            # hardlink would alias the live source inode). mkstemp:
            # the store is SHARED, so the tmp must be unique across
            # launchers on DIFFERENT hosts too (a pid suffix is not);
            # crashed attempts unlink their tmp instead of littering
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(dst),
                prefix=os.path.basename(dst) + ".tmp")
            os.close(fd)
            try:
                shutil.copy2(src, tmp)
                os.replace(tmp, dst)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        return "file://" + dst

    @staticmethod
    def get(url: str, dest_dir: str) -> str:
        path = url[len("file://"):] if url.startswith("file://") else url
        if not os.path.isfile(path):
            raise ObjectStoreError(f"object-store get: missing: {url}")
        os.makedirs(dest_dir, exist_ok=True)
        dst = os.path.join(dest_dir, os.path.basename(path))
        # samefile guard: a pull targeting the staging directory itself
        # (shared-fs single-node runs) must not copy a file onto itself
        if not (os.path.exists(dst) and os.path.samefile(path, dst)):
            shutil.copy2(path, dst)
        return dst


class GSObjectStore:
    """``gs://`` bucket via the gcloud/gsutil CLI (not in this image —
    every call probes for the tool and fails loudly when absent)."""

    def __init__(self, root: str):
        self.root = root.rstrip("/")
        self._tool = self._find_tool()

    @staticmethod
    def _find_tool() -> List[str]:
        if shutil.which("gcloud"):
            return ["gcloud", "storage", "cp"]
        if shutil.which("gsutil"):
            return ["gsutil", "cp"]
        raise ObjectStoreError(
            "gs:// object store needs gcloud or gsutil on PATH")

    def _cp(self, src: str, dst: str) -> None:
        from dgl_operator_tpu_torch.launcher.fabric import (
            FabricTimeout, env_exec_timeout)
        timeout = env_exec_timeout()
        try:
            res = subprocess.run([*self._tool, src, dst],
                                 capture_output=True, text=True,
                                 timeout=timeout)
        except subprocess.TimeoutExpired as exc:
            # transient, like every fabric timeout: the retry layer
            # gets a fresh copy attempt instead of a raw exception
            raise FabricTimeout(
                f"{' '.join(self._tool)} {src} {dst} timed out "
                f"after {timeout:.0f}s") from exc
        if res.returncode != 0:
            raise ObjectStoreError(
                f"{' '.join(self._tool)} {src} {dst} failed "
                f"({res.returncode}): {res.stderr[-2000:]}")

    def put(self, src: str) -> str:
        url = f"{self.root}/{_source_key(src)}"
        self._cp(src, url)
        return url

    def get(self, url: str, dest_dir: str) -> str:
        os.makedirs(dest_dir, exist_ok=True)
        dst = os.path.join(dest_dir, os.path.basename(url))
        self._cp(url, dst)
        return dst


def store_from_url(url: str):
    """file:// (or bare path) → FSObjectStore; gs:// → GSObjectStore."""
    if url.startswith("gs://"):
        return GSObjectStore(url)
    if url.startswith("file://"):
        return FSObjectStore(url[len("file://"):])
    if "://" in url:
        raise ObjectStoreError(f"unsupported object-store scheme: {url}")
    return FSObjectStore(url)


def get_url(url: str, dest_dir: str) -> str:
    """Scheme-dispatched GET — what the worker-side pull command runs.
    A ``url::relpath`` token (directory-tree member) lands at
    ``dest_dir/relpath``; a bare URL lands at ``dest_dir/basename``."""
    if "::" in url:
        url, rel = url.split("::", 1)
        if os.path.isabs(rel) or ".." in rel.split(os.sep):
            raise ObjectStoreError(f"unsafe relpath in token: {rel!r}")
        dest_dir = os.path.join(dest_dir, os.path.dirname(rel))
    if url.startswith("gs://"):
        return GSObjectStore(os.path.dirname(url)).get(url, dest_dir)
    return FSObjectStore.get(url, dest_dir)


class ObjectStoreFabric(Fabric):
    """Store-staged bulk data over a pass-through control fabric.

    ``copy_batch(srcs, hosts, dir)``: each source is PUT once (however
    many hosts), then ONE exec per host pulls every URL — 1 upload +
    N store-reads, vs the reference's N apiserver copies per file.
    Directory sources stage file-by-file with their relative paths
    carried in the pull tokens (``url::relpath``), so the worker-side
    GET recreates the tree — the copytree / `kubectl cp -r` analogue
    (tpurun phase 2 ships a whole dataset directory this way)."""

    def __init__(self, store, control: Fabric,
                 python: Optional[str] = None):
        self.store = store
        self.control = control
        self.python = python or sys.executable

    def exec(self, host, cmd, env=None, container=None):
        self.control.exec(host, cmd, env=env, container=container)

    def fetch(self, host, src, target_dir, container=None):
        # pulls ride the control fabric directly: obs artifacts are
        # small files and the store has no worker-side PUT path
        self.control.fetch(host, src, target_dir, container=container)

    def _stage(self, src: str) -> List[str]:
        """PUT one source (file or directory tree) and return pull
        tokens: bare URL for a file, ``url::relpath`` for tree
        members (relpath rooted at the source's basename, matching
        LocalFabric.copy's copytree destination)."""
        if os.path.isdir(src):
            tokens = []
            base = os.path.basename(os.path.abspath(src))
            for root, _, files in os.walk(src):
                for name in sorted(files):
                    p = os.path.join(root, name)
                    rel = os.path.join(base, os.path.relpath(p, src))
                    tokens.append(f"{self.store.put(p)}::{rel}")
            if not tokens:
                raise ObjectStoreError(
                    f"object-store put: empty directory: {src}")
            return tokens
        return [self.store.put(src)]

    def _pull_cmd(self, tokens: Sequence[str], target_dir: str) -> str:
        return (f"{shlex.quote(self.python)} -m "
                "dgl_operator_tpu_torch.launcher.objstore get --dest "
                f"{shlex.quote(target_dir)} "
                + " ".join(shlex.quote(u) for u in tokens))

    def copy(self, src, host, target_dir, container=None):
        self.control.exec(host,
                          self._pull_cmd(self._stage(src), target_dir),
                          container=container)

    def copy_batch(self, srcs: Sequence[str], hosts: Sequence[str],
                   target_dir: str, container=None) -> None:
        tokens = [t for s in srcs for t in self._stage(s)]  # once/source
        cmd = self._pull_cmd(tokens, target_dir)
        self._join(self._spawn_exec(hosts, cmd, container=container))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="object-store helper (worker-side pull / staging)")
    sub = ap.add_subparsers(dest="verb", required=True)
    g = sub.add_parser("get", help="fetch objects into a directory")
    g.add_argument("--dest", required=True)
    g.add_argument("urls", nargs="+")
    p = sub.add_parser("put", help="stage files, print their URLs")
    p.add_argument("--store", default=os.environ.get(OBJECT_STORE_ENV))
    p.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    if args.verb == "get":
        for u in args.urls:
            get_url(u, args.dest)
    else:
        if not args.store:
            ap.error(f"put needs --store or {OBJECT_STORE_ENV}")
        store = store_from_url(args.store)
        for f in args.files:
            # console sink keeps the bare-URL stdout contract (callers
            # parse these lines) while recording the staging as events
            console.log(store.put(f), event="objstore_put", source=f)


if __name__ == "__main__":
    main()
