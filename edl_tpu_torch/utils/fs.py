"""Pluggable remote filesystem for checkpoints (copy of
``edl_tpu.utils.fs``; stdlib only).

- ``FileSystem`` is a small transfer interface (exists / listdir / upload
  / download / delete) over directory trees, since checkpoints are
  atomic directories (``ckpt-{version}``).
- ``LocalFS`` backs ``file://`` and bare paths (local disk or a shared
  mount).
- ``CommandFS`` shells out to a storage CLI (``gsutil`` for ``gs://``,
  ``hdfs dfs`` for ``hdfs://``); its command table is injectable.
- ``mirror_checkpoint`` / ``fetch_latest_checkpoint`` add the transfer to
  ``CheckpointManager``'s local layout: rank 0 uploads a sealed version
  dir, then writes its ``COMPLETE`` marker and flips ``LATEST`` (marker
  last, so a reader never sees a half-uploaded version), and a pod whose
  local dir lacks a version downloads it before restoring.

The mirror layout is the JAX package's, so either package reads a
mirror the other wrote.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Sequence

from edl_tpu_torch.utils.exceptions import EdlError
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.utils.fs")


class EdlFsError(EdlError):
    pass


def split_scheme(uri: str) -> tuple[str, str]:
    """("gs", "bucket/path") for "gs://bucket/path"; ("", uri) for paths."""
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme, rest
    return "", uri


class FileSystem:
    """Transfer interface over directory trees at string URIs."""

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def listdir(self, uri: str) -> list[str]:
        """Child basenames of a directory URI (empty if absent)."""
        raise NotImplementedError

    def upload(self, local: str, uri: str) -> None:
        """Recursively copy local file/dir to uri (parents created)."""
        raise NotImplementedError

    def download(self, uri: str, local: str) -> None:
        """Recursively copy uri to local path (parents created)."""
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        """Remove file/dir at uri; no error if absent."""
        raise NotImplementedError

    def read_text(self, uri: str) -> str:
        # download into a private dir (a predictable pre-claimed file name
        # would let another party plant content, e.g. a LATEST value)
        tmpdir = tempfile.mkdtemp(prefix="edl-fs-")
        try:
            tmp = os.path.join(tmpdir, "f")
            self.download(uri, tmp)
            with open(tmp) as f:
                return f.read()
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)

    def write_text(self, uri: str, text: str) -> None:
        fd, tmp = tempfile.mkstemp(prefix="edl-fs-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            self.upload(tmp, uri)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


class LocalFS(FileSystem):
    """file:// and bare paths (local disk or mounted NFS)."""

    @staticmethod
    def _path(uri: str) -> str:
        scheme, rest = split_scheme(uri)
        if scheme not in ("", "file"):
            raise EdlFsError(f"LocalFS cannot handle {uri!r}")
        return rest if scheme == "file" else uri

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))

    def listdir(self, uri: str) -> list[str]:
        path = self._path(uri)
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def upload(self, local: str, uri: str) -> None:
        dst = self._path(uri)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        if os.path.isdir(local):
            # copy into a temp sibling then rename for the same
            # no-partial-dir guarantee checkpoints rely on locally
            tmp = tempfile.mkdtemp(prefix=".edl-up-",
                                   dir=os.path.dirname(dst) or ".")
            try:
                staged = os.path.join(tmp, os.path.basename(dst))
                shutil.copytree(local, staged)
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                os.rename(staged, dst)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            # temp + rename for single files too: a copy2 interrupted
            # mid-write (ENOSPC, kill) must not leave a truncated dst
            # that presence-based checks then trust (e.g. the sharded-
            # mirror completeness gate keying on index.{r}.json)
            fd, tmp = tempfile.mkstemp(prefix=".edl-up-",
                                       dir=os.path.dirname(dst) or ".")
            os.close(fd)
            try:
                shutil.copy2(local, tmp)
                os.rename(tmp, dst)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

    def download(self, uri: str, local: str) -> None:
        src = self._path(uri)
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        if os.path.isdir(src):
            if os.path.exists(local):
                shutil.rmtree(local)
            shutil.copytree(src, local)
        else:
            shutil.copy2(src, local)

    def delete(self, uri: str) -> None:
        path = self._path(uri)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)


class CommandFS(FileSystem):
    """Storage-CLI-backed FS (gsutil / hdfs dfs / custom).

    Args map operation -> argv template; "{src}", "{dst}", "{uri}" are
    substituted. `list_cmd` must print one child URI or basename per
    line. A non-zero exit from exists/list is treated as "absent"; from
    transfer ops it raises.
    """

    def __init__(self, *, exists_cmd: Sequence[str], list_cmd: Sequence[str],
                 upload_cmd: Sequence[str], download_cmd: Sequence[str],
                 delete_cmd: Sequence[str]):
        self.cmds = {"exists": list(exists_cmd), "list": list(list_cmd),
                     "upload": list(upload_cmd),
                     "download": list(download_cmd),
                     "delete": list(delete_cmd)}

    def _run(self, op: str, check: bool, **subs: str
             ) -> subprocess.CompletedProcess:
        argv = [a.format(**subs) for a in self.cmds[op]]
        proc = subprocess.run(argv, capture_output=True, text=True)
        if check and proc.returncode != 0:
            raise EdlFsError(
                f"{op} failed ({' '.join(argv)}): {proc.stderr.strip()}")
        return proc

    def exists(self, uri: str) -> bool:
        return self._run("exists", check=False, uri=uri).returncode == 0

    def listdir(self, uri: str) -> list[str]:
        proc = self._run("list", check=False, uri=uri)
        if proc.returncode != 0:
            return []
        names = []
        for line in proc.stdout.splitlines():
            line = line.strip().rstrip("/")
            if line:
                names.append(line.rsplit("/", 1)[-1])
        return sorted(set(names))

    def upload(self, local: str, uri: str) -> None:
        self._run("upload", check=True, src=local, dst=uri)

    def download(self, uri: str, local: str) -> None:
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        self._run("download", check=True, src=uri, dst=local)

    def delete(self, uri: str) -> None:
        self._run("delete", check=False, uri=uri)


def gcs_fs() -> CommandFS:
    """gs:// via gsutil."""
    return CommandFS(
        exists_cmd=["gsutil", "-q", "stat", "{uri}"],
        list_cmd=["gsutil", "ls", "{uri}"],
        upload_cmd=["gsutil", "-m", "cp", "-r", "{src}", "{dst}"],
        download_cmd=["gsutil", "-m", "cp", "-r", "{src}", "{dst}"],
        delete_cmd=["gsutil", "-m", "rm", "-r", "{uri}"])


def hdfs_fs() -> CommandFS:
    """hdfs:// via the hadoop CLI (the reference's remote store,
    distill/utils.py:18)."""
    return CommandFS(
        exists_cmd=["hdfs", "dfs", "-test", "-e", "{uri}"],
        list_cmd=["hdfs", "dfs", "-ls", "-C", "{uri}"],
        upload_cmd=["hdfs", "dfs", "-put", "-f", "{src}", "{dst}"],
        download_cmd=["hdfs", "dfs", "-get", "{src}", "{dst}"],
        delete_cmd=["hdfs", "dfs", "-rm", "-r", "-f", "{uri}"])


_SCHEMES = {"": LocalFS, "file": LocalFS, "gs": gcs_fs, "hdfs": hdfs_fs}


def register_scheme(scheme: str, factory) -> None:
    """Plug in an FS for a URI scheme (tests register fakes here)."""
    _SCHEMES[scheme] = factory


def resolve(uri: str) -> FileSystem:
    scheme, _ = split_scheme(uri)
    try:
        return _SCHEMES[scheme]()
    except KeyError:
        raise EdlFsError(f"no filesystem registered for {scheme!r}://")


def join_uri(base: str, *parts: str) -> str:
    return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])


# -- checkpoint mirroring ----------------------------------------------------

_LATEST = "LATEST"


def mirror_checkpoint(local_dir: str, version: int, remote_root: str,
                      *, keep: int | None = None) -> None:
    """Upload a sealed `ckpt-{version}` dir, then flip the LATEST marker.

    Marker-last ordering means a reader that trusts LATEST never sees a
    partially uploaded version (the fault_tolerance.md upload contract).
    With `keep`, remote versions below the newest `keep` are deleted
    after the marker flip.
    """
    fs = resolve(remote_root)
    name = f"ckpt-{version}"
    fs.upload(os.path.join(local_dir, name), join_uri(remote_root, name))
    finalize_mirror(remote_root, version, keep=keep)
    log.info("mirrored %s -> %s", name, remote_root)


def mirror_checkpoint_files(version_dir: str, version: int,
                            remote_root: str, files: Sequence[str]) -> None:
    """Upload the named files of a (possibly still pending) version dir
    into the remote `ckpt-{version}` — WITHOUT touching LATEST.

    The sharded-save mirror path for clusters where the local checkpoint
    dir is NOT shared: every process pushes its own chunks + index file
    this way (from its pending dir), and only after all of them are up
    does rank 0 upload meta.json and flip the marker (`finalize_mirror`)
    — marker-last across the whole world, so a cold pod never reassembles
    from an index whose chunks are missing. Uploading only rank 0's local
    dir would mirror only rank 0's chunks.
    """
    fs = resolve(remote_root)
    name = f"ckpt-{version}"
    for fname in files:
        fs.upload(os.path.join(version_dir, fname),
                  join_uri(remote_root, name, fname))


_COMPLETE = "COMPLETE"


def remote_version_complete(remote_root: str, version: int) -> bool:
    """A remote version dir counts as complete once it holds the
    COMPLETE marker `finalize_mirror` writes AFTER all content is up.
    The marker is the ONLY accepted evidence: meta.json presence is
    unsound on CommandFS backends (a killed mid-upload `gsutil cp -r`
    can land meta.json before the payload — file order inside a
    recursive copy is unspecified), and no heuristic can distinguish a
    pre-marker legacy dir from a killed new-format upload. A mirror
    sealed before the marker existed needs a one-time backfill:
    `resolve(root).exists(...)` the content, then
    `fs.write_text(join_uri(root, "ckpt-N", "COMPLETE"), "N")`."""
    fs = resolve(remote_root)
    return fs.exists(join_uri(remote_root, f"ckpt-{version}", _COMPLETE))


def finalize_mirror(remote_root: str, version: int, *,
                    keep: int | None = None) -> None:
    """Seal the remote version (COMPLETE marker) + flip LATEST + GC.

    Both markers are written only after every content file is up:
    COMPLETE makes the version individually fetchable (explicit-version
    restores), LATEST names the newest one. GC retention counts only
    COMPLETE versions — a partial dir left by a failed earlier mirror
    must not occupy a retention slot (that would delete an older
    complete version early); partials older than the newest complete
    `keep` are deleted outright as garbage.
    """
    fs = resolve(remote_root)
    fs.write_text(join_uri(remote_root, f"ckpt-{version}", _COMPLETE),
                  str(version))
    fs.write_text(join_uri(remote_root, _LATEST), str(version))
    if keep is not None:
        versions = remote_versions(remote_root)
        complete = [v for v in versions
                    if remote_version_complete(remote_root, v)]
        cutoff = complete[-keep] if len(complete) >= keep else None
        if cutoff is not None:
            for v in versions:
                if v < cutoff:
                    fs.delete(join_uri(remote_root, f"ckpt-{v}"))


def remote_versions(remote_root: str) -> list[int]:
    fs = resolve(remote_root)
    out = []
    for name in fs.listdir(remote_root):
        if name.startswith("ckpt-") and name[5:].isdigit():
            out.append(int(name[5:]))
    return sorted(out)


def remote_latest_version(remote_root: str) -> int | None:
    """The LATEST-marked version number, without downloading it."""
    fs = resolve(remote_root)
    marker = join_uri(remote_root, _LATEST)
    if not fs.exists(marker):
        return None
    return int(fs.read_text(marker).strip())


def fetch_latest_checkpoint(remote_root: str, local_dir: str,
                            version: int | None = None) -> int | None:
    """Download the LATEST-marked (or a specific sealed) version into
    local_dir; its number, or None when the remote has no checkpoint."""
    fs = resolve(remote_root)
    if version is None:
        marker = join_uri(remote_root, _LATEST)
        if not fs.exists(marker):
            return None
        version = int(fs.read_text(marker).strip())
    elif (version not in remote_versions(remote_root)
          or not remote_version_complete(remote_root, version)):
        # an explicitly requested version must also be COMPLETE — a
        # partial dir from a failed mirror would download but then
        # crash the restore on its missing meta.json
        return None
    name = f"ckpt-{version}"
    dst = os.path.join(local_dir, name)
    if os.path.isdir(dst):
        return version  # already local (e.g. the surviving pod)
    os.makedirs(local_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-fetch-", dir=local_dir)
    try:
        staged = os.path.join(tmp, name)
        fs.download(join_uri(remote_root, name), staged)
        try:
            os.rename(staged, dst)
        except OSError:
            if not os.path.isdir(dst):  # lost a concurrent-fetch race: fine
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log.info("fetched %s <- %s", name, remote_root)
    return version
