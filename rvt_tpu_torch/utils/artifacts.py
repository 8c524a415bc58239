"""Filesystem checkpoint-artifact registry.

A copy of ``rvt_tpu.utils.artifacts`` with two of its hazards repaired
(the third, a stale local copy on resume, is repaired in the trainer):

  * concurrent publishers: the next version number is reserved with an
    exclusive ``os.mkdir`` (the next number is tried on
    ``FileExistsError``), and ``set_alias`` / ``prune`` read, modify and
    write ``aliases.json`` under an ``fcntl.flock`` on a lock file, so two
    writers never take one version or drop each other's alias;
  * the prune direction: scores are a metric to maximise (AP); the lowest
    go first.

A replacement for the reference's W&B model-artifact flow
(``loggers/wandb_logger.py``): checkpoint upload with score metadata and
``best``/``last`` aliases (``_scan_and_log_checkpoints``, :254-320),
top-k retention that never deletes aliased artifacts (``_rm_but_top_k``,
:322-376), resume by artifact name (``get_checkpoint``, :77-87), and the
run's code snapshot (``save_code=True``, :64).

Instead of a vendor registry, artifacts live under a plain directory
tree — point ``root`` at local disk for single-host runs or at shared
storage (NFS mount) for fleets; a version becomes visible only when its
manifest is moved into place, so concurrent readers never observe
partial artifacts.

Layout::

    <root>/<name>/v<N>/manifest.json   # score/step/metadata + file md5s
    <root>/<name>/v<N>/payload/...     # the checkpoint file or step dir
    <root>/<name>/aliases.json         # {"best": 3, "last": 7}
    <root>/<name>/.lock                # flock'd around aliases.json

URIs: ``<name>``, ``<name>@best``, ``<name>@last``, ``<name>@v3``.
"""
from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import shutil
import tarfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _md5(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _file_manifest(payload: Path) -> Dict[str, str]:
    if payload.is_file():
        return {payload.name: _md5(payload)}
    out = {}
    for p in sorted(payload.rglob("*")):
        if p.is_file():
            out[str(p.relative_to(payload))] = _md5(p)
    return out


class ArtifactRegistry:
    def __init__(self, root: str | Path):
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)

    # -- write side ---------------------------------------------------------

    def publish(self, src: str | Path, name: str, *,
                score: Optional[float] = None, step: Optional[int] = None,
                aliases: Sequence[str] = (),
                metadata: Optional[Dict[str, Any]] = None) -> str:
        """Copy a checkpoint file or directory into the registry as the
        next version of ``name``; returns ``"<name>@v<N>"``.

        Mirrors one artifact log of ``_scan_and_log_checkpoints``: the
        manifest records score/step/metadata (the reference stashes
        score + ModelCheckpoint config in artifact.metadata) plus per-file
        md5s so a resume can verify integrity end-to-end.
        """
        src = Path(src)
        if not src.exists():
            raise FileNotFoundError(src)
        adir = self.root / name
        adir.mkdir(parents=True, exist_ok=True)
        version, vdir = self._reserve_version(adir)
        payload = vdir / "payload"
        payload.mkdir()
        if src.is_file():
            shutil.copy2(src, payload / src.name)
        else:
            shutil.copytree(src, payload / src.name)
        manifest = {
            "name": name,
            "version": version,
            "score": None if score is None else float(score),
            "step": step,
            "metadata": metadata or {},
            "original_filename": src.name,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "files": _file_manifest(payload / src.name),
        }
        tmp = vdir / f".manifest-{os.getpid()}.tmp"
        tmp.write_text(json.dumps(manifest, indent=1))
        os.replace(tmp, vdir / "manifest.json")  # atomic publish
        for alias in aliases:
            self.set_alias(name, alias, version)
        return f"{name}@v{version}"

    @staticmethod
    def _reserve_version(adir: Path) -> Tuple[int, Path]:
        """Take the next free version number of ``adir`` by creating its
        directory: ``os.mkdir`` fails for all but one of the writers that
        try one number, and the others move on to the next."""
        taken = [int(p.name[1:]) for p in adir.iterdir()
                 if p.name.startswith("v") and p.name[1:].isdigit()]
        version = max(taken, default=0) + 1
        while True:
            vdir = adir / f"v{version}"
            try:
                os.mkdir(vdir)
                return version, vdir
            except FileExistsError:
                version += 1

    @contextlib.contextmanager
    def _locked(self, name: str):
        """Hold an exclusive ``flock`` on ``<name>/.lock``."""
        adir = self.root / name
        adir.mkdir(parents=True, exist_ok=True)
        with open(adir / ".lock", "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def set_alias(self, name: str, alias: str, version: int) -> None:
        """Point ``alias`` at ``version``: a read-modify-write of
        ``aliases.json`` under the name's lock."""
        adir = self.root / name
        with self._locked(name):
            aliases = self.aliases(name)
            aliases[alias] = version
            tmp = adir / f".aliases-{os.getpid()}.tmp"
            tmp.write_text(json.dumps(aliases, indent=1))
            os.replace(tmp, adir / "aliases.json")

    def prune(self, name: str, keep_top_k: int) -> List[int]:
        """Delete versions beyond the ``keep_top_k`` best-scored ones,
        never deleting an aliased version (reference ``_rm_but_top_k``:
        last and best are exempt; ``keep_top_k == -1`` keeps everything).
        Scores are a metric to maximise (the trainer's monitor, AP): the
        lowest scores and the unscored versions go first. Holds the name's
        lock, so no alias moves onto a version while it is deleted.
        Returns the deleted version numbers."""
        if keep_top_k < 0:
            return []
        with self._locked(name):
            keep = set(self.aliases(name).values())
            scored = [(m.get("score"), m["version"])
                      for m in self.versions(name)]
            ranked = sorted(((s, v) for s, v in scored if s is not None),
                            reverse=True)  # highest first
            keep.update(v for _, v in ranked[:keep_top_k])
            deleted = []
            for s, v in scored:
                if v not in keep:
                    shutil.rmtree(self.root / name / f"v{v}")
                    deleted.append(v)
        return deleted

    def publish_code(self, repo_root: str | Path, name: str = "code",
                     patterns: Sequence[str] = ("*.py", "*.cpp", "*.h",
                                                "Makefile")) -> str:
        """Snapshot the source tree as a tar.gz artifact (the reference's
        ``save_code=True``). Only files matching ``patterns`` under
        ``repo_root`` are included."""
        repo_root = Path(repo_root)
        tmp = self.root / f".code-{os.getpid()}.tar.gz"
        with tarfile.open(tmp, "w:gz") as tar:
            for pat in patterns:
                for p in sorted(repo_root.rglob(pat)):
                    if p.is_file() and ".git" not in p.parts:
                        tar.add(p, arcname=str(p.relative_to(repo_root)))
        try:
            return self.publish(tmp, name, metadata={"repo_root":
                                                     str(repo_root)})
        finally:
            tmp.unlink(missing_ok=True)

    # -- read side ----------------------------------------------------------

    def _version_numbers(self, name: str) -> List[int]:
        adir = self.root / name
        if not adir.is_dir():
            return []
        return [int(p.name[1:]) for p in adir.iterdir()
                if p.name.startswith("v") and p.name[1:].isdigit()
                and (p / "manifest.json").exists()]

    def versions(self, name: str) -> List[Dict[str, Any]]:
        out = []
        for v in sorted(self._version_numbers(name)):
            out.append(json.loads(
                (self.root / name / f"v{v}" / "manifest.json").read_text()))
        return out

    def aliases(self, name: str) -> Dict[str, int]:
        path = self.root / name / "aliases.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def resolve(self, uri: str, *, verify: bool = True
                ) -> Tuple[Path, Dict[str, Any]]:
        """``"<name>[@best|@last|@v<N>]"`` -> (payload path, manifest).
        Bare names resolve through the ``last`` alias, else the newest
        version (reference ``get_checkpoint`` downloads the artifact and
        returns the single file inside). With ``verify`` the payload md5s
        are re-checked against the manifest."""
        name, _, sel = uri.partition("@")
        if not self._version_numbers(name):
            raise FileNotFoundError(f"no artifact named {name!r} under "
                                    f"{self.root}")
        if sel.startswith("v") and sel[1:].isdigit():
            version = int(sel[1:])
        elif sel:
            aliases = self.aliases(name)
            if sel not in aliases:
                raise KeyError(f"artifact {name!r} has no alias {sel!r} "
                               f"(have {sorted(aliases)})")
            version = aliases[sel]
        else:
            version = self.aliases(name).get(
                "last", max(self._version_numbers(name)))
        vdir = self.root / name / f"v{version}"
        manifest = json.loads((vdir / "manifest.json").read_text())
        payload = vdir / "payload" / manifest["original_filename"]
        if verify:
            got = _file_manifest(payload)
            if got != manifest["files"]:
                bad = {k for k in set(got) | set(manifest["files"])
                       if got.get(k) != manifest["files"].get(k)}
                raise IOError(f"artifact {name}@v{version} failed md5 "
                              f"verification: {sorted(bad)[:5]}")
        return payload, manifest
