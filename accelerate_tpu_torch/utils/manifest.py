"""Atomic checkpoint manifests: the commit protocol for resilient saves.

A copy of `accelerate_tpu/utils/manifest.py` (which imports no jax, but
importing it runs the JAX package's `__init__`). The name, the version,
the JSON layout and the ordering by (step, commit time) are the
reference's, so a directory committed by either package reads the same
in both.

A checkpoint directory is COMPLETE iff it contains a manifest that (a)
parses and (b) lists only files that exist. The manifest is written to a
temp name and `os.replace`d into place — the one atomic primitive POSIX
filesystems give us — strictly AFTER every byte it describes is durable.
A crash at any byte offset therefore leaves either (no manifest → the
directory is ignored by resume) or (manifest → every listed file landed):
there is no state in which resume loads a torn checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

__all__ = [
    "MANIFEST_NAME",
    "write_manifest",
    "read_manifest",
    "is_complete",
    "complete_checkpoints",
    "latest_complete",
    "prune_complete",
]

MANIFEST_NAME = "checkpoint.manifest.json"
MANIFEST_VERSION = 1


def write_manifest(directory: str, *, step: int = 0,
                   files: Iterable[str] = (),
                   extra: dict | None = None) -> str:
    """Atomically publish `directory` as a complete checkpoint. Call ONLY
    after every file in `files` is fully written (for async array writes:
    after the writer thread finished them). Returns the manifest path."""
    directory = os.path.abspath(directory)
    manifest: dict[str, Any] = {
        "version": MANIFEST_VERSION,
        "step": int(step),
        "files": sorted(set(files)),
    }
    if extra:
        manifest["extra"] = extra
    final = os.path.join(directory, MANIFEST_NAME)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return final


def read_manifest(directory: str) -> dict | None:
    """The parsed manifest, or None when missing/corrupt. Corruption is
    treated exactly like absence: the directory is simply not a committed
    checkpoint (a torn manifest can only be a bug elsewhere — the atomic
    rename never exposes partial writes)."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or not isinstance(
            manifest.get("files"), list):
        return None
    return manifest


def is_complete(directory: str) -> bool:
    """True iff `directory` has a readable manifest and every listed file
    exists (a deleted shard after commit demotes the checkpoint)."""
    manifest = read_manifest(directory)
    if manifest is None:
        return False
    return all(
        os.path.exists(os.path.join(directory, str(name)))
        for name in manifest["files"]
    )


def _sort_key(directory: str) -> tuple:
    manifest = read_manifest(directory) or {}
    try:
        mtime = os.path.getmtime(os.path.join(directory, MANIFEST_NAME))
    except OSError:
        mtime = 0.0
    return (int(manifest.get("step", 0)), mtime, directory)


def complete_checkpoints(base_dir: str) -> list[str]:
    """Complete checkpoint directories under `base_dir` (or `base_dir`
    itself when it carries a manifest), oldest first by (step, commit
    time). Incomplete/torn directories are skipped, not errors."""
    base_dir = os.path.abspath(base_dir)
    if is_complete(base_dir):
        return [base_dir]
    if not os.path.isdir(base_dir):
        return []
    found = [
        path
        for name in os.listdir(base_dir)
        if os.path.isdir(path := os.path.join(base_dir, name))
        and is_complete(path)
    ]
    return sorted(found, key=_sort_key)


def latest_complete(base_dir: str) -> str | None:
    """The newest complete checkpoint under `base_dir`, or None."""
    found = complete_checkpoints(base_dir)
    return found[-1] if found else None


def prune_complete(base_dir: str, keep_last_n: int,
                   protected: Iterable[str] = ()) -> list[str]:
    """Delete all but the newest `keep_last_n` complete checkpoints under
    `base_dir`; returns the removed paths. The newest complete checkpoint
    is NEVER deleted (`keep_last_n` is clamped to >= 1): retention must
    not be able to destroy the only resume point. `protected` paths
    (e.g. a directory whose async writes are still in flight) are skipped
    regardless of age. Incomplete directories are left alone — they may
    be mid-write."""
    import shutil

    keep = max(1, int(keep_last_n))
    protected = {os.path.abspath(p) for p in protected}
    victims = [
        path for path in complete_checkpoints(base_dir)[:-keep]
        if os.path.abspath(path) != os.path.abspath(base_dir)
        and os.path.abspath(path) not in protected
    ]
    for path in victims:
        shutil.rmtree(path, ignore_errors=True)
    return victims
