"""Snapshot persistence: ``index.save(path)`` / ``repro_torch.api.load(path)``.

The reference package's snapshot format, version 3, for the static kind:

    <path>/
      MANIFEST.json   format + version, kind, LSHParams, IndexSpec, forest
                      statics, cached r_min estimates, per-file sha256 digests
      arrays.npz      A, data, forest.<key> DE-Forest arrays
      plan.npz        (optional) plan.points_sorted, plan.inv_perm

A snapshot written by either package loads in the other and answers
identically.  Saves are atomic (files staged into a temp sibling
directory, fsynced and published with ``os.replace``) and every file is
checked against its recorded digest on load (``SnapshotIntegrityError``).
Streaming and sharded (pdet) snapshots, and the pre-digest versions 1-2,
raise ``NotImplementedError`` in this slice of the port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np

FORMAT_NAME = "repro-ann-snapshot"
FORMAT_VERSION = 3
_NOT_YET_KINDS = ("streaming", "pdet")


class SnapshotFormatError(ValueError):
    """The directory is not a snapshot this build can read."""


class SnapshotIntegrityError(SnapshotFormatError):
    """A snapshot file's bytes do not match the digest its MANIFEST
    recorded at save time — bit rot, truncation, or tampering."""


def _np(t: Any) -> np.ndarray:
    return t.detach().cpu().numpy()


def _atomic_write_bytes(fpath: str, data: bytes) -> None:
    """Temp file + fsync + ``os.replace``: a reader of ``fpath`` sees the
    old bytes or the new bytes, never a torn write."""
    tmp = fpath + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fpath)


def _fsync_dir(path: str) -> None:
    """Directory fsync (commits renames on POSIX); best-effort where a
    directory cannot be opened."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _sha256_hex(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def _publish_snapshot(path: str, files: dict, manifest: dict) -> None:
    """Write a snapshot directory atomically: stage the files and the
    MANIFEST carrying their digests in a temp sibling, fsync, then rename
    into place (swapping out an existing snapshot with a second rename)."""
    path = os.fspath(path)
    manifest = dict(manifest)
    manifest["digests"] = {fname: _sha256_hex(data)
                           for fname, data in sorted(files.items())}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".stage-",
                           dir=parent)
    try:
        for fname in sorted(files):
            _atomic_write_bytes(os.path.join(tmp, fname), files[fname])
        _atomic_write_bytes(
            os.path.join(tmp, "MANIFEST.json"),
            json.dumps(manifest, indent=1, sort_keys=True).encode())
        _fsync_dir(tmp)
        if os.path.isdir(path):
            old = tmp + ".old"
            os.rename(path, old)
            try:
                os.replace(tmp, path)
            except BaseException:
                os.rename(old, path)       # restore the prior snapshot
                raise
            _fsync_dir(parent)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
            _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _verify_digests(path: str, manifest: dict) -> None:
    """Check every file against the manifest's recorded sha256."""
    digests = manifest.get("digests")
    if not isinstance(digests, dict):
        raise SnapshotFormatError(
            f"{path!r}: format_version {FORMAT_VERSION} snapshot carries no "
            f"'digests' object — the manifest is malformed")
    for fname in sorted(digests):
        want = digests[fname]
        if not isinstance(want, str):
            raise SnapshotFormatError(
                f"{path!r}: digest for {fname!r} must be a string, got "
                f"{type(want).__name__}")
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            raise SnapshotIntegrityError(
                f"{fpath!r}: snapshot file is missing (the manifest's "
                f"digests reference it)")
        h = hashlib.sha256()
        with open(fpath, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        got = "sha256:" + h.hexdigest()
        if got != want:
            raise SnapshotIntegrityError(
                f"{fpath!r}: snapshot file is truncated or corrupt on "
                f"disk — sha256 {got} != recorded {want}")


class _SnapshotArrays(dict):
    """Eagerly-read npz contents; a missing key is a format error naming
    the offending file."""

    def __init__(self, path: str, values: dict) -> None:
        super().__init__(values)
        self.path = path

    def __missing__(self, key: str) -> Any:
        raise SnapshotFormatError(
            f"{self.path!r}: snapshot array {key!r} is missing "
            f"(have: {sorted(self.keys())})")


def _load_npz(path: str, fname: str) -> _SnapshotArrays:
    """Read one snapshot .npz completely; every failure mode becomes a
    ``SnapshotFormatError`` that names the file."""
    fpath = os.path.join(path, fname)
    if not os.path.isfile(fpath):
        raise SnapshotFormatError(f"{fpath!r}: snapshot file is missing")
    try:
        with np.load(fpath, allow_pickle=False) as npz:
            values = {k: npz[k] for k in npz.files}
    except Exception as exc:
        raise SnapshotFormatError(
            f"{fpath!r}: snapshot file is truncated or corrupt "
            f"({type(exc).__name__}: {exc})") from exc
    return _SnapshotArrays(fpath, values)


def _field(mapping: Any, key: str, typ: type, where: str) -> Any:
    """Manifest field access: missing keys and wrong types both raise
    ``SnapshotFormatError`` naming the path and field."""
    if not isinstance(mapping, dict) or key not in mapping:
        raise SnapshotFormatError(f"{where}: manifest field {key!r} is "
                                  f"missing")
    val = mapping[key]
    if not isinstance(val, typ) or (typ is int and isinstance(val, bool)):
        raise SnapshotFormatError(
            f"{where}: manifest field {key!r} must be {typ.__name__}, got "
            f"{type(val).__name__} ({val!r})")
    return val


def _read_manifest(path: str) -> dict:
    mpath = os.path.join(path, "MANIFEST.json")
    if not os.path.isfile(mpath):
        raise SnapshotFormatError(f"{path!r} is not a snapshot directory "
                                  f"(no MANIFEST.json)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as exc:
        raise SnapshotFormatError(
            f"{mpath!r}: MANIFEST.json is unreadable or not valid JSON "
            f"({type(exc).__name__}: {exc})") from exc
    if not isinstance(manifest, dict):
        raise SnapshotFormatError(f"{mpath!r}: MANIFEST.json must hold a "
                                  f"JSON object")
    if manifest.get("format") != FORMAT_NAME:
        raise SnapshotFormatError(
            f"{path!r}: manifest format {manifest.get('format')!r} is not "
            f"{FORMAT_NAME!r}")
    ver = manifest.get("format_version")
    if ver in (1, 2):
        raise NotImplementedError(
            f"{path!r}: format_version {ver} (pre-digest) snapshots load in "
            f"the reference package; the PyTorch port reads version "
            f"{FORMAT_VERSION} — re-save the index there first")
    if ver != FORMAT_VERSION:
        raise SnapshotFormatError(
            f"{path!r}: snapshot format_version {ver!r} is not supported "
            f"(supported: {FORMAT_VERSION})")
    return manifest


def _params_from(manifest: dict, where: str) -> Any:
    from repro_torch.core.theory import LSHParams
    d = _field(manifest, "params", dict, where)
    try:
        return LSHParams(**d)
    except (TypeError, ValueError) as exc:
        raise SnapshotFormatError(
            f"{where}: manifest field 'params' does not describe LSHParams "
            f"({type(exc).__name__}: {exc})") from exc


def save_static(index: Any, path: str) -> None:
    """Snapshot a ``core.DETLSH``: A, data, forest, fused-plan constants."""
    from repro_torch.core import FOREST_DTYPES
    arrays = {"A": _np(index.A), "data": _np(index.data)}
    arrays.update({"forest." + k: _np(getattr(index.forest, k))
                   for k in FOREST_DTYPES})
    files = {"arrays.npz": _npz_bytes(arrays)}
    has_plan = index._plan is not None
    if has_plan:
        files["plan.npz"] = _npz_bytes(
            {"plan.points_sorted": _np(index._plan.points_sorted),
             "plan.inv_perm": _np(index._plan.inv_perm)})
    _publish_snapshot(path, files, {
        "format": FORMAT_NAME,
        "format_version": FORMAT_VERSION,
        "kind": "static",
        "params": dataclasses.asdict(index.params),
        "forest": {"n": index.forest.n, "leaf_size": index.forest.leaf_size},
        "spec": index.spec.to_dict() if index.spec is not None else None,
        "has_plan": has_plan,
        "r_min_cache": {str(k): float(v)
                        for k, v in index._r_min_cache.items()},
    })


def _load_static(path: str, manifest: dict, device: Any) -> Any:
    from repro_torch.api.spec import IndexSpec
    from repro_torch.core import DETLSH
    arrays = dict(_load_npz(path, "arrays.npz"))
    if manifest.get("has_plan"):
        arrays.update(_load_npz(path, "plan.npz"))
    fmeta = _field(manifest, "forest", dict, path)
    spec = manifest.get("spec")
    index = DETLSH.from_arrays(
        _SnapshotArrays(path, arrays), _params_from(manifest, path),
        n=_field(fmeta, "n", int, path),
        leaf_size=_field(fmeta, "leaf_size", int, path),
        spec=IndexSpec.from_dict(spec) if spec is not None else None,
        device=device)
    index._r_min_cache.update({int(k): float(v) for k, v in
                               (manifest.get("r_min_cache") or {}).items()})
    return index


def save(index: Any, path: str) -> None:
    """Snapshot an index (dispatch lives on the index: calls ``save``)."""
    index.save(path)


def load(path: str, *, device: Optional[Any] = None) -> Any:
    """Read a static snapshot directory back into a live ``core.DETLSH``
    on ``device`` (CUDA unless the caller asks otherwise).

    Raises ``SnapshotFormatError`` on any format mismatch and
    ``SnapshotIntegrityError`` when a file's bytes no longer match the
    digest recorded at save time.
    """
    from repro_torch._device import resolve_device
    dev = resolve_device(device)
    path = os.fspath(path)
    manifest = _read_manifest(path)
    _verify_digests(path, manifest)
    kind = manifest.get("kind")
    if kind in _NOT_YET_KINDS:
        raise NotImplementedError(
            f"{path!r}: {kind!r} snapshots load in the reference package; "
            f"the PyTorch port reads the static kind in this slice")
    if kind != "static":
        raise SnapshotFormatError(f"{path!r}: unknown snapshot kind {kind!r}")
    return _load_static(path, manifest, dev)
