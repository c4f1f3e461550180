"""Snapshot persistence: ``index.save(path)`` / ``repro_torch.api.load(path)``.

The reference package's snapshot format, version 3, for the static and
the streaming kinds:

    <path>/
      MANIFEST.json     format + version, kind, LSHParams, IndexSpec, static
                        shapes, the segment catalog (streaming), cached
                        r_min estimates, per-file sha256 digests
      arrays.npz        (static) A, data, forest.<key> DE-Forest arrays
      plan.npz          (static, optional) plan.points_sorted, plan.inv_perm
      common.npz        (streaming) A, frozen breakpoints bp_all
      segment_<id>.npz  (streaming) rows, gids, tombstones, forest
                        [+ fused-plan constants when materialized]
      memtable.npz      (streaming) delta rows / gids / live bitmap
      common.npz        (pdet) A, breakpoints
      shard_<i>.npz     (pdet) the shard's data rows and its slice of every
                        position- and leaf-sharded forest array

A snapshot written by either package loads in the other and answers
identically; a pdet snapshot reshards on load to the devices present.
Saves are atomic (files staged into a temp sibling directory, fsynced and
published with ``os.replace``) and every file is checked against its
recorded digest on load (``SnapshotIntegrityError``).  The pre-digest
versions 1-2 raise ``NotImplementedError``.
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
_SHARDED_KINDS = ("pdet",)


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


def _rmin_dump(cache: dict) -> dict:
    return {str(k): float(v) for k, v in cache.items()}


def _rmin_load(d: Any) -> dict:
    return {int(k): float(v) for k, v in (d or {}).items()}


def _forest_arrays(forest: Any) -> dict:
    from repro_torch.core import FOREST_DTYPES
    return {"forest." + k: _np(getattr(forest, k)) for k in FOREST_DTYPES}


def _plan_arrays(plan: Any) -> dict:
    return {"plan.points_sorted": _np(plan.points_sorted),
            "plan.inv_perm": _np(plan.inv_perm)}


def save_static(index: Any, path: str) -> None:
    """Snapshot a ``core.DETLSH``: A, data, forest, fused-plan constants."""
    arrays = {"A": _np(index.A), "data": _np(index.data)}
    arrays.update(_forest_arrays(index.forest))
    files = {"arrays.npz": _npz_bytes(arrays)}
    has_plan = index._plan is not None
    if has_plan:
        files["plan.npz"] = _npz_bytes(_plan_arrays(index._plan))
    _publish_snapshot(path, files, {
        "format": FORMAT_NAME,
        "format_version": FORMAT_VERSION,
        "kind": "static",
        "params": dataclasses.asdict(index.params),
        "forest": {"n": index.forest.n, "leaf_size": index.forest.leaf_size},
        "spec": index.spec.to_dict() if index.spec is not None else None,
        "has_plan": has_plan,
        "r_min_cache": _rmin_dump(index._r_min_cache),
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
    index._r_min_cache.update(_rmin_load(manifest.get("r_min_cache")))
    return index


def save_streaming(index: Any, path: str) -> None:
    """Snapshot a ``streaming.StreamingDETLSH``: segments (with tombstone
    bitmaps), memtable survivors, frozen breakpoints, and the manifest —
    a restart resumes serving (and mutating) exactly where it left off."""
    files = {"common.npz": _npz_bytes({"A": _np(index.A),
                                       "bp_all": _np(index.bp_all)})}
    seg_entries = []
    for seg in index.manifest.segments:
        fname = f"segment_{seg.seg_id:06d}.npz"
        arrays = {"data": _np(seg.data), "gids": np.asarray(seg.gids),
                  "live": np.asarray(seg.live)}
        arrays.update(_forest_arrays(seg.forest))
        has_plan = seg._plan is not None
        if has_plan:
            arrays.update(_plan_arrays(seg._plan))
        files[fname] = _npz_bytes(arrays)
        seg_entries.append({
            "seg_id": seg.seg_id, "file": fname,
            "clip_fraction": seg.clip_fraction,
            "forest": {"n": seg.forest.n,
                       "leaf_size": seg.forest.leaf_size},
            "has_plan": has_plan,
        })
    mt = index.memtable
    files["memtable.npz"] = _npz_bytes(
        {"vecs": mt.vecs, "gids": mt.gids, "live": mt.live})
    # Only persist the r_min cache when it is current for this structure —
    # a stale (pre-mutation) cache must not be resurrected as fresh.
    rmin_tag, rmin_entries = index._rmin_cache
    if rmin_tag != (index.manifest.version, mt.version):
        rmin_entries = {}
    _publish_snapshot(path, files, {
        "format": FORMAT_NAME,
        "format_version": FORMAT_VERSION,
        "kind": "streaming",
        "params": dataclasses.asdict(index.params),
        "Nr": index.Nr, "leaf_size": index.leaf_size,
        "max_segments": index.max_segments,
        "id_capacity": index.id_capacity,
        "next_gid": index.next_gid,
        "next_seg_id": index._next_seg_id,
        "segments": seg_entries,
        "memtable": {"capacity": mt.capacity, "d": mt.d,
                     "count": mt.count},
        "spec": index.spec.to_dict() if index.spec is not None else None,
        "r_min_cache": _rmin_dump(rmin_entries),
    })


def _load_streaming(path: str, manifest: dict, device: Any) -> Any:
    import torch
    from repro_torch._device import to_device
    from repro_torch.api.spec import IndexSpec
    from repro_torch.core import forest_from_arrays, plan_from_arrays
    from repro_torch.streaming.index import (_DELTA, StreamingDETLSH,
                                             _locations)
    from repro_torch.streaming.segment import Segment

    common = _load_npz(path, "common.npz")
    mt_meta = _field(manifest, "memtable", dict, path)
    index = StreamingDETLSH(
        params=_params_from(manifest, path),
        A=to_device(common["A"], device, torch.float32),
        bp_all=to_device(common["bp_all"], device, torch.float32),
        base=None,
        Nr=_field(manifest, "Nr", int, path),
        leaf_size=_field(manifest, "leaf_size", int, path),
        delta_capacity=_field(mt_meta, "capacity", int, path),
        max_segments=_field(manifest, "max_segments", int, path),
        id_capacity=_field(manifest, "id_capacity", int, path))
    spec = manifest.get("spec")
    index.spec = IndexSpec.from_dict(spec) if spec is not None else None
    if index.spec is not None:      # the seal path keeps the spec's builder
        index.build_impl = index.spec.build_impl

    segments = _field(manifest, "segments", list, path)
    for entry in segments:
        arrays = _load_npz(path, _field(entry, "file", str, path))
        fmeta = _field(entry, "forest", dict, path)
        seg = Segment(seg_id=_field(entry, "seg_id", int, path),
                      data=to_device(arrays["data"], device, torch.float32),
                      gids=np.asarray(arrays["gids"]),
                      live=np.asarray(arrays["live"]).copy(),
                      forest=forest_from_arrays(
                          arrays, n=_field(fmeta, "n", int, path),
                          leaf_size=_field(fmeta, "leaf_size", int, path),
                          device=device),
                      clip_fraction=float(entry["clip_fraction"]))
        if entry.get("has_plan"):
            seg._plan = plan_from_arrays(arrays, device)
        index.manifest.add(seg)
        live_rows = np.flatnonzero(seg.live)
        index.locator.update(_locations(seg.gids[live_rows], seg.seg_id,
                                        live_rows.tolist()))

    mt = index.memtable
    saved = _load_npz(path, "memtable.npz")
    try:
        mt.vecs[:] = saved["vecs"]
        mt.gids[:] = saved["gids"]
        mt.live[:] = saved["live"]
    except (ValueError, TypeError) as exc:
        raise SnapshotFormatError(
            f"{saved.path!r}: memtable arrays do not match the manifest's "
            f"capacity/d ({type(exc).__name__}: {exc})") from exc
    mt.count = _field(mt_meta, "count", int, path)
    mt.version += 1
    live_slots = np.flatnonzero(mt.live[: mt.count])
    index.locator.update(_locations(mt.gids[live_slots], _DELTA,
                                    live_slots.tolist()))

    index.next_gid = _field(manifest, "next_gid", int, path)
    index._next_seg_id = _field(manifest, "next_seg_id", int, path)
    index._rmin_cache = ((index.manifest.version, mt.version),
                         _rmin_load(manifest.get("r_min_cache")))
    return index


_PDET_POINT_KEYS = ("point_ids", "proj_sorted", "codes_sorted", "valid")
_PDET_LEAF_KEYS = ("leaf_lo", "leaf_hi", "leaf_valid")


def save_pdet(index: Any, path: str) -> None:
    """Snapshot a ``core.distributed.PDETIndex`` as per-shard files: one
    ``shard_<i>.npz`` per layout shard (its data rows and its slice of every
    position- or leaf-sharded forest array) plus the shard map in
    MANIFEST.json, exactly as the reference writes them."""
    forest = index.forest
    S = index.placement.n_shards
    n = index.data.shape[0]
    # Positions and leaves divide exactly (the layout is padded to a shard
    # multiple); data rows may not, so they split as evenly as possible.
    pos = forest.point_ids.shape[1] // S
    leaves = forest.leaf_valid.shape[1] // S
    row_bounds = [round(s * n / S) for s in range(S + 1)]
    files = {"common.npz": _npz_bytes(
        {"A": _np(index.A), "breakpoints": _np(forest.breakpoints)})}
    shard_entries = []
    for s in range(S):
        fname = f"shard_{s:05d}.npz"
        arrays = {"data": _np(index.data[row_bounds[s]:row_bounds[s + 1]])}
        for k in _PDET_POINT_KEYS:
            arrays[k] = _np(getattr(forest, k)[:, s * pos:(s + 1) * pos])
        for k in _PDET_LEAF_KEYS:
            arrays[k] = _np(getattr(forest, k)[:, s * leaves:(s + 1) * leaves])
        files[fname] = _npz_bytes(arrays)
        shard_entries.append({
            "shard": s, "file": fname,
            "rows": [row_bounds[s], row_bounds[s + 1]],
            "positions": [s * pos, (s + 1) * pos],
            "leaves": [s * leaves, (s + 1) * leaves],
        })
    _publish_snapshot(path, files, {
        "format": FORMAT_NAME,
        "format_version": FORMAT_VERSION,
        "kind": "pdet",
        "params": dataclasses.asdict(index.params),
        "forest": {"n": forest.n, "leaf_size": forest.leaf_size},
        "spec": index.spec.to_dict() if index.spec is not None else None,
        "placement": index.placement.to_dict(),
        "shards": shard_entries,
        "r_min_cache": _rmin_dump(index._r_min_cache),
    })


def _fit_placement(saved: Any, device: Any) -> Any:
    """Reshard-on-load policy: keep the saved placement where the devices
    hold it (the CPU holds any; CUDA needs one card a mesh device), else
    the widest one-axis ('data',) placement over the cards present, so a
    pdet snapshot loads anywhere; answers are the same either way."""
    import torch
    from repro_torch.api.spec import PlacementSpec
    if device.type == "cpu":
        return saved
    avail = torch.cuda.device_count()
    if saved.n_devices <= avail:
        return saved
    return PlacementSpec(mesh_shape=(avail,), mesh_axes=("data",))


def _load_pdet(path: str, manifest: dict, placement: Any,
               device: Any) -> Any:
    import torch
    from repro_torch._device import to_device
    from repro_torch.api.spec import IndexSpec, PlacementSpec
    from repro_torch.core import FOREST_DTYPES, DETLSH
    from repro_torch.core.detree import DEForest
    from repro_torch.core.distributed import PDETIndex

    common = _load_npz(path, "common.npz")
    entries = _field(manifest, "shards", list, path)
    entries = sorted(entries, key=lambda e: _field(e, "shard", int, path))
    shards = [_load_npz(path, _field(e, "file", str, path)) for e in entries]
    fmeta = _field(manifest, "forest", dict, path)
    forest = DEForest(
        n=_field(fmeta, "n", int, path),
        leaf_size=_field(fmeta, "leaf_size", int, path),
        breakpoints=to_device(common["breakpoints"], device, torch.float32),
        **{k: to_device(np.concatenate([sh[k] for sh in shards], axis=1),
                        device, FOREST_DTYPES[k])
           for k in _PDET_POINT_KEYS + _PDET_LEAF_KEYS})
    data = to_device(np.concatenate([sh["data"] for sh in shards], axis=0),
                     device, torch.float32)
    spec = manifest.get("spec")
    spec = IndexSpec.from_dict(spec) if spec is not None else None
    det = DETLSH(params=_params_from(manifest, path),
                 A=to_device(common["A"], device, torch.float32),
                 forest=forest, data=data,
                 spec=(dataclasses.replace(spec, placement=None)
                       if spec is not None else None))
    det._r_min_cache.update(_rmin_load(manifest.get("r_min_cache")))
    try:
        saved = PlacementSpec.from_dict(
            _field(manifest, "placement", dict, path))
    except SnapshotFormatError:
        raise
    except (TypeError, ValueError, KeyError) as exc:
        raise SnapshotFormatError(
            f"{path!r}: manifest field 'placement' does not describe a "
            f"PlacementSpec ({type(exc).__name__}: {exc})") from exc
    eff = placement if placement is not None else _fit_placement(saved,
                                                                 device)
    # The attached spec describes the index as it now lives: a resharded
    # load carries the effective placement, not the saved one.
    if spec is not None and spec.placement != eff:
        spec = dataclasses.replace(spec, placement=eff)
    return PDETIndex.from_detlsh(det, eff, spec=spec)


def save(index: Any, path: str) -> None:
    """Snapshot an index (dispatch lives on the index: calls ``save``)."""
    index.save(path)


def load(path: str, placement: Any = None, *,
         device: Optional[Any] = None) -> Any:
    """Read a snapshot directory back into a live index on ``device``
    (CUDA unless the caller asks otherwise): a ``core.DETLSH``, a
    ``streaming.StreamingDETLSH`` or a ``core.distributed.PDETIndex``
    according to the manifest's ``kind``.

    ``placement`` applies to sharded (pdet) snapshots only and overrides
    the reshard-on-load policy (the saved placement where the devices hold
    it, else the widest ('data',) placement over the cards present; on the
    CPU every shard count fits).  Answers are the same either way.

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
    if kind in _SHARDED_KINDS:
        return _load_pdet(path, manifest, placement, dev)
    if placement is not None:
        raise ValueError(f"placement= only applies to sharded (pdet) "
                         f"snapshots; this one is kind={kind!r}")
    if kind == "static":
        return _load_static(path, manifest, dev)
    if kind == "streaming":
        return _load_streaming(path, manifest, dev)
    raise SnapshotFormatError(f"{path!r}: unknown snapshot kind {kind!r}")
