"""Atomic, async checkpointing with a content-addressed chunk store.

Full-snapshot layout:  <dir>/step_<N>/
            manifest.json      tree structure, shapes, dtypes, step
            <leafpath>.npy     one file per leaf
            COMMITTED          empty marker written LAST (atomicity)

Incremental (content-addressed) layout, used by the streaming index
snapshots (``save_incremental``):

    <dir>/chunks/<digest>.npy  immutable leaf payloads, keyed by a
                               blake2b content address and shared by
                               every step that references them
    <dir>/step_<N>/
            manifest.json      leaf path -> {chunk, shape, dtype}
            COMMITTED          same atomicity marker

The on-disk format is ``repro.checkpoint.manager``'s, byte for byte in
the manifests' keys and the chunk names: a step saved by either package
restores into the other, and equal states saved incrementally write the
same chunk files.  A frozen LSM level never changes after it is built,
so consecutive snapshots reference the same chunks and write only the
delta, the tombstone bitmaps and the manifest.  Chunk files are
published with an atomic rename, and a reference-counting GC removes
chunks no committed step references once ``keep``-pruning drops their
last step.

Fault-tolerance contract:
  * a crash mid-save leaves no COMMITTED marker -> restore skips it;
  * restore() picks the newest committed step;
  * manager init sweeps torn-write litter: ``step_*.tmp`` dirs,
    uncommitted ``step_*`` dirs, half-written chunk tmp files, and
    orphaned chunks;
  * saves run on a background thread, joined before the next save or
    by ``wait()``, which re-raises what the writer raised.

The host copy happens on the caller's thread.  ``save`` and
``save_incremental`` take every tensor leaf to a host numpy copy
(``host_copy``) before they return; only the disk write runs on the
writer thread.  A tensor the caller goes on mutating in place (the
streaming delta, updated by ``index_put_``) therefore cannot race the
write.  bfloat16 tensors are stored as their uint16 view under the
logical dtype ``"bfloat16"`` (numpy has no bfloat16), as the reference
stores them.

``fault_hook`` is the crash-fault-injection seam: tests pass a callable
that raises at named points ("leaf" after each leaf/chunk write,
"pre_commit" before the marker, "post_commit" after the publish) to
prove restores are bit-exact at every torn-write boundary.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import resolve_device

__all__ = ["CheckpointManager", "array_digest", "host_copy"]

_COMMIT = "COMMITTED"
_CHUNKS = "chunks"


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` that shares no memory with it (a CPU
    tensor's ``.numpy()`` would be a view)."""
    return t.detach().to("cpu", copy=True).numpy()


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """One leaf as (the host array written to disk, its logical dtype):
    tensors are copied to the host; bfloat16 (a torch tensor, or a numpy
    array of ``ml_dtypes``' type handed over by the reference) is stored
    as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return host_copy(leaf.view(torch.int16)).view(np.uint16), "bfloat16"
        arr = host_copy(leaf)
    else:
        arr = np.asarray(leaf)
    logical = str(arr.dtype)
    return (arr.view(np.uint16) if logical == "bfloat16" else arr), logical


def array_digest(arr) -> str:
    """Content address of one stored leaf: blake2b over dtype + shape +
    raw bytes.  bfloat16 hashes as its stored uint16 view so the digest
    always matches the bytes on disk; a tensor is hashed as its host
    copy, so an equal array gets the reference's digest."""
    arr, _ = _stored(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _flatten(tree, prefix=""):
    """{leaf path: leaf} over nested dicts (sorted keys), lists and
    tuples; anything else (a tensor, an array, a scalar) is a leaf."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any], template):
    if isinstance(template, dict):
        return {k: _unflatten(
            {p[len(k) + 1:]: v for p, v in flat.items()
             if p.split("/")[0] == k}, template[k]) for k in template}
    if isinstance(template, (list, tuple)):
        typ = type(template)
        vals = [
            _unflatten({p[len(str(i)) + 1:]: v for p, v in flat.items()
                        if p.split("/")[0] == str(i)}, template[i])
            for i in range(len(template))]
        return typ(vals)
    if len(flat) != 1 or "" not in flat:
        raise KeyError(f"checkpoint leaves {sorted(flat)} do not match the "
                       f"template's leaf")
    return flat[""]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _map_pairs(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _map_pairs(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_pairs(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _to_tensor(leaf, device: torch.device):
    """A leaf as a tensor on ``device``; a string array (no tensor holds
    one) stays a host array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    a = np.array(leaf)
    if a.dtype.kind in "US":
        return a
    return torch.from_numpy(a).to(device)   # 0-d stays 0-d


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 fault_hook: Optional[Callable[..., None]] = None):
        self.dir = directory
        self.keep = keep
        self._fault_hook = fault_hook
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._saves = 0
        self._incremental_saves = 0
        self._chunks_written = 0
        self._chunks_reused = 0
        self._bytes_written = 0
        self._bytes_reused = 0
        self._chunks_gced = 0
        self._litter_swept = 0
        self._last_save_seconds = 0.0
        self._last_restore_seconds = 0.0
        os.makedirs(directory, exist_ok=True)
        self._sweep_litter()

    def _fault(self, point: str, **info) -> None:
        """Crash-fault-injection seam: tests install a hook that raises
        at a named save-path point (see module docstring)."""
        if self._fault_hook is not None:
            self._fault_hook(point, **info)

    # --------------------------------------------------------------- save
    def _start(self, write: Callable[[], None], blocking: bool) -> None:
        """Run ``write`` here, or on the writer thread; a writer's
        exception is kept and re-raised by ``wait``."""
        if blocking:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:     # handed to wait(), re-raised
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _publish(self, tmp: str, final: str, manifest: dict, step: int):
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._fault("pre_commit", step=step)
        with open(os.path.join(tmp, _COMMIT), "w"):
            pass
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._fault("post_commit", step=step)

    def _step_tmp(self, step: int) -> Tuple[str, str]:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp, final

    def save(self, step: int, state, blocking: bool = False):
        """Full (self-contained) snapshot: every leaf written under the
        step dir.  ``save_incremental`` is the content-addressed
        variant the streaming snapshots use.  The leaves' host copies
        are taken before this returns."""
        self.wait()
        flat = {p: _stored(v) for p, v in _flatten(state).items()}

        def _write():
            t0 = time.perf_counter()
            tmp, final = self._step_tmp(step)
            manifest = {"step": step, "leaves": {}}
            for i, (path, (arr, logical)) in enumerate(flat.items()):
                fn = path.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"][path] = {
                    "file": fn, "shape": list(arr.shape),
                    "dtype": logical}
                self._fault("leaf", path=path, index=i)
            self._publish(tmp, final, manifest, step)
            self._saves += 1
            self._last_save_seconds = time.perf_counter() - t0
            self._gc()

        self._start(_write, blocking)

    def save_incremental(self, step: int, state,
                         digests: Optional[Dict[str, str]] = None,
                         blocking: bool = False):
        """Content-addressed snapshot: write only chunks the store does
        not already hold; the step dir carries just the manifest and
        the COMMITTED marker, so consecutive snapshots of a streaming
        index cost O(delta + tombstones + manifest) bytes.  The leaves'
        host copies are taken before this returns.

        ``digests``: optional {leaf path: content address} hints for
        leaves the caller knows are immutable (frozen-level arrays,
        cached by ``streaming.segment.frozen_digests``); a hinted leaf
        whose chunk already exists is referenced without re-hashing.
        Hints must only ever be supplied for truly immutable arrays.
        """
        self.wait()
        digests = dict(digests or {})
        flat = {p: _stored(v) for p, v in _flatten(state).items()}

        def _write():
            t0 = time.perf_counter()
            cdir = os.path.join(self.dir, _CHUNKS)
            os.makedirs(cdir, exist_ok=True)
            tmp, final = self._step_tmp(step)
            manifest = {"step": step, "format": "chunks", "leaves": {}}
            for i, (path, (stored, logical)) in enumerate(flat.items()):
                dg = digests.get(path)
                if dg is not None and not os.path.exists(
                        os.path.join(cdir, dg + ".npy")):
                    dg = None      # first sighting: hash + write below
                if dg is None:
                    dg = array_digest(stored)
                cfn = os.path.join(cdir, dg + ".npy")
                if os.path.exists(cfn):
                    self._chunks_reused += 1
                    self._bytes_reused += stored.nbytes
                else:
                    ctmp = cfn + ".tmp"
                    with open(ctmp, "wb") as f:
                        np.save(f, stored)
                    os.replace(ctmp, cfn)   # atomic chunk publish
                    self._chunks_written += 1
                    self._bytes_written += stored.nbytes
                manifest["leaves"][path] = {
                    "chunk": dg, "shape": list(stored.shape),
                    "dtype": logical}
                self._fault("leaf", path=path, index=i)
            self._publish(tmp, final, manifest, step)
            self._incremental_saves += 1
            self._last_save_seconds = time.perf_counter() - t0
            self._gc()
            self._gc_chunks()

        self._start(_write, blocking)

    def wait(self):
        """Join the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def _gc_chunks(self):
        """Drop chunks no committed step references (runs after every
        incremental save and at init, so keep-pruning a step also frees
        the chunk bytes only it referenced)."""
        cdir = os.path.join(self.dir, _CHUNKS)
        if not os.path.isdir(cdir):
            return
        referenced = set()
        for s in self.committed_steps():
            for meta in self._manifest(s)["leaves"].values():
                if "chunk" in meta:
                    referenced.add(meta["chunk"] + ".npy")
        for name in os.listdir(cdir):
            if name not in referenced:
                os.remove(os.path.join(cdir, name))
                self._chunks_gced += 1

    def _sweep_litter(self):
        """Torn-write hygiene at startup: a crash mid-save leaves
        ``step_*.tmp`` dirs, uncommitted ``step_*`` dirs, and chunk
        ``*.tmp`` files that ``keep``-pruning never counts; a crash
        between chunk writes and the commit leaves orphaned chunks.
        All are swept here so a restart converges to exactly the
        committed steps plus the chunks they reference."""
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)
                self._litter_swept += 1
            elif (name.startswith("step_") and os.path.isdir(p)
                  and not os.path.exists(os.path.join(p, _COMMIT))):
                shutil.rmtree(p, ignore_errors=True)
                self._litter_swept += 1
        cdir = os.path.join(self.dir, _CHUNKS)
        if os.path.isdir(cdir):
            for name in os.listdir(cdir):
                if ".tmp" in name:
                    os.remove(os.path.join(cdir, name))
                    self._litter_swept += 1
            self._gc_chunks()

    # ------------------------------------------------------ observability
    def stats(self) -> Dict[str, object]:
        """Snapshot-cost counters (pinned: obs/schema.py
        ``CHECKPOINT_STATS_KEYS``).  ``bytes_written``/``bytes_reused``
        split each incremental save into new chunk bytes vs bytes
        referenced from the store."""
        return {
            "saves": self._saves,
            "incremental_saves": self._incremental_saves,
            "chunks_written": self._chunks_written,
            "chunks_reused": self._chunks_reused,
            "bytes_written": self._bytes_written,
            "bytes_reused": self._bytes_reused,
            "chunks_gced": self._chunks_gced,
            "litter_swept": self._litter_swept,
            "steps_kept": len(self.committed_steps()),
            "last_save_seconds": self._last_save_seconds,
            "last_restore_seconds": self._last_restore_seconds,
        }

    # ------------------------------------------------------------ restore
    def committed_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name, _COMMIT)):
                out.append(int(name[5:]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "manifest.json")) as f:
            return json.load(f)

    # ---------------------------------------------------- streaming index
    def save_index(self, step: int, index, blocking: bool = True,
                   incremental: bool = False):
        """Snapshot a streaming index's segment state.

        ``index`` is any object with a ``state_dict()`` returning host
        arrays (``DynamicHybridIndex`` or the row-sharded
        ``ShardedDynamicHybridIndex``); every level of the segment stack,
        the delta, and the tombstone buffers land as one leaf each under
        the usual atomic COMMITTED protocol.  A sharded index's leaves
        keep their leading shard axis, and its placement policy's name
        and per-shard level layouts (``rows_s`` / ``live_s`` meta) ride
        along, so rebalanced states round-trip exactly.
        ``incremental=True`` uses the content-addressed layout and the
        index's ``state_digests()`` hints (when it has them), so
        unchanged frozen levels are referenced, not rewritten.

        With a ``CompactionDriver`` running, call this inside
        ``driver.consistent_cut(lambda: mgr.save_index(...))``: the cut
        holds the driver's lock, so the worker is excluded while
        ``state_dict()`` copies the index to the host (on this thread,
        before this returns), and with ``blocking=False`` the disk
        write then runs on the writer thread, outside the cut.
        """
        if incremental:
            hints = getattr(index, "state_digests", None)
            self.save_incremental(step, index.state_dict(),
                                  digests=hints() if hints else None,
                                  blocking=blocking)
        else:
            self.save(step, index.state_dict(), blocking=blocking)

    def restore_index(self, index, step: Optional[int] = None):
        """Restore segment state into ``index`` (constructed with the
        same family/config as the one that saved, on the device or mesh
        the restored state should live on; a sharded index on a mesh of
        another shard count re-partitions the saved rows, the elastic
        restore).  Returns the step, or None when no committed checkpoint
        exists.

        The restore is manifest-driven (``restore_tree``), not
        template-driven: a streaming index's level stack is a variable
        number of frozen segments, so the saved structure — however many
        levels, mid-merge or not — is reconstructed from leaf paths."""
        state, step = self.restore_tree(step=step)
        if state is None:
            return None
        index.load_state_dict(state)
        return step

    def collection_names(self, step: Optional[int] = None):
        """Collections present in a committed step's manifest.

        Multi-tenant snapshots nest every tenant under
        ``collections/<name>/...`` leaf paths.  This reads JUST the
        manifest (no array loads).  Returns sorted names; [] when the
        step predates collections or nothing is committed.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            return []
        names = {path.split("/")[1] for path in self._manifest(step)["leaves"]
                 if path.startswith("collections/")}
        return sorted(names)

    def restore_tree(self, step: Optional[int] = None):
        """Load a committed step as nested dicts rebuilt from leaf paths.

        No template needed: ``a/b/c`` becomes ``{"a": {"b": {"c": arr}}}``
        with host numpy leaves; a bfloat16 leaf comes back as a CPU
        ``torch.bfloat16`` tensor, the one host type that holds it.
        This is how variable-structure states (the streaming indexes'
        level lists) round-trip.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        t0 = time.perf_counter()
        state: Dict[str, Any] = {}
        for path, arr in self._load_leaves(step):
            node = state
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        self._last_restore_seconds = time.perf_counter() - t0
        return state, step

    def _load_leaves(self, step: int):
        """Yield (leaf path, host leaf) pairs of a committed step — the
        one place that knows the on-disk leaf formats (per-step files
        and content-addressed chunks)."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        for path, meta in self._manifest(step)["leaves"].items():
            if "chunk" in meta:
                fn = os.path.join(self.dir, _CHUNKS, meta["chunk"] + ".npy")
            else:
                fn = os.path.join(d, meta["file"])
            arr = np.load(fn)
            if meta["dtype"] == "bfloat16":
                arr = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            yield path, arr

    def restore(self, template, step: Optional[int] = None,
                device="cuda", target_shardings=None):
        """Load into the structure of ``template`` as tensors on
        ``device`` ("cuda" unless the caller asks for the CPU; raises
        without CUDA).  Returns (state, step), or (None, None) when
        nothing is committed.

        ``target_shardings``: a pytree matching ``template`` with a
        ``torch.device`` (or a device string) at each leaf, which then
        lands there instead, so that a state saved from one placement
        restores onto another (each shard's leaves onto its own device):
        the checkpoint format is placement-agnostic.  A string leaf (a
        sharded index's placement name) stays a host array.
        """
        dev = resolve_device(device) if target_shardings is None else None
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        state = _unflatten(dict(self._load_leaves(step)), template)
        if dev is not None:
            return _map_leaves(lambda leaf: _to_tensor(leaf, dev), state), step
        return _map_pairs(lambda leaf, dev: _to_tensor(
            leaf, resolve_device(dev)), state, target_shardings), step
