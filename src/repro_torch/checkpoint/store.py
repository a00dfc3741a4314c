"""Checkpoint store with FaaSKeeper-coordinated commits (the JAX package's
``checkpoint/store.py``, for nested dicts of tensors: the model's state
dict and the optimiser's moments).

Layout (the paper's split between bulk user data and control data)::

    <root>/step_<n>/<leaf-path>.npy     one array per leaf   ("object store")
    <root>/step_<n>/manifest.json       leaves, shapes, dtypes, sha256
    manifest committed through coord.ckpt_coord as a FaaSKeeper transaction
    ("system store"): the manifest commit is the commit point.

A checkpoint is visible iff its manifest committed; a crash mid-save leaves
a dangling step directory that the next save's garbage pass prunes.
``save_async`` copies device to host synchronously, then hands the write
and the commit to the store's one save thread, which drains a FIFO queue:
manifests commit in call order.  ``restore`` checks every leaf's bytes against the digest taken
at save time, and that the tensor placed on the template's device holds
the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"


def leaf_paths(tree: Mapping, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of a nested dict, keys joined by
    ``/`` in insertion order."""
    out = []
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.extend(leaf_paths(val, path + "/"))
        else:
            out.append((path, val))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a)
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def save_tree(host_tree: Mapping, directory: str) -> Dict[str, Any]:
    """Write every leaf (numpy, already on the host) as ``<path>.npy`` and
    the manifest beside them; returns the manifest."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"leaves": []}
    for path, arr in leaf_paths(host_tree):
        fn = path.replace("/", "__") + ".npy"
        np.save(os.path.join(directory, fn), arr)
        manifest["leaves"].append({"path": path, "file": fn, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype), "sha256": _digest(arr)})
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(manifest, f)
    return manifest


def restore_tree(template: Mapping, directory: str) -> Dict:
    """The tree saved in ``directory``, shaped like ``template`` (nested
    dicts of tensors), each leaf on its template leaf's device and dtype.
    Raises if a leaf's bytes differ from the digest taken at save time or
    do not survive the copy to the device."""
    with open(os.path.join(directory, MANIFEST)) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def build(tree: Mapping, prefix: str) -> Dict:
        out = {}
        for key, like in tree.items():
            path = f"{prefix}{key}"
            if isinstance(like, Mapping):
                out[key] = build(like, path + "/")
                continue
            entry = by_path[path]
            arr = np.load(os.path.join(directory, entry["file"]))
            if _digest(arr) != entry["sha256"]:
                raise IOError(f"checkpoint leaf {path}: bytes differ from the saved digest")
            t = _from_numpy(arr, like)
            if _digest(_to_numpy(t)) != entry["sha256"]:
                raise IOError(f"checkpoint leaf {path}: the copy on {t.device} differs")
            out[key] = t
        return out

    return build(template, "")


def host_copy(tree: Mapping) -> Dict:
    """The tree with every tensor copied to host numpy (the device-to-host
    copy of a save)."""
    return {k: host_copy(v) if isinstance(v, Mapping) else _to_numpy(v)
            for k, v in tree.items()}


class CheckpointStore:
    """Filesystem bulk store with a pluggable manifest committer.

    ``committer(step, manifest)`` runs after the bulk write; the default
    records to a local JSON log, and ``coord.ckpt_coord`` swaps in the
    FaaSKeeper transactional commit (with ``latest_resolver``).
    """

    def __init__(self, root: str, committer: Optional[Callable] = None,
                 latest_resolver: Optional[Callable] = None, keep: int = 3):
        self.root = root
        self.keep = keep
        self._committer = committer or self._local_commit
        self._latest_resolver = latest_resolver or self._local_latest
        # async saves run one at a time on one thread, in call order: the
        # committer talks to the (single-threaded) control plane, and
        # manifests must commit in order (a lock per save thread would not
        # grant in call order)
        self._queue: "queue.Queue[Tuple[int, Mapping]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    # -- local (non-coordinated) manifest fallback ------------------------------

    def _log_path(self) -> str:
        return os.path.join(self.root, "manifest_log.json")

    def _local_commit(self, step: int, manifest: Dict) -> None:
        log = []
        if os.path.exists(self._log_path()):
            with open(self._log_path()) as f:
                log = json.load(f)
        log.append({"step": step, "manifest": manifest})
        tmp = self._log_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(log, f)
        os.replace(tmp, self._log_path())

    def _local_latest(self) -> Optional[int]:
        if not os.path.exists(self._log_path()):
            return None
        with open(self._log_path()) as f:
            log = json.load(f)
        return log[-1]["step"] if log else None

    # -- public API ---------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save(self, step: int, tree: Mapping) -> None:
        """Save and commit ``tree`` as ``step``, after every earlier save."""
        self.save_async(step, tree)
        self.wait()

    def save_async(self, step: int, tree: Mapping) -> None:
        """Copy ``tree`` to the host now; write and commit it on the save
        thread after every earlier save (``wait`` joins)."""
        host_tree = host_copy(tree)     # synchronous device -> host; disk I/O async
        if self._worker is None:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._queue.put((step, host_tree))

    def _drain(self) -> None:
        while True:
            step, host_tree = self._queue.get()
            try:
                self._save_host(step, host_tree)
            except Exception as e:          # the first is re-raised by wait()
                self._error = self._error or e
            finally:
                self._queue.task_done()

    def _save_host(self, step: int, host_tree: Mapping) -> None:
        self._gc_dangling()
        manifest = save_tree(host_tree, self.step_dir(step))
        manifest["step"] = step
        self._committer(step, manifest)
        self._gc_old()

    def wait(self) -> None:
        """Block until every ``save_async`` so far has committed; raise the
        first failed save's error."""
        self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        return self._latest_resolver()

    def restore(self, template: Mapping, step: Optional[int] = None) -> Tuple[Dict, int]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
        return restore_tree(template, self.step_dir(step)), step

    # -- garbage collection ----------------------------------------------------------

    def _committed_steps(self) -> List[int]:
        latest = self._latest_resolver()
        if latest is None:
            return []
        steps = []
        if os.path.exists(self._log_path()):
            with open(self._log_path()) as f:
                steps = [e["step"] for e in json.load(f)]
        return steps or [latest]

    def _gc_dangling(self) -> None:
        committed = set(self._committed_steps())
        for d in os.listdir(self.root):
            if d.startswith("step_"):
                s = int(d.split("_")[1])
                if s not in committed and committed and s < max(committed):
                    shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    def _gc_old(self) -> None:
        committed = sorted(self._committed_steps())
        for s in committed[: -self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
