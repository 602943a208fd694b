"""Per-merge-step checkpointing for fastMNN-family runs.

Counterpart of ``batchelor_tpu/io/checkpoint.py``, with its on-disk format:
the PCA stage (rotation, centers, per-batch PCs) and every merge step's
state (merged coordinates, batch vectors, pair lists, diagnostics) are
serialized under the same file names and keys, with the same atomic
``os.replace`` writes, so a run restarts from its last completed merge, and
a checkpoint written by either package resumes in the other. The reference
has no checkpointing; its moral equivalent is stage decomposition
(multiBatchPCA output feeding reducedMNN, R/reducedMNN.R:24-27).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.trees import MergeNode

__all__ = ["MergeCheckpointer", "save_pca_stage", "load_pca_stage"]

_VERSION = 1

# Bytes a slice when a node's coordinates stream between the device and the
# disk: a late-step node is GBs (10M cells x 50 dims x fp32 = 2 GB), and
# slices bound the host memory a save or a load holds.
_STREAM_BYTES = 128 << 20


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a tensor is copied from its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pca_stage(path: str, components, rotation, centers, batch_names=None) -> None:
    """Serialize the multiBatchPCA stage (the 'most time-consuming step')."""
    os.makedirs(path, exist_ok=True)
    arrays = {"rotation": _host(rotation), "centers": _host(centers)}
    for i, c in enumerate(components):
        arrays[f"component_{i}"] = _host(c)
    np.savez(os.path.join(path, "pca_stage.npz"), **arrays)
    meta = {"version": _VERSION, "n_batches": len(components), "batch_names": batch_names}
    with open(os.path.join(path, "pca_meta.json"), "w") as fh:
        json.dump(meta, fh)


def load_pca_stage(path: str):
    """Returns (components, rotation, centers, batch_names) as host arrays,
    or None when ``path`` holds no PCA stage."""
    f = os.path.join(path, "pca_stage.npz")
    if not os.path.exists(f):
        return None
    with open(os.path.join(path, "pca_meta.json")) as fh:
        meta = json.load(fh)
    z = np.load(f)
    comps = [z[f"component_{i}"] for i in range(meta["n_batches"])]
    return comps, z["rotation"], z["centers"], meta.get("batch_names")


class MergeCheckpointer:
    """Append-only per-merge-step checkpoint store.

    Each completed step saves the merged node (coordinates, origin,
    restrict, extras = replayed batch vectors) plus its diagnostics; resume
    replays stored steps through the tree machinery without recomputation.
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._meta_path = os.path.join(directory, "merge_meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as fh:
                self._meta = json.load(fh)
            if self._meta.get("version") != _VERSION:
                raise ValueError("incompatible checkpoint version")
        else:
            self._meta = {"version": _VERSION, "completed": 0}

    @property
    def completed_steps(self) -> int:
        return int(self._meta["completed"])

    def _step_file(self, mdx: int) -> str:
        return os.path.join(self.dir, f"step_{mdx:04d}.npz")

    def _data_file(self, mdx: int) -> str:
        return os.path.join(self.dir, f"step_{mdx:04d}_data.npy")

    def _stream_data(self, mdx: int, data) -> None:
        """Write an (n, d) tensor or array to step_XXXX_data.npy in
        ``_STREAM_BYTES`` slices, each copied from the device on its own."""
        n, d = data.shape
        dtype = _host(data[:1]).dtype
        tmp = self._data_file(mdx) + ".tmp.npy"
        mm = np.lib.format.open_memmap(tmp, mode="w+", dtype=dtype, shape=(n, d))
        rows = max(1, _STREAM_BYTES // max(1, dtype.itemsize * d))
        for a in range(0, n, rows):
            mm[a:min(n, a + rows)] = _host(data[a:min(n, a + rows)])
        mm.flush()
        del mm
        os.replace(tmp, self._data_file(mdx))

    def _load_data(self, mdx: int, device: torch.device) -> torch.Tensor:
        """step_XXXX_data.npy as a tensor on ``device``, in ``_STREAM_BYTES``
        slices."""
        mm = np.load(self._data_file(mdx), mmap_mode="r")
        n, d = mm.shape
        out = torch.empty((n, d), device=device,
                          dtype=torch.from_numpy(np.empty(0, mm.dtype)).dtype)
        rows = max(1, _STREAM_BYTES // max(1, mm.dtype.itemsize * d))
        for a in range(0, n, rows):
            out[a:a + rows] = torch.from_numpy(np.array(mm[a:a + rows]))
        return out

    def save_step(self, mdx, tree_path, chosen, node: MergeNode, diag: dict) -> None:
        self._stream_data(mdx, node.data)
        arrays = {
            "origin": np.asarray(node.origin),
            "index": np.asarray(node.index, dtype=np.int64),
            "tree_path": np.asarray(tree_path if tree_path is not None else [], dtype=np.int64),
            "chosen": np.asarray(chosen if chosen is not None else [], dtype=np.int64),
            "pairs": np.asarray(diag["pairs"], dtype=np.int64),
            "lost_var": np.asarray(diag["lost_var"], dtype=np.float64),
            "left_set": np.asarray(diag["left_set"], dtype=np.int64),
            "right_set": np.asarray(diag["right_set"], dtype=np.int64),
            "scalars": np.asarray(
                [diag["batch_size"], 1.0 if diag["skipped"] else 0.0], dtype=np.float64
            ),
            "n_extras": np.asarray([len(node.extras)], dtype=np.int64),
        }
        if diag.get("stats") is not None:
            arrays["stats"] = np.asarray(diag["stats"], dtype=np.int64)
        if node.restrict is not None:
            arrays["restrict"] = np.asarray(node.restrict, dtype=np.int64)
        for i, e in enumerate(node.extras):
            arrays[f"extra_{i}"] = _host(e)
        tmp = self._step_file(mdx) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._step_file(mdx))
        self._meta["completed"] = max(self.completed_steps, mdx + 1)
        with open(self._meta_path + ".tmp", "w") as fh:
            json.dump(self._meta, fh)
        os.replace(self._meta_path + ".tmp", self._meta_path)

    def load_step(self, mdx: int, device: DeviceLike = None):
        """(tree_path, chosen, MergeNode, diag dict); the node's coordinates
        and extras are tensors on ``device`` (default: the CUDA device)."""
        dev = resolve_device(device)
        z = np.load(self._step_file(mdx))
        n_extras = int(z["n_extras"][0])
        if "data" in z.files:        # layout from before the coordinates streamed
            data = torch.as_tensor(z["data"], device=dev)
        else:
            data = self._load_data(mdx, dev)
        node = MergeNode(
            index=z["index"].tolist(),
            data=data,
            restrict=z["restrict"] if "restrict" in z.files else None,
            origin=z["origin"],
            extras=[torch.as_tensor(z[f"extra_{i}"], device=dev) for i in range(n_extras)],
        )
        diag = {
            "pairs": z["pairs"],
            "lost_var": z["lost_var"],
            "left_set": z["left_set"].tolist(),
            "right_set": z["right_set"].tolist(),
            "batch_size": float(z["scalars"][0]),
            "skipped": bool(z["scalars"][1]),
            "stats": z["stats"] if "stats" in z.files else None,
        }
        tree_path = z["tree_path"].tolist()
        chosen = z["chosen"].tolist() if z["chosen"].size else None
        return tree_path, chosen, node, diag

    def clear(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)
        self._meta = {"version": _VERSION, "completed": 0}
