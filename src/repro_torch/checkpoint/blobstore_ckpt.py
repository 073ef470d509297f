"""Checkpointing through the BlobShuffle storage pattern, the port of
``repro.checkpoint.blobstore_ckpt``.

The paper's commit protocol, reused for fault tolerance: every array leaf
is uploaded as a **blob**; the **manifest** (the "notification") is written
only after all blob uploads are durable. A crash mid-checkpoint leaves
orphaned blobs — harmless and unreachable, collected by retention —
never a corrupt checkpoint. Restore trusts manifests only.

* ``FileStore`` — filesystem-backed object store, the JAX package's code.
* ``BlobCheckpointer`` — save/restore of trees of tensors and numpy
  arrays with optional **async** upload (background thread — overlaps
  training compute).

The store holds the JAX package's layout, so either package restores a
checkpoint the other wrote: the leaves in ``jax.tree.flatten``'s order
(dict keys sorted, lists and tuples in order, ``None`` no leaf), blob ids
``step{step:08d}_leaf{i:05d}.npy``, each blob the leaf's raw
little-endian bytes, the manifest's ``shape`` and ``dtype`` (numpy's
name; ``"bfloat16"`` for bf16, whose bytes cross as a ``uint16`` view, so
no ``ml_dtypes`` is needed) and its keys and ``extra``. The ``treedef``
string is written in JAX's format for dicts, lists, tuples and named
tuples; no restore reads it. The train state of ``models.lm.LM`` and its
AdamW moments takes the JAX package's tree through
``interop.train_state_tree``.

``restore`` writes each leaf into ``like``'s leaf in place (on its device,
in its dtype), so restoring a train state holds no second copy of it on
the card. The elastic restore (``shardings=``, a tree of
``distributed.NamedSharding`` in ``like``'s structure, as
``runtime.elastic_restore_plan`` gives) makes the checks of JAX's
``device_put`` before any write: a spec of at most the leaf's rank,
distinct axes of the sharding's mesh, and each sharded dim divisible by
its axes' product. On a ``StackedMesh`` every rank lives in this process
and the port's model holds global parameters, so each leaf is written
whole. A ``ProcessGroupMesh``, one block a process, is refused: that
restore is not ported (``ROADMAP.md`` queue 1 item 6).

The checkpointer is store-agnostic: ``FileStore`` here for real
filesystems, ``repro_torch.checkpoint.tiered.TieredCheckpointStore`` to
checkpoint through the simulated multi-tier blob stores (``SimulatedS3`` /
``ExpressOneZoneStore`` / ``FaultyStore``).

Manifests can carry an ``extra`` dict (e.g. the training input pipeline's
per-partition consumed offsets) so data-plane progress commits atomically
with the model state it belongs to.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch.mesh import ProcessGroupMesh, StackedMesh

PyTree = Any


class FileStore:
    """Append-only object store on the filesystem (durable blob tier)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "objects"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)

    def put(self, blob_id: str, data: bytes) -> None:
        path = os.path.join(self.root, "objects", blob_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: a blob either exists fully or not

    def get(self, blob_id: str) -> bytes:
        with open(os.path.join(self.root, "objects", blob_id), "rb") as f:
            return f.read()

    def put_manifest(self, name: str, manifest: dict) -> None:
        path = os.path.join(self.root, "manifests", name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_manifest(self, name: str) -> Optional[dict]:
        path = os.path.join(self.root, "manifests", name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def manifests(self) -> List[str]:
        return sorted(os.listdir(os.path.join(self.root, "manifests")))

    def run_retention(self) -> int:
        """GC blobs unreachable from any manifest (orphans from crashes)."""
        live = set()
        for name in self.manifests():
            m = self.get_manifest(name)
            live.update(e["blob"] for e in m["leaves"])
        removed = 0
        objdir = os.path.join(self.root, "objects")
        for blob in os.listdir(objdir):
            if blob not in live and not blob.endswith(".tmp"):
                os.remove(os.path.join(objdir, blob))
                removed += 1
        return removed


# -- the tree: jax.tree.flatten's order and treedef string ------------------

def _flatten(tree) -> Tuple[list, Any]:
    """(leaves, spec) in ``jax.tree.flatten``'s order; ``spec`` rebuilds
    the containers in ``_unflatten`` and prints as JAX's treedef."""
    leaves: list = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("namedtuple", type(node), [walk(v) for v in node])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def _unflatten(spec, leaves: list):
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        if kind == "namedtuple":
            return s[1](*[build(c) for c in s[2]])
        items = [build(c) for c in s[1]]
        return items if kind == "list" else tuple(items)

    return build(spec)


def _treedef_str(spec) -> str:
    def fmt(s):
        kind = s[0]
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(c)}" for k, c in zip(s[1], s[2])) + "}"
        if kind == "namedtuple":
            return (f"CustomNode(namedtuple[{s[1].__name__}], ["
                    + ", ".join(fmt(c) for c in s[2]) + "])")
        inner = ", ".join(fmt(c) for c in s[1])
        return f"[{inner}]" if kind == "list" else f"({inner})"

    return f"PyTreeDef({fmt(spec)})"


# -- leaves: host copies, raw bytes, and back -------------------------------

def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` and its dtype's name. A tensor is copied off
    its device here, synchronously, and copied even on the CPU: the port's
    train step writes the model's tensors in place, so an upload that read
    them later would save the next step's weights. bf16 comes back as its
    ``uint16`` bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)           # as JAX's np.asarray: no copy of numpy
    return arr, str(arr.dtype)


def _encode(arr: np.ndarray) -> bytes:
    """Raw little-endian bytes (dtype/shape live in the manifest)."""
    return arr.tobytes()


def _decode(data: bytes, shape, dtype_str: str) -> torch.Tensor:
    """The blob as a CPU tensor over ``data`` (read, never written)."""
    bf16 = dtype_str == "bfloat16"
    arr = np.frombuffer(data, dtype=np.uint16 if bf16 else np.dtype(dtype_str))
    with warnings.catch_warnings():  # a read-only buffer: only read from
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr.reshape(shape))
    return t.view(torch.bfloat16) if bf16 else t


def _fill(ref, src: torch.Tensor) -> None:
    """Write ``src`` into ``like``'s leaf ``ref`` in place, on its device
    and in its dtype: a tensor, a writable numpy array, or an object with
    ``shape`` and ``copy_`` (``interop.StackedRows``)."""
    if isinstance(ref, np.ndarray):
        if not ref.flags.writeable:
            raise ValueError("restore writes into like's leaves: a numpy leaf "
                             "must be writable")
        torch.from_numpy(ref).copy_(src)
    elif hasattr(ref, "copy_"):
        ref.copy_(src)
    else:
        raise TypeError(f"restore writes into like's leaves in place: "
                        f"{type(ref).__name__} is not a tensor or an array")


def _check_shardings(like_spec, leaves: list, shardings) -> None:
    """Refuse a ``shardings`` tree that ``restore`` cannot place ``like``'s
    leaves by (``ValueError``), as JAX's ``device_put`` would."""
    sh_leaves, sh_spec = _flatten(shardings)
    if sh_spec != like_spec:
        raise ValueError(f"shardings must have like's structure, leaf for leaf: "
                         f"{_treedef_str(sh_spec)} is not {_treedef_str(like_spec)}")
    for i, (ref, sh) in enumerate(zip(leaves, sh_leaves)):
        if not isinstance(sh, NamedSharding):
            raise ValueError(f"leaf {i}: a NamedSharding, not {type(sh).__name__}")
        if isinstance(sh.mesh, ProcessGroupMesh):
            raise ValueError(
                f"leaf {i}: a restore onto a ProcessGroupMesh (one block a process) "
                f"is not ported (ROADMAP.md queue 1 item 6)")
        if not isinstance(sh.mesh, StackedMesh):
            raise ValueError(f"leaf {i}: a NamedSharding over a StackedMesh, not "
                             f"{type(sh.mesh).__name__}")
        shape, sizes = tuple(ref.shape), sh.mesh.shape
        if len(sh.spec) > len(shape):
            raise ValueError(f"leaf {i}: {sh.spec} has more entries than the "
                             f"leaf's rank {len(shape)} ({shape})")
        used: list = []
        for dim, part in zip(shape, sh.spec):
            axes = () if part is None else (part,) if isinstance(part, str) else tuple(part)
            unknown = [a for a in axes if a not in sizes]
            if unknown or any(a in used for a in axes):
                raise ValueError(f"leaf {i}: {sh.spec} names {unknown or axes}, not "
                                 f"distinct axes of the mesh {sizes}")
            used += axes
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"leaf {i} {shape}: dim {dim} does not divide by "
                                 f"{n}, the size of {axes} ({sh.spec})")


class BlobCheckpointer:
    def __init__(self, store, *, async_upload: bool = True):
        self.store = store
        self.async_upload = async_upload
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write path ------------------------------------------------------
    def save(self, step: int, tree: PyTree, *, extra: Optional[dict] = None,
             crash_before_manifest=False):
        """Upload all leaves as blobs, then commit the manifest.

        ``extra`` rides in the manifest (JSON-serializable metadata that
        must commit atomically with the checkpoint — e.g. input-pipeline
        offsets); read it back with :meth:`manifest`.

        ``crash_before_manifest`` (tests): simulate a failure after the
        blob uploads but before the manifest write — the checkpoint must
        NOT become visible.

        Every leaf is on the host when ``save`` returns; only the upload
        runs on in the background.
        """
        self.wait()
        leaves, spec = _flatten(tree)
        host = [_host(leaf) for leaf in leaves]  # device→host copy now

        def work():
            entries = []
            for i in range(len(host)):
                arr, dtype = host[i]
                blob_id = f"step{step:08d}_leaf{i:05d}.npy"
                self.store.put(blob_id, _encode(arr))
                entries.append({"blob": blob_id,
                                "shape": list(arr.shape),
                                "dtype": dtype})
                host[i] = None   # uploaded: its host copy can go
            if crash_before_manifest:
                return  # blobs become orphans; manifest never written
            manifest = {"step": step, "treedef": _treedef_str(spec),
                        "leaves": entries, "time": time.time(),
                        "extra": extra or {}}
            self.store.put_manifest(f"step{step:08d}.json", manifest)

        if self.async_upload:
            def run():
                try:
                    work()
                except BaseException as e:  # surfaced on next wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        """Block until the in-flight checkpoint is durable (commit)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- read path ---------------------------------------------------------
    def manifest(self, step: int) -> Optional[dict]:
        """The committed manifest for ``step`` (None if not committed).
        ``manifest(step)["extra"]`` carries the metadata saved alongside."""
        m = self.store.get_manifest(f"step{step:08d}.json")
        if m is not None:
            m.setdefault("extra", {})  # manifests from older writers
        return m

    def restore(self, step: int, like: PyTree, *, shardings: PyTree = None
                ) -> PyTree:
        """Restore into ``like``'s leaves, in place, and return them in
        ``like``'s structure; ``shardings`` places them on another mesh
        (see the module docstring). JAX's refusals stand: no committed
        manifest (``FileNotFoundError``), another leaf count or shape
        (``AssertionError``, raised also under ``python -O``); a
        ``shardings`` tree that cannot place ``like`` raises
        ``ValueError``."""
        m = self.store.get_manifest(f"step{step:08d}.json")
        if m is None:
            raise FileNotFoundError(f"no committed checkpoint for {step}")
        leaves, spec = _flatten(like)
        # every refusal before the first write: like's leaves stay whole
        if len(leaves) != len(m["leaves"]):
            raise AssertionError("tree structure changed")
        for ref, entry in zip(leaves, m["leaves"]):
            if list(ref.shape) != entry["shape"]:
                raise AssertionError(
                    f"shape mismatch {tuple(ref.shape)} vs {entry['shape']}")
        if shardings is not None:
            _check_shardings(spec, leaves, shardings)
        with torch.no_grad():   # like's leaves may be parameters
            for ref, entry in zip(leaves, m["leaves"]):
                _fill(ref, _decode(self.store.get(entry["blob"]),
                                   entry["shape"], entry["dtype"]))
        return _unflatten(spec, leaves)


def latest_step(store) -> Optional[int]:
    names = store.manifests()
    if not names:
        return None
    return max(int(n[4:12]) for n in names)
