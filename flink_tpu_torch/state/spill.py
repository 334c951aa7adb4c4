"""The storage tier of cold-key paging (port of ``flink_tpu/state/spill.py``
``PaneSpillStore``).

:class:`PaneSpillStore` keeps serialized per-(key, pane) pane-ring cells in
the port's C spill store (``csrc/spill_store.cc``): an in-memory index with a
byte budget that evicts, oldest write first, to an append-only log on disk.
Each entry is one cold key's accumulator cell for one pane, under the key
``struct('<qq', gid, pane)``, and its value has the JAX package's fixed
layout::

    u8  flags   (bit0 = emit-mirror bit)
    i64 count   (element count of the cell)
    raw leaf bytes, one fixed-size block per ACC leaf in DEVICE
    dtype/shape (spec.leaf_dtypes / spec.leaf_shapes order)

Device dtypes on purpose: a key that pages out and back in continues its
accumulation history bit for bit.  Besides the single-cell ``put`` / ``get``
/ ``delete``, the ``*_many`` entries take whole arrays of cells in one C
call, so a pager's work per batch is a few calls, not one per cell.  There
is no Python fallback: a store whose library does not build raises.  The
JAX package's ``SpillKeyedStateBackend`` and ``Spill*State`` classes belong
to the runtime-stack slice.
"""

from __future__ import annotations

import ctypes
import shutil
import tempfile
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _release(lib, handle, owned_dir: Optional[str]) -> None:
    lib.ftt_spill_close(handle)
    if owned_dir is not None:
        shutil.rmtree(owned_dir, ignore_errors=True)


class PaneSpillStore:
    """Serialized (gid, pane) cells of the pane ring over the C spill store.

    ``directory`` holds the disk log (a fresh temporary directory when None,
    removed again by :meth:`close`); ``mem_budget`` is the resident value
    bytes before entries move to the log."""

    def __init__(self, directory: Optional[str] = None,
                 mem_budget: int = 64 << 20,
                 leaf_dtypes=(), leaf_shapes=()):
        from flink_tpu_torch.kernels.build import spill_store_lib
        lib = spill_store_lib()
        owned = None
        if directory is None:
            directory = owned = tempfile.mkdtemp(
                prefix="flink_tpu_torch_pages_")
        self.directory = directory
        self._lib = lib
        self._dtypes = [np.dtype(d) for d in leaf_dtypes]
        self._shapes = [tuple(s) for s in leaf_shapes]
        #: bytes of each leaf's block in a value
        self._leaf_bytes = np.asarray(
            [d.itemsize * int(np.prod(s, dtype=np.int64))
             for d, s in zip(self._dtypes, self._shapes)], np.int64)
        self._nl = len(self._dtypes)
        value_len = 9 + int(self._leaf_bytes.sum())   # u8 flags + i64 count
        self._h = lib.ftt_spill_open(directory.encode(), int(mem_budget),
                                     value_len)
        if not self._h:
            if owned is not None:
                shutil.rmtree(owned, ignore_errors=True)
            raise RuntimeError(f"spill store: cannot open a log in "
                               f"{directory}")
        self._close = weakref.finalize(self, _release, lib, self._h, owned)

    @property
    def closed(self) -> bool:
        return not self._close.alive

    def _handle(self):
        if self.closed:
            raise ValueError("spill store is closed")
        return self._h

    # -- array entries ---------------------------------------------------
    def _leaf_ptrs(self, arrays: Sequence[np.ndarray]):
        return (ctypes.c_void_p * max(self._nl, 1))(
            *[a.ctypes.data for a in arrays])

    def put_many(self, gids, panes, flags, counts,
                 leaves: Sequence[np.ndarray]) -> None:
        """Put cells ``i`` in order: key ``(gids[i], panes[i])``, value
        ``flags[i]``, ``counts[i]`` and row ``i`` of each ``[n, *leaf]``
        array of ``leaves`` (cast to the leaf's device dtype)."""
        gids = np.ascontiguousarray(gids, np.int64)
        n = gids.size
        panes = np.ascontiguousarray(np.broadcast_to(panes, (n,)), np.int64)
        flags = np.ascontiguousarray(np.broadcast_to(flags, (n,)), np.uint8)
        counts = np.ascontiguousarray(counts, np.int64).reshape(n)
        cols = [np.ascontiguousarray(np.asarray(v, d).reshape((n,) + s))
                for v, d, s in zip(leaves, self._dtypes, self._shapes)]
        rc = self._lib.ftt_spill_put_cells(
            self._handle(), n, _ptr(gids), _ptr(panes), _ptr(flags),
            _ptr(counts), self._nl, self._leaf_ptrs(cols),
            _ptr(self._leaf_bytes))
        if rc != 0:
            raise OSError(f"spill store: log write failed in "
                          f"{self.directory}")

    def get_many(self, gids, panes, delete: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            List[np.ndarray]]:
        """(found bool[n], flags uint8[n], counts int64[n], one ``[n,
        *leaf]`` array per leaf) of cells ``(gids[i], panes[i])``; cells not
        found read as zeros.  With ``delete`` the cells found are removed."""
        gids = np.ascontiguousarray(gids, np.int64)
        n = gids.size
        panes = np.ascontiguousarray(np.broadcast_to(panes, (n,)), np.int64)
        found = np.zeros(n, np.uint8)
        flags = np.zeros(n, np.uint8)
        counts = np.zeros(n, np.int64)
        cols = [np.zeros((n,) + s, d)
                for d, s in zip(self._dtypes, self._shapes)]
        rc = self._lib.ftt_spill_get_cells(
            self._handle(), n, _ptr(gids), _ptr(panes), int(bool(delete)),
            _ptr(found), _ptr(flags), _ptr(counts), self._nl,
            self._leaf_ptrs(cols), _ptr(self._leaf_bytes))
        if rc < 0:
            raise OSError(f"spill store: log read or CRC check failed in "
                          f"{self.directory}")
        return found.view(bool), flags, counts, cols

    def delete_many(self, gids, panes) -> int:
        """Delete cells ``(gids[i], panes[i])``; returns how many existed."""
        gids = np.ascontiguousarray(gids, np.int64)
        panes = np.ascontiguousarray(np.broadcast_to(panes, (gids.size,)),
                                     np.int64)
        return int(self._lib.ftt_spill_delete_cells(
            self._handle(), gids.size, _ptr(gids), _ptr(panes)))

    # -- single cells ------------------------------------------------------
    def put(self, gid: int, pane: int, flags: int, count: int,
            leaf_values) -> None:
        self.put_many([gid], [pane], [flags], [count],
                      [np.asarray(v, d).reshape((1,) + s)
                       for v, d, s in zip(leaf_values, self._dtypes,
                                          self._shapes)])

    def get(self, gid: int, pane: int):
        """(flags, count, [leaf values]) or None."""
        found, flags, counts, cols = self.get_many([gid], [pane])
        if not found[0]:
            return None
        return int(flags[0]), int(counts[0]), [c[0] for c in cols]

    def delete(self, gid: int, pane: int) -> bool:
        return self.delete_many([gid], [pane]) > 0

    # -- whole store -------------------------------------------------------
    def clear(self) -> None:
        if not self.closed:
            self._lib.ftt_spill_clear(self._h)

    def __len__(self) -> int:
        return int(self._lib.ftt_spill_count(self._handle()))

    def mem_used(self) -> int:
        # occupancy gauges may read stats after the operator closed: byte
        # gauges report 0 rather than touching a closed handle
        return 0 if self.closed else int(self._lib.ftt_spill_mem_used(self._h))

    def log_bytes(self) -> int:
        return 0 if self.closed else int(self._lib.ftt_spill_log_bytes(self._h))

    def close(self) -> None:
        """Release the C store (and the temporary directory it owns)."""
        self._close()
