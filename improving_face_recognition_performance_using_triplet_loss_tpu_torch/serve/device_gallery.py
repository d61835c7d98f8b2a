"""Device-resident identity gallery with O(row) enrollment.

Port of the JAX package's ``serve/device_gallery.py``. The dynamic
pipelines (serve/pipeline.py) take the normalized gallery matrix at call
time; re-normalizing and re-uploading the whole matrix per enrollment
would cost O(G) through the host link. :class:`DeviceGallery` keeps the
padded ``[capacity, D]`` matrix on the device and enrolls by writing one
row in place: one ``[D]`` row crosses the link.

Rows are L2-normalized on the host in float32 and narrowed to the storage
dtype there (``l2_normalize_np``, ``narrow_gallery_np``), so every stored
row equals the host normalization exactly. Capacity grows by doubling (one
device-side copy into a fresh buffer); the enrolled row count feeds the
pipelines' ``rows`` argument so unused capacity is masked out of every
match.

The JAX twin donates its buffer to each jitted scatter, which invalidates
any ``gallery_n`` taken before a mutation. Here a mutation writes into the
same buffer in place: an earlier ``gallery_n`` stays valid and sees the
update, and only a doubling allocates a new buffer.

With ``mesh=`` the rows are sharded over ``gallery_axis``: capacity
rounds up to a multiple of the axis size, each rank holds its block
(``gallery_n`` is that block, what the gallery-sharded pipeline takes),
and every rank calls each mutation with the same arguments, as the
single-controller JAX program does; ``add`` / ``set_row`` /
``clear_row`` write only on the rank that owns the row, and a doubling
gathers the blocks and re-shards them at the new capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distances import l2_normalize_np, narrow_gallery_np
from ..parallel.collectives import gather_rows
from ..parallel.mesh import axis_group, axis_index, axis_size


class DeviceGallery:
    """L2-normalized gallery rows resident on the device (``cuda`` unless
    ``device`` says otherwise).

    ``gallery_n`` and ``rows_arg`` plug straight into the dynamic
    pipelines::

        dg = DeviceGallery(dim=342, capacity=1024)
        idx = dg.add(embedding)                    # O(row), no re-upload
        out = pipeline(frame, dg.gallery_n, dg.rows_arg)

    ``dtype=torch.bfloat16`` halves and ``torch.int8`` (127 scale, see
    ``ops.distances.gallery_sims``) quarters the matrix's bytes and the
    match's traffic; rows are still normalized in f32 before narrowing.
    """

    def __init__(self, dim: int, capacity: int = 1024,
                 initial: np.ndarray | None = None,
                 mesh=None, gallery_axis: str = "model",
                 dtype=torch.float32, device=None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.dim = int(dim)
        self.rows = 0
        self.dtype = dtype
        self.device = resolve_device(device)
        self._parts, self._part, self._group = 1, 0, None
        if mesh is not None:
            self._parts = axis_size(mesh, gallery_axis)
            self._part = axis_index(mesh, gallery_axis)
            self._group = axis_group(mesh, gallery_axis)
            capacity += (-capacity) % self._parts
        if initial is not None:
            initial = np.asarray(initial, np.float32)
            if initial.ndim != 2 or initial.shape[1] != dim:
                raise ValueError(
                    f"initial gallery must be [G, {dim}], got "
                    f"{initial.shape}")
            while capacity < initial.shape[0]:
                capacity *= 2
        self._capacity = capacity
        self._gal = torch.zeros((capacity // self._parts, self.dim),
                                dtype=self.dtype, device=self.device)
        if initial is not None:
            lo = min(self._row0, initial.shape[0])
            hi = min(self._row0 + self._gal.shape[0], initial.shape[0])
            if hi > lo:
                self._gal[:hi - lo] = self._narrow(initial[lo:hi])
            self.rows = initial.shape[0]
        # one persistent 0-d tensor on the device, written in place on every
        # change of ``rows``: a captured dispatch can read it
        self._rows_t = torch.tensor(self.rows, dtype=torch.int32,
                                    device=self.device)

    def _narrow(self, rows: np.ndarray) -> torch.Tensor:
        """Normalize ``[N, D]`` host rows in f32 and narrow them on the
        host, then copy them to the device (narrow bytes on the link)."""
        host = narrow_gallery_np(l2_normalize_np(rows), self.dtype)
        return host.to(self.device)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def _row0(self) -> int:
        """The first row of this rank's block."""
        return self._part * (self._capacity // self._parts)

    def _local(self, row: int) -> int | None:
        """``row``'s index in this rank's block, None when another rank
        owns it."""
        i = row - self._row0
        return i if 0 <= i < self._gal.shape[0] else None

    def _whole(self) -> torch.Tensor:
        """Every rank's block, gathered ``[capacity, D]`` (as raw bytes,
        whatever the storage dtype)."""
        if self._group is None:
            return self._gal
        raw = gather_rows(self._gal.view(torch.uint8), self._group)
        return raw.view(self.dtype)

    @classmethod
    def from_rows(cls, rows: np.ndarray, capacity: int = 1024,
                  keep: np.ndarray | None = None,
                  mesh=None, gallery_axis: str = "model",
                  dtype=torch.float32, device=None) -> "DeviceGallery":
        """Build a gallery from a [G, D] host matrix — the compaction path
        when :meth:`clear_row` tombstones accumulate::

            keep = np.ones(dg.rows, bool); keep[deleted_rows] = False
            dg = DeviceGallery.from_rows(dg.to_host(), keep=keep)

        Row indices change under compaction: remap any externally held row
        ids via ``np.cumsum(keep) - 1``."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"rows must be [G, D], got {rows.shape}")
        if keep is not None:
            rows = rows[np.asarray(keep, bool)]
        return cls(dim=rows.shape[1], capacity=capacity, initial=rows,
                   mesh=mesh, gallery_axis=gallery_axis, dtype=dtype,
                   device=device)

    @property
    def gallery_n(self) -> torch.Tensor:
        """The ``[capacity, D]`` normalized device matrix (padding rows are
        zero and masked by ``rows`` in the pipelines), or with a mesh this
        rank's ``[capacity / k, D]`` block of it. The live buffer:
        mutations write into it, a doubling replaces it."""
        return self._gal

    @property
    def rows_arg(self) -> torch.Tensor:
        """The enrolled-row count as the pipelines' ``rows`` argument: a
        0-d int32 tensor on the device."""
        return self._rows_t

    def _check_vec(self, vec) -> np.ndarray:
        vec = np.asarray(vec, np.float32)
        if vec.shape != (self.dim,):
            raise ValueError(f"expected [{self.dim}] embedding, got "
                             f"{vec.shape}")
        return vec

    def add(self, vec: np.ndarray) -> int:
        """Enroll one embedding; returns its row. Doubles capacity when
        full — the only operation that changes the gallery's shape."""
        vec = self._check_vec(vec)
        if self.rows == self.capacity:
            self._grow()
        row = self.rows
        self._write(row, self._narrow(vec[None])[0])
        self.rows += 1
        self._rows_t.fill_(self.rows)
        return row

    def _grow(self) -> None:
        """Double the capacity; with a mesh, re-shard at the new one."""
        whole = self._whole()
        self._capacity *= 2
        block = self._capacity // self._parts
        grown = torch.zeros((block, self.dim), dtype=self.dtype,
                            device=self.device)
        part = whole[self._row0:self._row0 + block]
        grown[:part.shape[0]] = part
        self._gal = grown

    def _write(self, row: int, value) -> None:
        i = self._local(row)
        if i is not None:
            self._gal[i] = value

    def set_row(self, row: int, vec: np.ndarray) -> None:
        """Overwrite an enrolled row (re-enrollment / identity update)."""
        if not 0 <= row < self.rows:
            raise IndexError(f"row {row} not enrolled (rows={self.rows})")
        self._write(row, self._narrow(self._check_vec(vec)[None])[0])

    def clear_row(self, row: int) -> None:
        """Zero an enrolled row (deletion tombstone: a zero row inside
        ``rows`` cosines to 0 and loses to any real match above a
        positive threshold; compact with :meth:`from_rows` when tombstones
        accumulate)."""
        if not 0 <= row < self.rows:
            raise IndexError(f"row {row} not enrolled (rows={self.rows})")
        self._write(row, 0)

    def to_host(self) -> np.ndarray:
        """The enrolled (normalized) rows as a host f32 array, widened
        from the storage dtype (int8 rows rescale back from the 127-scale
        convention)."""
        rows = self._whole()[:self.rows].float().cpu().numpy()
        if self.dtype == torch.int8:
            rows = rows * (1.0 / 127.0)
        return rows
