"""Durable person DB + device gallery, kept row-for-row in sync.

Port of the JAX package's ``serve/gallery_service.py``.
:class:`~.person_store.PersonStore` is the durable system of record
(SQLite person/face schema), :class:`~.device_gallery.DeviceGallery` is
the device-resident match matrix the dynamic pipelines take at call time,
and this module keeps them consistent:

- **cold start**: every ``valid_face`` row becomes one device gallery row
  (single upload), with ``row -> (pid, fid)`` maps so a pipeline's match
  index resolves back to a Person;
- **enroll**: write-through — DB insert first (durability), then one
  O(row) in-place write on the device; no gallery re-upload;
- **retire**: person_flag=0 in the DB (the reference's soft delete) +
  tombstone rows on the device; :meth:`refresh` compacts tombstones and
  picks up out-of-band DB writes.

Match semantics stay exactly :meth:`PersonStore.match`'s cosine over valid
faces; the pipelines run it on the device against
``(service.gallery_n, service.rows_arg)``.

With ``mesh=`` the device rows are sharded over ``gallery_axis``
(``DeviceGallery(mesh=...)``, the gallery-sharded pipeline's layout) and
every rank runs the service with the same calls, as the JAX package's one
controller does: rank 0 writes the store and broadcasts the ids it got,
the other ranks read it; ``match_batch`` reduces each rank's block
winners over the gallery axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import broadcast_object, global_argmax
from ..parallel.distributed import process_info
from ..parallel.mesh import axis_group, axis_index
from .device_gallery import DeviceGallery
from .person_store import MatchResult, Person, PersonStore


class PersonGalleryService:
    """Row-synchronized (PersonStore, DeviceGallery) pair for the dynamic
    pipelines::

        svc = PersonGalleryService(store, capacity=1 << 20)
        out = pipeline(frame, svc.gallery_n, svc.rows_arg)
        res = svc.resolve(int(out["index"]), float(out["similarity"]))
        if res.person: print(res.person.name)

    The device rows live on ``device`` (``cuda`` unless given); ``mesh=``
    shards them over ``gallery_axis`` (module docstring).

    Consistency contract: mutations made THROUGH the service (``enroll``,
    ``add_face``, ``retire_person``) keep DB and device rows in sync; direct
    writes to the underlying store (or ``promote_registration``) need a
    :meth:`refresh` to land on device.
    """

    def __init__(self, store: PersonStore, capacity: int = 1024,
                 mesh=None, gallery_axis: str = "model",
                 dtype=None, device=None):
        self.store = store
        self._mesh = mesh
        self._gallery_axis = gallery_axis
        self._capacity_hint = capacity
        self._dtype = torch.float32 if dtype is None else dtype
        self._device = device
        self._stale = False  # set when a failed row write couldn't be
        #                      repaired in place; cleared by _ensure_fresh
        self._load()

    def _write(self, fn):
        """``fn()`` on rank 0 (the store's one writer), its result on every
        rank; the other ranks drop what their store cached, which that
        write made stale."""
        if self._mesh is None:
            return fn()
        writer = process_info()[0] == 0
        out = broadcast_object(fn() if writer else None)
        if not writer:
            self.store._invalidate()
        return out

    def _ensure_fresh(self) -> None:
        if self._stale:
            self._load()
            self._stale = False

    def _load(self) -> None:
        feats, fids, pids = self.store.valid_faces()
        self._dg = DeviceGallery(
            dim=self.store.feature_dim, capacity=self._capacity_hint,
            initial=feats if feats.shape[0] else None,
            mesh=self._mesh, gallery_axis=self._gallery_axis,
            dtype=self._dtype, device=self._device)
        self._fids = list(map(int, fids))
        self._pids = list(map(int, pids))

    # ------------------------------------------------- pipeline plumbing

    @property
    def gallery_n(self):
        """Live device matrix for the pipelines' gallery argument —
        re-read after a mutation (a doubling or a refresh replaces it)."""
        self._ensure_fresh()
        return self._dg.gallery_n

    @property
    def rows_arg(self):
        self._ensure_fresh()
        return self._dg.rows_arg

    @property
    def rows(self) -> int:
        self._ensure_fresh()
        return self._dg.rows

    # ------------------------------------------------------- mutations

    def enroll(self, person: Person, features=()) -> int:
        """Register a person with their face features: one durable
        ``register_person`` + one O(row) device row write per feature.
        Returns the pid."""
        feats = [np.asarray(f, np.float32) for f in features]
        pid = self._write(lambda: self.store.register_person(person))
        for fv in feats:
            self.add_face(pid, fv)
        return pid

    def add_face(self, pid: int, feature: np.ndarray) -> int:
        """Attach one more face to an existing person (DB insert + device
        row write). Returns the fid."""
        if self.store.get_person(pid) is None:
            raise KeyError(f"no person pid={pid}")
        self._ensure_fresh()
        feature = np.asarray(feature, np.float32)
        fid = self._write(lambda: self.store.insert_face(pid, feature))
        try:
            self._dg.add(feature)
        except Exception:
            # the DB row is already durable; a failed device write
            # (e.g. out of device memory while doubling) must not leave the
            # device matrix misaligned with _fids/_pids — try to rebuild
            # from the store. Under the OOM scenario the rebuild itself
            # can fail too (it allocates the same capacity), so on a
            # second failure mark the service stale instead: every
            # subsequent access goes through _ensure_fresh() and retries
            # the rebuild before serving anything misaligned. Either
            # way the ORIGINAL error propagates.
            try:
                self.refresh()
            except Exception:
                self._stale = True
            raise
        self._fids.append(fid)
        self._pids.append(pid)
        return fid

    def retire_person(self, pid: int) -> int:
        """Soft-delete: person_flag=0 in the DB, tombstone the person's
        device rows (zero rows lose every thresholded match). Returns the
        number of rows tombstoned; :meth:`refresh` compacts them."""
        self._ensure_fresh()
        self._write(lambda: self.store.set_person_flag(pid, 0))
        n = 0
        for row, row_pid in enumerate(self._pids):
            if row_pid == pid:
                self._dg.clear_row(row)
                self._pids[row] = -1  # resolved as no-match even at th<=0
                n += 1
        return n

    def refresh(self) -> None:
        """Rebuild the device gallery from the store: compacts retire
        tombstones and picks up faces written to the DB out of band
        (e.g. ``promote_registration``). One full upload — the cold-start
        cost, not the per-enroll cost."""
        self._load()
        self._stale = False

    # ------------------------------------------------------- resolution

    def resolve(self, index: int, similarity: float,
                sim_th: float = 0.5) -> MatchResult:
        """Map a pipeline match index back to the Person — the host half
        of Compare_Face_DB's threshold + owner lookup. ``index`` may be -1
        (pipeline already thresholded) or any row (tombstones resolve to
        no-match)."""
        if index < 0 or index >= len(self._pids) or similarity < sim_th:
            return MatchResult(None, float(similarity))
        pid = self._pids[index]
        if pid < 0:  # tombstoned row
            return MatchResult(None, float(similarity))
        return MatchResult(self.store.get_person(pid), float(similarity),
                           fid=self._fids[index])

    def resolve_batch(self, indices, similarities,
                      sim_th: float = 0.5) -> list[MatchResult]:
        return [self.resolve(int(i), float(s), sim_th)
                for i, s in zip(np.ravel(indices), np.ravel(similarities))]

    def match_batch(self, probes: np.ndarray,
                    sim_th: float = 0.5) -> list[MatchResult]:
        """Identify N probe features in ONE device product against the
        device-resident gallery — the standalone counterpart of the
        pipelines' fused match (same `_match_gallery` masking), returning
        resolved MatchResults with PersonStore.match's empty-store/
        threshold semantics."""
        from ..ops.distances import l2_normalize_np
        from .pipeline import _match_gallery, gallery_sims

        probes = np.atleast_2d(np.asarray(probes, np.float32))
        gal = self.gallery_n
        with torch.inference_mode():
            probes_n = torch.from_numpy(l2_normalize_np(probes)).to(
                gal.device)
            sims = gallery_sims(probes_n, gal)
            if self._mesh is None:
                idx, sim, real = _match_gallery(sims, self.rows_arg)
            else:
                idx, sim, real = self._match_sharded(sims)
            idx, sim, real = (t.cpu().numpy() for t in (idx, sim, real))
        return [self.resolve(int(i), float(s), sim_th) if bool(r)
                else MatchResult(None, 0.0)  # empty gallery: host parity
                for i, s, r in zip(idx, sim, real)]

    def _match_sharded(self, sims: torch.Tensor):
        """``_match_gallery`` over this rank's block ``[N, block]`` of the
        sharded gallery, reduced over the gallery axis."""
        from .pipeline import _match_gallery

        row0 = axis_index(self._mesh, self._gallery_axis) * sims.shape[-1]
        idx, sim, _ = _match_gallery(sims, self.rows - row0)
        idx, sim = global_argmax(
            idx, sim, row0, axis_group(self._mesh, self._gallery_axis))
        return idx, sim, sim > float("-inf")
