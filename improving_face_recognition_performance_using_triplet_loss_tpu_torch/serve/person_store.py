"""Person-level identity database (reference C20: the PostgreSQL side).

The port's own copy of the JAX package's ``serve/person_store.py`` (sqlite
and numpy): the same schema and the same FJPD and ``reg_face`` formats
byte for byte, so the JAX ``PersonStore`` and the native serving binary
read what this one writes. ``match_batch(use_tpu=True)`` runs its product
on the store's ``device`` (``cuda`` unless given; the keyword keeps the
JAX package's name).

The reference's serving runtime models PERSONS with N face-feature rows
each, card-id registration flows, and profile/face crops stored under a
data root (Feature.hpp:679-932: ``Select_Registed_Data``, ``Register_PDB``,
``Register_PDB_onlyCard``, ``isExistIDNumber``, ``Compare_Face_DB``; the
``Valid_person``/``Valid_Face`` views). Rebuilt here on stdlib ``sqlite3``
(no PG server in this image; the schema and semantics carry over 1:1):

- ``person(pid, name, role_title, email, student_id, card_id, person_flag,
  profile_img)`` — ``person_flag != 0`` marks valid rows (the Valid_person
  view);
- ``face(fid, pid, simd_dot, img_path, feature BLOB)`` — float32 features
  with the precomputed L2 norm (``sqrt_simdot``), like the reference's
  SIMD_DOT cache;
- ``wanna_regist(rid, card_id)`` + ``regist_face(rid, fid)`` — the
  card-only pre-registration queue (Register_PDB_onlyCard), with faces
  parked under a reserved temp person;
- crops land under ``data_root/not_verify/<student_id>/`` (profile.png +
  <fid>.png) and ``data_root/regist_list/<rid>/`` exactly like the
  reference's directory contract.

Matching (`match`) is Compare_Face_DB semantics — max cosine over every
valid face row, threshold-gated — vectorized over a cached feature matrix
instead of the reference's per-row ``omp critical`` max.

`export_reg_face`/`import_reg_face` interop with the flat SQLite
``reg_face`` schema of the C version (Feature.hpp:433-441,453-480) including
its >0.99999 enroll dedup.
"""

from __future__ import annotations

import os
import sqlite3
from dataclasses import dataclass

import numpy as np

TMP_PID = 0  # reserved person for card-only pre-registrations ("TMP" rows)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS person (
    pid INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL DEFAULT '',
    role_title TEXT NOT NULL DEFAULT '',
    email TEXT NOT NULL DEFAULT '',
    student_id TEXT NOT NULL DEFAULT '',
    card_id TEXT NOT NULL DEFAULT '',
    person_flag INTEGER NOT NULL DEFAULT 1,
    profile_img TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS face (
    fid INTEGER PRIMARY KEY AUTOINCREMENT,
    pid INTEGER NOT NULL REFERENCES person(pid),
    simd_dot REAL NOT NULL,
    img_path TEXT NOT NULL DEFAULT '',
    feature BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS wanna_regist (
    rid INTEGER PRIMARY KEY AUTOINCREMENT,
    card_id TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS regist_face (
    rid INTEGER NOT NULL REFERENCES wanna_regist(rid),
    fid INTEGER NOT NULL REFERENCES face(fid)
);
CREATE INDEX IF NOT EXISTS idx_face_pid ON face(pid);
CREATE VIEW IF NOT EXISTS valid_person AS
    SELECT * FROM person WHERE person_flag != 0 AND pid != 0;
CREATE VIEW IF NOT EXISTS valid_face AS
    SELECT f.* FROM face f JOIN person p ON f.pid = p.pid
    WHERE p.person_flag != 0 AND p.pid != 0;
"""


@dataclass
class Person:
    """The reference's Person struct (Feature.hpp Select_Registed_Data)."""

    pid: int = -1
    name: str = ""
    role_title: str = ""
    email: str = ""
    student_id: str = ""
    card_id: str = ""
    person_flag: int = 1
    profile_img: str = ""


@dataclass
class MatchResult:
    person: Person | None
    similarity: float
    fid: int = -1


class PersonStore:
    """SQLite person/face store with the reference's registration flows."""

    def __init__(self, db_path: str, feature_dim: int,
                 data_root: str | None = None, device=None):
        self.device = device
        self.db = sqlite3.connect(db_path)
        self.db.executescript(_SCHEMA)
        self.feature_dim = int(feature_dim)
        self.data_root = data_root
        # reserved TMP person (pid 0) parks card-only faces; person_flag=0
        # keeps it out of the valid_* views
        self.db.execute(
            "INSERT OR IGNORE INTO person (pid, name, person_flag) "
            "VALUES (0, 'TMP', 0)")
        self.db.commit()
        self._cache = None  # (features [N,D], norms [N], fids, pids)
        self._tpu_matcher = None  # matcher + device rows, per generation

    # ------------------------------------------------------------ helpers

    def _invalidate(self):
        self._cache = None
        self._tpu_matcher = None

    def _feature_blob(self, fv: np.ndarray) -> bytes:
        fv = np.ascontiguousarray(fv, np.float32).ravel()
        if fv.shape[0] != self.feature_dim:
            raise ValueError(
                f"feature dim {fv.shape[0]} != store {self.feature_dim}")
        return fv.tobytes()

    def _save_crop(self, rel_path: str, img: np.ndarray | None) -> None:
        if img is None or self.data_root is None:
            return
        import cv2

        full = os.path.join(self.data_root, rel_path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        cv2.imwrite(full, np.asarray(img))

    # -------------------------------------------------------- registration

    def insert_face(self, pid: int, feature: np.ndarray,
                    img_path: str = "", commit: bool = True) -> int:
        """Insert one face row. Standalone calls (e.g.
        PersonGalleryService.add_face) are durable on their own;
        the register_* flows pass ``commit=False`` to keep their
        all-or-nothing transaction and commit once at the end."""
        norm = float(np.linalg.norm(np.asarray(feature, np.float32)))
        cur = self.db.execute(
            "INSERT INTO face (pid, simd_dot, img_path, feature) "
            "VALUES (?, ?, ?, ?)",
            (pid, norm, img_path, self._feature_blob(feature)))
        if commit:
            self.db.commit()
        self._invalidate()
        return int(cur.lastrowid)

    def register_person(
        self,
        person: Person,
        features: list[np.ndarray] | np.ndarray = (),
        crops: list[np.ndarray] | None = None,
        profile_img: np.ndarray | None = None,
    ) -> int:
        """Register_PDB (Feature.hpp:806-859): insert the person row, save
        the profile crop under ``not_verify/<student_id>/profile.png``, then
        one face row + crop per feature."""
        person_dir = f"not_verify/{person.student_id}/"
        profile_rel = person_dir + "profile.png"
        self._save_crop(profile_rel, profile_img)
        cur = self.db.execute(
            "INSERT INTO person (name, role_title, email, student_id, "
            "card_id, person_flag, profile_img) VALUES (?, ?, ?, ?, ?, ?, ?)",
            (person.name, person.role_title, person.email, person.student_id,
             person.card_id, person.person_flag,
             profile_rel if profile_img is not None else person.profile_img))
        pid = int(cur.lastrowid)
        for i, fv in enumerate(features):
            fid = self.insert_face(pid, fv, person_dir, commit=False)
            img_rel = f"{person_dir}{fid}.png"
            self._save_crop(img_rel,
                            crops[i] if crops is not None else None)
            self.db.execute("UPDATE face SET img_path = ? WHERE fid = ?",
                            (img_rel, fid))
        self.db.commit()
        self._invalidate()
        return pid

    def register_card_only(
        self,
        card_id: str,
        features: list[np.ndarray] | np.ndarray,
        crops: list[np.ndarray] | None = None,
    ) -> int:
        """Register_PDB_onlyCard (Feature.hpp:861-896): park faces under the
        TMP person, queue the card id, link rid<->fid; crops land under
        ``regist_list/<rid>/<fid>.png``."""
        cur = self.db.execute(
            "INSERT INTO wanna_regist (card_id) VALUES (?)", (str(card_id),))
        rid = int(cur.lastrowid)
        reg_dir = f"regist_list/{rid}/"
        for i, fv in enumerate(features):
            fid = self.insert_face(TMP_PID, fv, "TMP", commit=False)
            img_rel = f"{reg_dir}{fid}.png"
            self._save_crop(img_rel,
                            crops[i] if crops is not None else None)
            self.db.execute("UPDATE face SET img_path = ? WHERE fid = ?",
                            (img_rel, fid))
            self.db.execute(
                "INSERT INTO regist_face (rid, fid) VALUES (?, ?)",
                (rid, fid))
        self.db.commit()
        self._invalidate()
        return rid

    def pending_registrations(self) -> list[tuple[int, str, list[int]]]:
        """(rid, card_id, [fid...]) rows of the pre-registration queue."""
        out = []
        for rid, card in self.db.execute(
                "SELECT rid, card_id FROM wanna_regist ORDER BY rid"):
            fids = [r[0] for r in self.db.execute(
                "SELECT fid FROM regist_face WHERE rid = ?", (rid,))]
            out.append((int(rid), card, fids))
        return out

    def promote_registration(self, rid: int, person: Person) -> int:
        """Turn a card-only registration into a real person: create the
        person row (card id from the queue) and re-home its parked faces."""
        row = self.db.execute(
            "SELECT card_id FROM wanna_regist WHERE rid = ?",
            (rid,)).fetchone()
        if row is None:
            raise KeyError(f"no pending registration rid={rid}")
        person.card_id = person.card_id or row[0]
        pid = self.register_person(person)
        self.db.execute(
            "UPDATE face SET pid = ? WHERE fid IN "
            "(SELECT fid FROM regist_face WHERE rid = ?)", (pid, rid))
        self.db.execute("DELETE FROM regist_face WHERE rid = ?", (rid,))
        self.db.execute("DELETE FROM wanna_regist WHERE rid = ?", (rid,))
        self.db.commit()
        self._invalidate()
        return pid

    # ------------------------------------------------------------- lookup

    def _person_from_row(self, row) -> Person:
        return Person(pid=int(row[0]), name=row[1], role_title=row[2],
                      email=row[3], student_id=row[4], card_id=row[5],
                      person_flag=int(row[6]), profile_img=row[7])

    def get_person(self, pid: int) -> Person | None:
        row = self.db.execute("SELECT * FROM person WHERE pid = ?",
                              (pid,)).fetchone()
        return self._person_from_row(row) if row else None

    def exists_id_number(self, id_number: int | str) -> Person | None:
        """isExistIDNumber (Feature.hpp:899-931): find the valid person
        whose student_id parses to this number (atol semantics: compare as
        integers, so leading zeros don't matter)."""
        target = int(id_number)
        for row in self.db.execute("SELECT * FROM valid_person"):
            try:
                if int(row[4]) == target:
                    return self._person_from_row(row)
            except ValueError:
                continue
        return None

    def find_by_card(self, card_id: str) -> Person | None:
        row = self.db.execute(
            "SELECT * FROM valid_person WHERE card_id = ?",
            (str(card_id),)).fetchone()
        return self._person_from_row(row) if row else None

    def persons(self) -> list[Person]:
        """Valid persons ordered by pid (Select_Registed_Data's
        'select * from Valid_person order by pid')."""
        return [self._person_from_row(r) for r in self.db.execute(
            "SELECT * FROM valid_person ORDER BY pid")]

    def faces_of(self, pid: int) -> np.ndarray:
        rows = self.db.execute(
            "SELECT feature FROM face WHERE pid = ?", (pid,)).fetchall()
        if not rows:
            return np.zeros((0, self.feature_dim), np.float32)
        return np.stack([np.frombuffer(r[0], np.float32) for r in rows])

    # ------------------------------------------------------------ matching

    def _matrix(self):
        if self._cache is None:
            rows = self.db.execute(
                "SELECT fid, pid, simd_dot, feature FROM valid_face"
            ).fetchall()
            if rows:
                feats = np.stack(
                    [np.frombuffer(r[3], np.float32) for r in rows])
                norms = np.asarray([r[2] for r in rows], np.float32)
                fids = np.asarray([r[0] for r in rows], np.int64)
                pids = np.asarray([r[1] for r in rows], np.int64)
            else:
                feats = np.zeros((0, self.feature_dim), np.float32)
                norms = np.zeros((0,), np.float32)
                fids = pids = np.zeros((0,), np.int64)
            self._cache = (feats, norms, fids, pids)
        return self._cache

    def valid_faces(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every valid face as ``(features [N, D], fids [N], pids [N])`` —
        the rows :meth:`match` scans (valid_face view: person_flag != 0,
        pid != 0). The device-gallery cold-start source
        (serve/gallery_service.py)."""
        feats, _, fids, pids = self._matrix()
        return feats.copy(), fids.copy(), pids.copy()

    def set_person_flag(self, pid: int, flag: int) -> None:
        """Flip a person's person_flag (0 retires them from the valid_*
        views — the reference's soft delete; nonzero restores)."""
        if pid == 0:
            raise ValueError("pid 0 is the reserved TMP person")
        cur = self.db.execute(
            "UPDATE person SET person_flag = ? WHERE pid = ?", (flag, pid))
        if cur.rowcount == 0:
            raise KeyError(f"no person pid={pid}")
        self.db.commit()
        self._invalidate()

    def match(self, feature: np.ndarray, sim_th: float = 0.5) -> MatchResult:
        """Compare_Face_DB (Feature.hpp:766-804): max cosine over every
        valid face; the owning person wins if it clears the threshold."""
        feats, norms, fids, pids = self._matrix()
        if feats.shape[0] == 0:
            return MatchResult(None, 0.0)
        fv = np.asarray(feature, np.float32).ravel()
        denom = norms * max(float(np.linalg.norm(fv)), 1e-12)
        sims = (feats @ fv) / np.maximum(denom, 1e-12)
        best = int(np.argmax(sims))
        sim = float(sims[best])
        if sim < sim_th:
            return MatchResult(None, sim)
        return MatchResult(self.get_person(int(pids[best])), sim,
                           fid=int(fids[best]))

    def match_batch(self, features: np.ndarray, sim_th: float = 0.5,
                    use_tpu: bool = True) -> "list[MatchResult]":
        """Bulk Compare_Face_DB: identify N probes in one shot. With
        ``use_tpu`` the cosine scan runs as ONE [N, D] x [D, F] product on
        the store's device (serve/gallery.py::make_gallery_matcher) — the
        right side of the ~100k-face host/device crossover;
        ``use_tpu=False`` loops the host scan, same results."""
        features = np.atleast_2d(np.asarray(features, np.float32))
        feats, norms, fids, pids = self._matrix()
        if feats.shape[0] == 0:
            return [MatchResult(None, 0.0) for _ in range(len(features))]
        if not use_tpu:
            return [self.match(fv, sim_th) for fv in features]
        # the matcher (and its normalized device-resident gallery rows) is
        # cached per store generation — rebuilding it per call would
        # re-upload O(G) rows on every bulk identify; _invalidate() drops it
        # whenever the face set changes
        if self._tpu_matcher is None:
            from .gallery import make_gallery_matcher

            self._tpu_matcher = make_gallery_matcher(feats,
                                                     device=self.device)
        idx, sim = self._tpu_matcher(features)
        idx, sim = idx.cpu().numpy().astype(np.int64), sim.cpu().numpy()
        # every argmax kept; thresholding happens here so the
        # below-threshold similarity is still reported (host parity)
        out = []
        for i, s in zip(idx, sim):
            if s < sim_th:
                out.append(MatchResult(None, float(s)))
            else:
                out.append(MatchResult(self.get_person(int(pids[i])),
                                       float(s), fid=int(fids[i])))
        return out

    # ------------------------------------------------- reg_face interop

    def export_reg_face(self, path: str) -> int:
        """Write the C version's flat SQLite schema (Feature.hpp:433-441):
        reg_face(IDS, NAME, FEATEXE, SIMD_DOT) — one row per valid face,
        NAME = owning person's name."""
        out = sqlite3.connect(path)
        out.execute("CREATE TABLE IF NOT EXISTS `reg_face` ( `IDS` INTEGER "
                    "PRIMARY KEY AUTOINCREMENT, `NAME` TEXT, `FEATEXE` "
                    "BLOB, `SIMD_DOT` REAL)")
        n = 0
        for pid, name in self.db.execute(
                "SELECT pid, name FROM valid_person"):
            for (blob, dot) in self.db.execute(
                    "SELECT feature, simd_dot FROM face WHERE pid = ?",
                    (pid,)):
                out.execute(
                    "INSERT INTO reg_face (NAME, FEATEXE, SIMD_DOT) "
                    "VALUES (?, ?, ?)", (name, blob, dot))
                n += 1
        out.commit()
        out.close()
        return n

    def import_reg_face(self, path: str,
                        dedup_threshold: float = 0.99999) -> int:
        """Load a reg_face db: one person per distinct NAME, faces deduped
        at >threshold cosine (Register_DB_File's same-feature guard,
        Feature.hpp:467-471)."""
        src = sqlite3.connect(path)
        n = 0
        by_name: dict[str, int] = {
            p.name: p.pid for p in self.persons()}
        for name, blob, dot in src.execute(
                "SELECT NAME, FEATEXE, SIMD_DOT FROM reg_face"):
            fv = np.frombuffer(blob, np.float32)
            res = self.match(fv, sim_th=dedup_threshold)
            if res.person is not None:
                continue  # same feature vector already present
            pid = by_name.get(name)
            if pid is None:
                pid = self.register_person(Person(name=name))
                by_name[name] = pid
            self.insert_face(pid, fv, commit=False)  # one commit below
            n += 1
        src.close()
        self.db.commit()
        self._invalidate()
        return n

    # --------------------------------------------- native FJPD interchange

    def export_fjpd(self, path: str) -> tuple[int, int]:
        """Write the native person store binary ("FJPD" v1,
        cpp/include/facejax/person_store.hpp) — the interchange format
        between this SQLite store and the zero-Python serving binary:
        every person (incl. the reserved TMP row), every face with its
        cached norm, and the card-only pre-registration queue, with ids
        preserved. Returns (n_persons, n_faces)."""
        import struct

        persons = self.db.execute(
            "SELECT pid, name, role_title, email, student_id, card_id, "
            "person_flag, profile_img FROM person ORDER BY pid").fetchall()
        faces = self.db.execute(
            "SELECT fid, pid, simd_dot, img_path, feature FROM face "
            "ORDER BY fid").fetchall()
        regs = self.pending_registrations()

        def wstr(f, s):
            b = str(s).encode("utf-8")
            f.write(struct.pack("<I", len(b)))
            f.write(b)

        # monotonic id counters come from sqlite's AUTOINCREMENT sequence
        # (NOT max+1 over surviving rows: a promoted registration's rid
        # must never be reused — its regist_list/<rid>/ crops and any
        # external references outlive the queue row)
        def next_id(table, fallback_rows):
            row = self.db.execute(
                "SELECT seq FROM sqlite_sequence WHERE name = ?",
                (table,)).fetchone()
            if row is not None:
                return int(row[0]) + 1
            return max(fallback_rows, default=0) + 1

        next_pid = next_id("person", (int(p[0]) for p in persons))
        next_fid = next_id("face", (int(r[0]) for r in faces))
        next_rid = next_id("wanna_regist", (r[0] for r in regs))
        with open(path, "wb") as f:
            f.write(struct.pack(
                "<9I", 0x44504A46, 1, self.feature_dim, next_pid,
                next_fid, next_rid, len(persons), len(faces), len(regs)))
            for pid, name, rt, em, sid, cid, flag, img in persons:
                f.write(struct.pack("<ii", int(pid), int(flag)))
                for s in (name, rt, em, sid, cid, img):
                    wstr(f, s)
            for fid, pid, norm, img, blob in faces:
                if len(blob) != 4 * self.feature_dim:
                    raise ValueError(f"face fid={fid} has a "
                                     f"{len(blob)}-byte feature blob")
                f.write(struct.pack("<ii", int(fid), int(pid)))
                wstr(f, img)
                f.write(struct.pack("<f", float(norm)))
                f.write(blob)
            for rid, card, fids in regs:
                f.write(struct.pack("<i", int(rid)))
                wstr(f, card)
                f.write(struct.pack("<I", len(fids)))
                for fid in fids:
                    f.write(struct.pack("<i", int(fid)))
        return len(persons), len(faces)

    def import_fjpd(self, path: str) -> tuple[int, int]:
        """Load a native FJPD store (e.g. one the serving binary enrolled
        into) with ids preserved. The store must be EMPTY (only the
        reserved TMP person) — id-preserving import into a populated
        store would collide. Returns (n_persons, n_faces)."""
        import struct

        n_existing = self.db.execute(
            "SELECT COUNT(*) FROM person WHERE pid != 0").fetchone()[0]
        n_faces_existing = self.db.execute(
            "SELECT COUNT(*) FROM face").fetchone()[0]
        if n_existing or n_faces_existing:
            raise ValueError("import_fjpd requires an empty store "
                             f"(has {n_existing} persons / "
                             f"{n_faces_existing} faces)")
        try:
            return self._import_fjpd_rows(path)
        except Exception:
            # all-or-nothing: a corrupt/truncated file must not leave
            # partially-imported rows pending in the transaction (they
            # would silently land with the NEXT commit)
            self.db.rollback()
            self._invalidate()
            raise

    def _import_fjpd_rows(self, path: str) -> tuple[int, int]:
        import struct

        with open(path, "rb") as f:
            def rstr():
                (ln,) = struct.unpack("<I", f.read(4))
                if ln > (1 << 20):
                    raise ValueError("corrupt FJPD: oversized string")
                return f.read(ln).decode("utf-8")

            magic, version, dim, next_pid, next_fid, next_rid, \
                n_p, n_f, n_r = struct.unpack("<9I", f.read(36))
            if magic != 0x44504A46 or version != 1:
                raise ValueError("not a FJPD v1 file")
            if dim != self.feature_dim:
                raise ValueError(f"FJPD dim {dim} != store "
                                 f"{self.feature_dim}")
            for _ in range(n_p):
                pid, flag = struct.unpack("<ii", f.read(8))
                name, rt, em, sid, cid, img = (rstr() for _ in range(6))
                if pid == TMP_PID:
                    continue  # reserved row already exists
                self.db.execute(
                    "INSERT INTO person (pid, name, role_title, email, "
                    "student_id, card_id, person_flag, profile_img) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                    (pid, name, rt, em, sid, cid, flag, img))
            for _ in range(n_f):
                fid, pid = struct.unpack("<ii", f.read(8))
                img = rstr()
                (norm,) = struct.unpack("<f", f.read(4))
                blob = f.read(4 * dim)
                if len(blob) != 4 * dim:
                    # struct.unpack guards every other field; the raw
                    # feature read must be checked too or a truncated
                    # file imports a short blob that breaks _matrix()
                    raise ValueError("truncated FJPD feature blob")
                self.db.execute(
                    "INSERT INTO face (fid, pid, simd_dot, img_path, "
                    "feature) VALUES (?, ?, ?, ?, ?)",
                    (fid, pid, norm, img, blob))
            for _ in range(n_r):
                (rid,) = struct.unpack("<i", f.read(4))
                card = rstr()
                (k,) = struct.unpack("<I", f.read(4))
                self.db.execute(
                    "INSERT INTO wanna_regist (rid, card_id) VALUES (?, ?)",
                    (rid, card))
                for _ in range(k):
                    (fid,) = struct.unpack("<i", f.read(4))
                    self.db.execute(
                        "INSERT INTO regist_face (rid, fid) VALUES (?, ?)",
                        (rid, fid))
            # restore the header's monotonic counters so ids retired on
            # the native side (e.g. promoted rids) are never reissued
            for table, nxt in (("person", next_pid), ("face", next_fid),
                               ("wanna_regist", next_rid)):
                # sqlite_sequence has no declared unique constraint, so
                # no ON CONFLICT — update-then-insert by hand
                cur = self.db.execute(
                    "UPDATE sqlite_sequence SET seq = max(seq, ?) "
                    "WHERE name = ?", (int(nxt) - 1, table))
                if cur.rowcount == 0:
                    self.db.execute(
                        "INSERT INTO sqlite_sequence (name, seq) "
                        "VALUES (?, ?)", (table, int(nxt) - 1))
        self.db.commit()
        self._invalidate()
        return n_p, n_f

    # ----------------------------------------------------------- lifecycle

    def close(self):
        self.db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
