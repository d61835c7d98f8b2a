"""The port's person store, gallery service and ``identify`` CLI against
the JAX package's, on the CPU.

Files cross-read both ways: a sqlite DB, an FJPD file and a ``reg_face``
DB written by one package are read by the other (the schema text and the
FJPD bytes are identical). Host matches are the same numpy code on both
sides and must be equal; device products (``match_batch(use_tpu=True)``,
the gallery service) hold persons exactly and similarities within 1e-6
(f32; the product's sum order differs), bit for bit for int8. Each
``identify`` subcommand's printed result and JSONL equal the JAX CLI's,
similarities to the JSONL's 6 digits (the f32 device routes within
1e-6 before that rounding, so within 2e-6 after it); the native inputs (``--native-export``, ``--native-mtcnn``) run
the same C++ library on both sides and are exact.
"""

import json
import sqlite3

import numpy as np
import pytest

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    identify as jidentify,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.data import (
    save_feature_store,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.data.records import (
    save_image_store,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    gallery_service as jgs,
    person_store as jps,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    export_mtcnn,
    export_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    identify as tidentify,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    gallery_service as tgs,
    native as tnative,
    person_store as tps,
)
from _torch_weights import flax_params, mtcnn_params

DIM = 32


def _clustered(n_ids=4, per_id=3, seed=11, dim=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_ids, dim)).astype(np.float32) * 4
    feats = np.concatenate([
        centers[i] + rng.normal(size=(per_id, dim)).astype(np.float32) * 0.05
        for i in range(n_ids)])
    return feats, np.repeat(np.arange(n_ids), per_id)


def _fill(ps, root, feats, labels):
    """The same writes through either package's PersonStore: two persons
    with crops, one retired person, a card-only registration promoted and
    one left pending."""
    crops = [np.full((8, 8, 3), 40 * i, np.uint8) for i in range(3)]
    with ps.PersonStore(root + ".sqlite", DIM,
                        data_root=root + "_data") as store:
        a = store.register_person(
            ps.Person(name="alice", student_id="0042", card_id="c1",
                      email="a@x", role_title="dr"),
            list(feats[labels == 0]), crops=crops,
            profile_img=np.zeros((4, 4, 3), np.uint8))
        store.register_person(ps.Person(name="bob", student_id="7"),
                              list(feats[labels == 1]))
        gone = store.register_person(ps.Person(name="carol"),
                                     list(feats[labels == 2]))
        store.set_person_flag(gone, 0)
        rid = store.register_card_only("card-9", list(feats[labels == 3][:2]))
        store.promote_registration(rid, ps.Person(name="dave"))
        store.register_card_only("card-10", [feats[labels == 3][2]])
        return a


def _who(r):
    """A MatchResult's person (as a dict: the two packages' Person classes
    differ) and face id."""
    return (None if r.person is None else vars(r.person), r.fid)


def _dump(path, tables=("person", "face", "wanna_regist", "regist_face",
                        "sqlite_sequence")):
    db = sqlite3.connect(path)
    out = {t: db.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
           for t in tables}
    out["schema"] = db.execute(
        "SELECT type, name, sql FROM sqlite_master ORDER BY name").fetchall()
    db.close()
    return out


def test_databases_cross_read(tmp_path):
    """The same writes give the same sqlite rows, schema and crop files;
    each package reads the other's DB, FJPD and reg_face files."""
    feats, labels = _clustered()
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    assert _fill(jps, jroot, feats, labels) == _fill(tps, troot, feats,
                                                    labels)
    assert _dump(troot + ".sqlite") == _dump(jroot + ".sqlite")
    jfiles = sorted(p.relative_to(tmp_path / "j_data")
                    for p in (tmp_path / "j_data").rglob("*.png"))
    tfiles = sorted(p.relative_to(tmp_path / "t_data")
                    for p in (tmp_path / "t_data").rglob("*.png"))
    assert tfiles == jfiles and len(tfiles) == 4
    for own, other in ((tps, jroot), (jps, troot)):
        with own.PersonStore(other + ".sqlite", DIM) as store:
            assert [p.name for p in store.persons()] == ["alice", "bob",
                                                          "dave"]
            assert store.exists_id_number("42").name == "alice"
            assert store.find_by_card("c1").name == "alice"
            assert store.pending_registrations()[0][1] == "card-10"
    # FJPD: the same bytes, and each package imports the other's
    with jps.PersonStore(jroot + ".sqlite", DIM) as js, \
            tps.PersonStore(troot + ".sqlite", DIM) as ts:
        assert ts.export_fjpd(troot + ".fjpd") == js.export_fjpd(
            jroot + ".fjpd")
        assert ts.export_reg_face(troot + ".reg") == js.export_reg_face(
            jroot + ".reg")
    assert open(troot + ".fjpd", "rb").read() == open(jroot + ".fjpd",
                                                      "rb").read()
    assert _dump(troot + ".reg", ("reg_face",)) == _dump(jroot + ".reg",
                                                        ("reg_face",))
    for own, src, dst in ((tps, jroot, "t_in"), (jps, troot, "j_in")):
        with own.PersonStore(str(tmp_path / f"{dst}.sqlite"), DIM) as store:
            store.import_fjpd(src + ".fjpd")
            assert [p.name for p in store.persons()] == ["alice", "bob",
                                                          "dave"]
            assert store.export_fjpd(str(tmp_path / f"{dst}.fjpd")) == (5, 12)
        assert open(str(tmp_path / f"{dst}.fjpd"), "rb").read() == open(
            src + ".fjpd", "rb").read()
        with own.PersonStore(str(tmp_path / f"{dst}_reg.sqlite"),
                             DIM) as store:
            assert store.import_reg_face(src + ".reg") == 8
            assert [p.name for p in store.persons()] == ["alice", "bob",
                                                          "dave"]


def test_match_and_match_batch_equal_jax(tmp_path):
    feats, labels = _clustered()
    probes = np.concatenate([feats[[0, 4, 10]] + 0.01,
                             np.random.default_rng(3).normal(
                                 size=(2, DIM)).astype(np.float32)])
    _fill(jps, str(tmp_path / "j"), feats, labels)
    _fill(tps, str(tmp_path / "t"), feats, labels)
    with jps.PersonStore(str(tmp_path / "j.sqlite"), DIM) as js, \
            tps.PersonStore(str(tmp_path / "t.sqlite"), DIM,
                            device="cpu") as ts:
        for p in probes:
            a, b = ts.match(p, 0.5), js.match(p, 0.5)
            assert _who(a) == _who(b) and a.similarity == b.similarity
        for host in (True, False):
            got = ts.match_batch(probes, 0.5, use_tpu=host)
            want = js.match_batch(probes, 0.5, use_tpu=host)
            assert list(map(_who, got)) == list(map(_who, want))
            np.testing.assert_allclose([r.similarity for r in got],
                                       [r.similarity for r in want],
                                       rtol=0, atol=1e-6)
    with tps.PersonStore(str(tmp_path / "empty.sqlite"), DIM,
                         device="cpu") as ts:
        assert [r.similarity for r in ts.match_batch(probes[:2])] == [0.0,
                                                                       0.0]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_gallery_service_matches_jax(tmp_path, dtype):
    """Cold start, write-through enroll / add_face, retire (tombstones),
    refresh (compaction) and resolve edges, step by step beside the JAX
    service over twin stores."""
    import jax.numpy as jnp
    import torch

    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[dtype]
    feats, labels = _clustered(n_ids=5)
    probes = feats[[0, 3, 6, 9, 12]] + 0.02
    with jps.PersonStore(str(tmp_path / "j.sqlite"), DIM) as js, \
            tps.PersonStore(str(tmp_path / "t.sqlite"), DIM) as ts:
        for store, ps in ((js, jps), (ts, tps)):
            for i in range(3):
                store.register_person(ps.Person(name=f"p{i}"),
                                      list(feats[labels == i]))
        jsvc = jgs.PersonGalleryService(js, capacity=4, dtype=jdt)
        tsvc = tgs.PersonGalleryService(ts, capacity=4, dtype=tdt,
                                        device="cpu")

        def same():
            assert tsvc.rows == jsvc.rows
            got = tsvc.match_batch(probes, sim_th=0.5)
            want = jsvc.match_batch(probes, sim_th=0.5)
            assert list(map(_who, got)) == list(map(_who, want))
            sims = ([r.similarity for r in got], [r.similarity for r in want])
            if dtype == "int8":
                assert sims[0] == sims[1]
            else:
                np.testing.assert_allclose(*sims, rtol=0, atol=1e-6)

        same()                                       # cold start: 9 rows
        assert (tsvc.enroll(tps.Person(name="p3"), list(feats[labels == 3]))
                == jsvc.enroll(jps.Person(name="p3"),
                               list(feats[labels == 3])))
        assert tsvc.add_face(1, feats[labels == 4][0]) == jsvc.add_face(
            1, feats[labels == 4][0])
        same()                                       # doubled to 16
        assert tsvc.retire_person(2) == jsvc.retire_person(2) == 3
        same()
        tsvc.refresh()
        jsvc.refresh()
        same()                                       # compacted
        for args in ((-1, 0.9), (999, 0.9), (0, 0.1), (0, 0.9)):
            a, b = tsvc.resolve(*args), jsvc.resolve(*args)
            assert _who(a) == _who(b) and a.similarity == b.similarity
        a, b = tsvc.resolve_batch([0, -1], [0.9, 0.9]), jsvc.resolve_batch(
            [0, -1], [0.9, 0.9])
        assert list(map(_who, a)) == list(map(_who, b))
        with pytest.raises(KeyError):
            tsvc.add_face(99, feats[0])
        # mesh= over a process group of one: the row-sharded service
        # gives the same answers (tests/test_torch_parallel_serve.py holds
        # it to JAX's on 2 ranks)
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
            parallel,
        )

        with parallel.process_group("cpu"):
            msvc = tgs.PersonGalleryService(
                ts, capacity=4, dtype=tdt, device="cpu",
                mesh=parallel.make_2d_mesh(1))
            got = msvc.match_batch(probes, sim_th=0.5)
            want = tsvc.match_batch(probes, sim_th=0.5)
            assert list(map(_who, got)) == list(map(_who, want))
            assert ([r.similarity for r in got]
                    == [r.similarity for r in want])


# ------------------------------------------------------------ identify CLI


def _run_both(capsys, argv, tmp_path, extra_t=()):
    """Run ``argv`` through both CLIs in twin directories (``{d}`` in an
    argument names the side's directory); returns (port, jax) results,
    printed lines and JSONL rows."""
    out = []
    for cli, side, extra in ((tidentify, "t", list(extra_t)),
                             (jidentify, "j", [])):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        args = [a.replace("{d}", str(d)) for a in argv] + extra
        res = cli.main(args)
        printed = capsys.readouterr().out
        rows = None
        if "--out" in args:
            with open(args[args.index("--out") + 1]) as f:
                rows = [json.loads(line) for line in f]
        out.append((res, printed, rows))
    return out


def _same_rows(got, want, atol=0.0):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k != "similarity"} == {
            k: v for k, v in b.items() if k != "similarity"}
        assert abs(a["similarity"] - b["similarity"]) <= atol * 1.0001


def test_identify_person_subcommands_match_jax(tmp_path, capsys):
    feats, labels = _clustered(n_ids=3, per_id=4, dim=342)
    store = str(tmp_path / "f.npz")
    save_feature_store(store, feats, labels)
    probes = str(tmp_path / "p.npz")
    save_feature_store(probes, feats + 0.01 * np.random.default_rng(2).normal(
        size=feats.shape).astype(np.float32), labels)
    db = ["--store", "{d}/p.sqlite"]
    for label, name in ((0, "alice"), (1, "bob")):
        (t, j) = _run_both(capsys, ["enroll-person", *db, "--features",
                                    store, "--label", str(label), "--name",
                                    name, "--student-id", f"00{label + 5}"],
                           tmp_path)
        assert t[0] == j[0] and t[1] == j[1]
    t, j = _run_both(capsys, ["register-card", *db, "--features", store,
                              "--label", "2", "--card-id", "c77"], tmp_path)
    assert t[0] == j[0] == 1 and t[1] == j[1]
    t, j = _run_both(capsys, ["lookup-id", *db, "--id-number", "5"],
                     tmp_path)
    assert t[1] == j[1] and json.loads(t[1])["name"] == "alice"
    for route, extra_t, atol in (
            ([], (), 0.0),
            (["--tpu"], ("--device", "cpu"), 2e-6),
            (["--device-gallery"], ("--device", "cpu"), 2e-6),
            (["--device-gallery", "--gallery-dtype", "bf16"],
             ("--device", "cpu"), 2e-6),
            (["--device-gallery", "--gallery-dtype", "int8"],
             ("--device", "cpu"), 0.0)):
        t, j = _run_both(capsys, ["match-person", *db, "--features", probes,
                                  "--sim-th", "0.5", "--out",
                                  "{d}/m.jsonl", *route], tmp_path, extra_t)
        assert t[1] == j[1]
        _same_rows(t[2], j[2], atol)
        assert {r["name"] for r in t[2]} == {"alice", "bob", None}
    t, j = _run_both(capsys, ["promote", *db, "--rid", "1", "--name",
                              "carol", "--student-id", "9"], tmp_path)
    assert t[0] == j[0] and t[1] == j[1]
    t, j = _run_both(capsys, ["match-person", *db, "--features", probes,
                              "--out", "{d}/m2.jsonl"], tmp_path)
    _same_rows(t[2], j[2])
    assert {r["name"] for r in t[2]} == {"alice", "bob", "carol"}
    for argv in (["--tpu", "--device-gallery"], ["--gallery-dtype", "int8"]):
        with pytest.raises(SystemExit):
            tidentify.main(["match-person", "--store", str(tmp_path / "x"),
                            "--features", probes, *argv])


@pytest.fixture(scope="module")
def native_inputs(tmp_path_factory):
    """An EFMNet342 export at 32x32 and an ``export_mtcnn`` npz of random
    MTCNN nets (numpy weights in the JAX layouts), and raw frames of two
    smooth scenes on which the random cascade fires."""
    # one OpenMP thread: the suite runs in several worker processes at
    # once, and the native kernels' thread teams would oversubscribe the
    # cores (both libraries share the process's OpenMP runtime)
    saved = tnative.native_set_num_threads(0)
    tnative.native_set_num_threads(1)
    d = tmp_path_factory.mktemp("native")
    export = str(d / "export")
    export_params(export, flax_params(JEFMNet342(num_classes=10), 32, 3),
                  model_name="efmnet342", feature_dim=342,
                  input_hw=(32, 32), input_channels=1)
    nets = []
    for i, spec in enumerate((jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC,
                              jmtcnn._ONET_SPEC)):
        p = mtcnn_params(spec, seed=i)
        for entry in p.values():           # the JAX init's zero biases
            if "biases" in entry:
                entry["biases"][:] = 0.0
        nets.append(jmtcnn.load_npy_params(p))
    npz = str(d / "mtcnn.npz")
    export_mtcnn(npz, *nets)
    rng = np.random.default_rng(11)
    frames = []
    for _ in range(2):
        base = rng.uniform(40, 210, (9, 12, 3))
        frame = np.kron(base, np.ones((8, 8, 1))).astype(np.uint8)
        frames += [frame, frame]
    store = str(d / "frames.npz")
    save_image_store(store, np.stack(frames), np.asarray([0, 0, 1, 1]))
    crops = str(d / "crops.npz")
    save_image_store(crops, (np.random.default_rng(4).random(
        (4, 32, 32, 1)) * 255).astype(np.uint8), np.asarray([0, 0, 1, 1]))
    yield export, npz, store, crops
    tnative.native_set_num_threads(saved)


def test_identify_native_inputs_match_jax(tmp_path, capsys, native_inputs):
    """``enroll`` / ``match`` over the native store, from an image store
    (``--native-export``) and from raw frames (``--native-mtcnn``, also
    every face with ``--mtcnn-all-faces``), and the person flows from raw
    frames: the same C++ library on both sides, so equal results."""
    export, npz, frames, crops = native_inputs
    det = ["--native-mtcnn", npz, "--mtcnn-thresholds", "0.45", "0.35",
           "0.3"]
    for name, src, extra in (("img", crops, []), ("raw", frames, det)):
        common = ["--store", "{d}/" + name + ".fjdb", "--features", src,
                  "--native-export", export, *extra]
        t, j = _run_both(capsys, ["enroll", *common], tmp_path)
        assert t[0] == j[0] >= 2 and t[1] == j[1]
        for more in ([], ["--mtcnn-all-faces"] if extra else []):
            t, j = _run_both(capsys, ["match", *common, "--sim-th", "0.5",
                                      "--out", "{d}/" + name + ".jsonl",
                                      *more], tmp_path)
            assert t[1] == j[1]
            _same_rows(t[2], j[2])
    common = ["--store", "{d}/np.sqlite", "--features", frames,
              "--native-export", export, *det]
    t, j = _run_both(capsys, ["enroll-person", *common, "--label", "0",
                              "--name", "alice"], tmp_path)
    assert t[0] == j[0] and t[1] == j[1]
    t, j = _run_both(capsys, ["match-person", *common, "--out",
                              "{d}/np.jsonl"], tmp_path)
    _same_rows(t[2], j[2])
    assert "alice" in {r["name"] for r in t[2]}
