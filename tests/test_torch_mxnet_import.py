"""The port's MXNet ``.params`` import (``utils/mxnet_import.py``,
``cli/import_params.py``) against the JAX package's.

Both layouts: the EFM symbol checkpoint (EFMNet342) and the gluon
LightCNN_29 ``save_parameters`` file (shared res convs, BatchNorm running
statistics). Weights are filled from a seed with numpy in the flax layout
(no JAX random init). Everything on the file and tree side is numpy, so
it must be EQUAL: files written by either package's writer read back
identically in the other's reader, under uint32 and int64 dims; the
mappings and ``expand_shared_res`` give the same trees bit for bit;
garbage, truncated and wrongly-sized files raise ``MxParamsError`` with
the same message on both sides; the port's ``import_params`` writes the
JAX CLI's export (arrays bit for bit, equal manifests) and the
symbol-JSON check agrees. The imported model's forward in the port holds
to JAX's at float32 within atol 1e-4 + rtol 1e-5 (the two frameworks sum
their convs in another order; these random weights give logits near 100,
where float32 rounding alone is ~1e-5).
"""

import json

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    import_params as jcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    LightCNN29 as JLightCNN29,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.utils import (
    mxnet_import as jmx,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    import_params as tcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils import (
    mxnet_import as tmx,
)
from _torch_weights import flax_params

SIZE, CLASSES = 32, 7


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def efm():
    """(flax EFMNet342, params, mx args)."""
    model = JEFMNet342(num_classes=CLASSES)
    params = flax_params(model, SIZE, seed=11)
    return model, params, jmx.efm_params_to_mxnet(params)


@pytest.fixture(scope="module")
def gluon():
    """(flax LightCNN29 with shared res convs, params, batch_stats, mx
    args, mx aux); the BatchNorm statistics are not the init's."""
    model = JLightCNN29(num_classes=CLASSES, gluon_shared_res=True)
    params = flax_params(model, SIZE, seed=12)
    rng = np.random.default_rng(13)
    stats = {"fc1_bn": {"mean": rng.normal(0, 0.5, 684).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 684).astype(np.float32)}}
    args, aux = jmx.gluon_lightcnn29_to_mxnet(params, stats)
    return model, params, stats, args, aux


@pytest.mark.parametrize("layout", ["efm", "gluon"])
@pytest.mark.parametrize("dim64", [False, True])
def test_files_cross_read(layout, dim64, efm, gluon, tmp_path):
    """A file written by one package's writer reads identically in the
    other's reader, and the two writers write the same bytes."""
    if layout == "efm":
        args, aux = efm[2], {}
    else:
        args, aux = gluon[3], gluon[4]
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.write_mxnet_params(jpath, args, aux, dim64=dim64)
    tmx.write_mxnet_params(tpath, args, aux, dim64=dim64)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    for reader, path in ((tmx.read_mxnet_params, jpath),
                         (jmx.read_mxnet_params, tpath)):
        got_args, got_aux = reader(path)
        _assert_trees_equal(got_args, args)
        _assert_trees_equal(got_aux, aux)
    assert tmx.is_gluon_lightcnn29(args) == (layout == "gluon")


def test_mappings_equal_jax(efm, gluon):
    _, _, args = efm
    _assert_trees_equal(tmx.map_efm_params(args), jmx.map_efm_params(args))
    assert tmx.infer_input_size(args) == jmx.infer_input_size(args) == SIZE
    tree = jmx.map_efm_params(args)
    _assert_trees_equal(tmx.efm_params_to_mxnet(tree),
                        jmx.efm_params_to_mxnet(tree))

    _, params, stats, gargs, gaux = gluon
    got = tmx.map_gluon_lightcnn29(gargs, gaux)
    want = jmx.map_gluon_lightcnn29(gargs, gaux)
    _assert_trees_equal(got[0], want[0])
    _assert_trees_equal(got[1], want[1])
    _assert_trees_equal(got[0], params)          # the round trip is exact
    _assert_trees_equal(tmx.expand_shared_res(got[0]),
                        jmx.expand_shared_res(want[0]))
    _assert_trees_equal(tmx.gluon_lightcnn29_to_mxnet(params, stats)[0],
                        gargs)
    # an already distinct tree passes through unchanged on both sides
    expanded = jmx.expand_shared_res(want[0])
    _assert_trees_equal(tmx.expand_shared_res(expanded),
                        jmx.expand_shared_res(expanded))


def _raises_alike(call_j, call_t):
    with pytest.raises(jmx.MxParamsError) as ej:
        call_j()
    with pytest.raises(tmx.MxParamsError) as et:
        call_t()
    assert str(et.value) == str(ej.value)


def test_bad_inputs_rejected_alike(efm, gluon, tmp_path):
    junk = tmp_path / "junk.params"
    junk.write_bytes(b"\x00" * 64)
    short = tmp_path / "short.params"
    short.write_bytes(b"\x12\x01")
    magic = tmp_path / "magic.params"
    magic.write_bytes(np.asarray([0x112, 0, 3], "<u8").tobytes() + b"\x07" * 40)
    for p in (junk, short, magic):
        _raises_alike(lambda: jmx.read_mxnet_params(str(p)),
                      lambda: tmx.read_mxnet_params(str(p)))
    full = str(tmp_path / "full.params")
    jmx.write_mxnet_params(full, efm[2])
    blob = open(full, "rb").read()
    for frac in (0.3, 0.7, 0.95, 0.9999):
        cut = tmp_path / f"cut{frac}.params"
        cut.write_bytes(blob[:int(len(blob) * frac)])
        _raises_alike(lambda: jmx.read_mxnet_params(str(cut)),
                      lambda: tmx.read_mxnet_params(str(cut)))
    # trees the mappings refuse: a missing array, a non-square fc1
    args = dict(efm[2])
    del args["conv31_res_r_bias"]
    _raises_alike(lambda: jmx.map_efm_params(args),
                  lambda: tmx.map_efm_params(args))
    args = dict(efm[2])
    args["fc1_weight"] = np.concatenate([args["fc1_weight"]] * 2, 1)
    _raises_alike(lambda: jmx.map_efm_params(args),
                  lambda: tmx.map_efm_params(args))
    gargs = {k: v for k, v in gluon[3].items() if not k.startswith("fc1.0")}
    _raises_alike(lambda: jmx.map_gluon_lightcnn29(gargs, {}),
                  lambda: tmx.map_gluon_lightcnn29(gargs, {}))


def _symbol(tmp_path, stem=99):
    def conv(name, nf):
        return {"op": "Convolution", "name": name,
                "attrs": {"num_filter": str(nf)}}

    nodes = [conv("conv1", stem), {"op": "null", "name": "data"}]
    ladder = [(99, 198, 1), (198, 387, 2), (387, 261, 3), (261, 261, 4)]
    for si, (num_r, num, tar) in enumerate(ladder, start=2):
        for i in range(tar):
            blk = str(si) if i == 0 else f"{si}{i}"
            nodes += [conv(f"conv{blk}_res", num_r),
                      conv(f"conv{blk}_res_r", num_r * 2 // 3)]
        nodes += [conv(f"conv{si}_r", num_r), conv(f"conv{si}", num)]
    path = tmp_path / f"sym{stem}.json"
    path.write_text(json.dumps({"nodes": nodes}))
    return str(path)


def test_symbol_json_check_equal_jax(tmp_path):
    good = _symbol(tmp_path)
    assert tmx.validate_symbol_json(good) == jmx.validate_symbol_json(good)
    bad = _symbol(tmp_path, stem=96)
    _raises_alike(lambda: jmx.validate_symbol_json(bad),
                  lambda: tmx.validate_symbol_json(bad))


def _export(path):
    with open(f"{path}/manifest.json") as f:
        manifest = json.load(f)
    with np.load(f"{path}/weights.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


@pytest.mark.parametrize("layout", ["efm", "gluon"])
def test_import_cli_export_equals_jax(layout, efm, gluon, tmp_path, capsys):
    """Both CLIs import the same file; the exports are equal bit for bit,
    and the port's ``--verify`` builds the port's model and runs it. The
    imported model's f32 forward in the port then holds to JAX's on the
    same export within atol 1e-4 + rtol 1e-5."""
    if layout == "efm":
        model, args, aux = efm[0], efm[2], {}
    else:
        model, args, aux = JLightCNN29(num_classes=CLASSES), gluon[3], gluon[4]
    ckpt = str(tmp_path / "ckpt.params")
    jmx.write_mxnet_params(ckpt, args, aux)
    sym = ["--symbol", _symbol(tmp_path)] if layout == "efm" else []
    jout, tout = str(tmp_path / "jexp"), str(tmp_path / "texp")
    jcli.main([ckpt, "--out-dir", jout] + sym)
    capsys.readouterr()
    tcli.main([ckpt, "--out-dir", tout, "--verify", "--device", "cpu"] + sym)
    text = capsys.readouterr().out
    assert "verify: forward OK, logits (1, 7)" in text
    jman, jarr = _export(jout)
    tman, tarr = _export(tout)
    assert tman == jman
    assert tman["model"] == ("efmnet342" if layout == "efm" else "lightcnn29")
    assert sorted(tarr) == sorted(jarr)
    for k in jarr:
        assert tarr[k].dtype == jarr[k].dtype
        np.testing.assert_array_equal(tarr[k], jarr[k], err_msg=k)

    from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
        load_exported_params,
    )

    params, stats, _ = load_exported_params(jout)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    x = np.random.default_rng(4).uniform(0, 1, (2, SIZE, SIZE, 1)).astype(
        np.float32)
    want = model.apply(variables, x, train=False)
    tmodel = from_jax_params(tout, device="cpu")
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-5)


def test_verify_rejects_a_wrong_tree(efm, tmp_path):
    """``--verify`` holds the tree to the port's model: a tree whose
    stage-3 1x1 conv has the wrong width fails it, and nothing is
    written."""
    args = dict(efm[2])
    args["conv3_r_weight"] = args["conv3_r_weight"][:, :-3]
    ckpt = str(tmp_path / "bad.params")
    jmx.write_mxnet_params(ckpt, args)
    with pytest.raises(SystemExit, match="does not load into the port"):
        tcli.main([ckpt, "--out-dir", str(tmp_path / "o"), "--verify",
                   "--device", "cpu"])
    assert not (tmp_path / "o").exists()
