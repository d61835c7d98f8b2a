"""Import a reference MXNet checkpoint into a standard export.

The port's ``import_params``, with the JAX package's flags plus
``--device``. Both reference training artifacts import (auto-detected by
key layout):
- ``EFM_RES.json`` + ``.params`` — the symbol checkpoint the extraction and
  C++ serving stack consume (extract_feacture_v2.py:45-51,
  Feature.hpp:213-219) -> EFMNet342 export.
- ``efm_res-NNNN.params`` from train_efm.py:289 — the gluon LightCNN_29
  ``save_parameters`` file (structural dot names; its shared res convs are
  expanded into the standard distinct-weights tree, an identical forward)
  -> LightCNN29 export incl. the BatchNorm running stats.

Reads the ``.params`` binary without mxnet (``utils/mxnet_import.py``) and
writes the export (``weights.npz`` + ``manifest.json``) that every CLI of
both packages reads: ``extract_features --export-dir``, ``lfw_eval``,
``lfw_run``, ``serve_demo``. ``--verify`` builds the port's model from the
imported tree (``serve/convert.py::from_jax_params``), checks the tree's
shapes against it and runs one forward on the card (or ``--device``).

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.import_params \\
        EFM_RES-0280.params --out-dir runs/imported/export --verify
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("params", help="MXNet .params file (EFM symbol layout)")
    p.add_argument("--out-dir", required=True,
                   help="export directory to write (weights.npz + manifest)")
    p.add_argument("--symbol", help="optional EFM_RES.json: cross-check "
                                    "the graph against the expected "
                                    "EFM-symbol architecture before "
                                    "importing")
    p.add_argument("--verify", action="store_true",
                   help="after import, build the port's model from the "
                        "tree, check its shapes and run one forward")
    p.add_argument("--device", default=None,
                   help="torch device of --verify's forward (default cuda; "
                        "'cpu' runs the plain PyTorch path)")
    return p


def _shapes(tree) -> dict:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def verify(params, batch_stats, size: int, device) -> tuple:
    """Build the port's model from the imported tree, hold the tree's
    shapes to the model's own flax tree, run one forward of a zero image;
    returns ``(logits shape, feature shape)``."""
    import numpy as np
    import torch

    from ..serve.convert import from_jax_params

    tree = {"params": params}
    if batch_stats:
        tree["batch_stats"] = batch_stats
    try:
        model = from_jax_params(tree, device=device, input_hw=(size, size))
    except (RuntimeError, KeyError) as e:   # a weight of the wrong shape
        raise SystemExit(f"imported tree does not load into the port's "
                         f"model: {e}") from e
    ref_shapes = _shapes(model.flax_params())
    got_shapes = _shapes(params)
    if ref_shapes != got_shapes:
        raise SystemExit(f"imported tree shape mismatch:\n"
                         f"expected {ref_shapes}\ngot {got_shapes}")
    with torch.no_grad():
        logits, feat = model(torch.zeros((1, size, size, 1),
                                          dtype=torch.float32, device=device))
    out = tuple(logits.shape), tuple(feat.shape)
    if not (np.isfinite(logits.cpu().numpy()).all()
            and np.isfinite(feat.cpu().numpy()).all()):
        raise SystemExit("verify: the forward gave non-finite values")
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..device import full_f32, resolve_device
    from ..serve.export import export_params
    from ..utils.mxnet_import import (expand_shared_res, infer_input_size,
                                      is_gluon_lightcnn29,
                                      map_efm_params,
                                      map_gluon_lightcnn29,
                                      read_mxnet_params,
                                      validate_symbol_json)

    if args.verify:
        full_f32()
        device = resolve_device(args.device)
    if args.symbol:
        validate_symbol_json(args.symbol)
        print(f"symbol graph validated: {args.symbol}")
    mx_args, mx_aux = read_mxnet_params(args.params)
    print(f"read {len(mx_args)} arg + {len(mx_aux)} aux arrays")
    batch_stats = None
    if is_gluon_lightcnn29(mx_args):
        params, batch_stats = map_gluon_lightcnn29(mx_args, mx_aux)
        params = expand_shared_res(params)
        merged = dict(mx_args)
        merged.update(mx_aux)
        hw = merged["conv_net.15.weight"].shape[1] // 174
        size = int(round(hw ** 0.5)) * 32
        num_classes = int(merged["fc2.1.weight"].shape[0])
        model_name, feature_dim = "lightcnn29", 684
        print(f"gluon LightCNN_29 checkpoint: input {size}x{size} "
              f"grayscale, {num_classes} classes, 684-d feature "
              f"(shared res convs expanded)")
    else:
        params = map_efm_params(mx_args)
        size = infer_input_size(mx_args)
        num_classes = int(mx_args["fc2_weight"].shape[0])
        model_name, feature_dim = "efmnet342", 342
        print(f"EFM symbol checkpoint: input {size}x{size} grayscale, "
              f"{num_classes} classes, 342-d feature")

    if args.verify:
        logits, feat = verify(params, batch_stats, size, device)
        print(f"verify: forward OK, logits {logits}, feature {feat}")

    export_params(args.out_dir, params, model_name=model_name,
                  feature_dim=feature_dim, input_hw=(size, size),
                  input_channels=1, batch_stats=batch_stats,
                  extra={"imported_from": "mxnet_params"})
    print(f"export written: {args.out_dir}")
    return params


if __name__ == "__main__":
    main()
