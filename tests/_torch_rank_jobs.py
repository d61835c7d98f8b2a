"""The jobs ``_torch_ranks.run_ranks`` runs on each gloo rank.

Each takes its payload (numpy inputs, weights as flax trees, settings) and
returns numpy results; the tests hold them to the JAX package's sharded
functions and to the port's world-1 runs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    parallel,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.losses.sharded import (
    class_parallel_argmax,
    class_parallel_softmax_ce,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.parallel import (
    collectives,
)


def _np(t):
    return t.detach().cpu().numpy()


def collectives_job(p):
    """The 2x2 mesh's layout and each collective's forward and backward
    on a known input."""
    mesh = parallel.make_2d_mesh(2)
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend(),
           "data": (parallel.axis_index(mesh, "data"),
                    parallel.axis_size(mesh, "data")),
           "model": (parallel.axis_index(mesh, "model"),
                     parallel.axis_size(mesh, "model")),
           "flat": (parallel.axis_index(mesh, None),
                    parallel.axis_size(mesh, None)),
           "block": parallel.local_block(np.arange(8), mesh, "data"),
           "model_block": parallel.local_block(np.arange(8), mesh, "model"),
           "info": parallel.process_info()}
    try:
        parallel.local_block(np.arange(3), mesh, "data")
    except ValueError as e:
        out["split_error"] = str(e)
    group = parallel.axis_group(mesh, "data")
    x = torch.full((2, 3), float(rank), requires_grad=True)
    y = collectives.all_gather_rows(x, group)
    # a weight that differs by rank: the backward must sum it over ranks
    w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
        * (rank + 1)
    (y * w).sum().backward()
    out["gathered"], out["gather_grad"] = _np(y), _np(x.grad)
    mgroup = parallel.axis_group(mesh, "model")
    x2 = torch.full((3,), float(rank + 1), requires_grad=True)
    (collectives.copy_to_model_group(x2, mgroup) * (rank + 1)).sum().backward()
    out["copy_grad"] = _np(x2.grad)
    x3 = torch.full((3,), float(rank + 1), requires_grad=True)
    s = collectives.all_reduce(x3, "sum", group)
    (s * 2).sum().backward()
    out["sum"], out["sum_grad"] = _np(s), _np(x3.grad)
    out["max"] = _np(collectives.all_reduce(torch.tensor([rank, -rank]),
                                            "max", group))
    out["min"] = _np(collectives.all_reduce(torch.tensor([rank, -rank]),
                                            "min", mgroup))
    out["pmean"] = float(collectives.pmean(torch.tensor(float(rank)),
                                           dist.group.WORLD))
    out["bools"] = _np(collectives.gather_rows(
        torch.tensor([rank % 2 == 0]), dist.group.WORLD))
    # the trap: an all-reduce whose backward reduces too
    import torch.distributed.nn.functional as dnn

    x4 = torch.full((3,), 1.0, requires_grad=True)
    dnn.all_reduce(x4, group=mgroup).sum().backward()
    out["trap_grad"] = _np(x4.grad)
    return out


def sharded_ce_job(p):
    """The class-parallel CE, its gradient and the argmax over a model
    axis of every rank (a 1 x world mesh)."""
    mesh = parallel.make_2d_mesh(dist.get_world_size())
    group = parallel.axis_group(mesh, "model")
    out = {}
    for key in ("ce", "argmax"):
        logits = torch.from_numpy(p[key]["logits"])
        labels = torch.from_numpy(p[key]["labels"])
        k, i = parallel.axis_size(mesh, "model"), parallel.axis_index(
            mesh, "model")
        c = logits.shape[1] // k
        local = logits[:, i * c:(i + 1) * c].clone().requires_grad_(True)
        loss = class_parallel_softmax_ce(local, labels, group)
        loss.backward()
        out[key] = {"loss": float(loss), "grad": _np(local.grad),
                    "argmax": _np(class_parallel_argmax(local, group))}
    return out


# ----------------------------------------------------------------- train

def _train():
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
        train,
    )

    return train


def _keep_grads(state, sink: list):
    """Append a copy of every parameter's gradient to ``sink`` before
    each update of ``state``."""
    update = state.apply_update

    def apply_update():
        sink.append({n: _np(q.grad) for n, q in
                     state.model.named_parameters() if q.grad is not None})
        update()

    state.apply_update = apply_update


def _metrics(m):
    return {k: _np(v) for k, v in m.items()}


def head_dp_job(p):
    """The head's train and eval steps over a data mesh of every rank,
    fed each rank's block of the global batches."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        head_from_jax_params,
    )

    train = _train()
    mesh = parallel.make_mesh()
    state = train.create_train_state(
        head_from_jax_params(p["params"], device="cpu"),
        train.sgd_wd(lr=p["lr"]), 0)
    grads: list = []
    _keep_grads(state, grads)
    step = train.shard_map_step(
        train.make_head_train_step(mining_mode=p["mode"], axis_name="data"),
        mesh, has_state_out=True, metric_keys=train.HEAD_METRIC_KEYS)
    ev = train.shard_map_step(
        train.make_head_eval_step(mining_mode=p["mode"], axis_name="data"),
        mesh, has_state_out=False, metric_keys=train.HEAD_METRIC_KEYS)
    first_eval = _metrics(ev(state, *[parallel.local_block(x, mesh)
                                      for x in p["batches"][0]]))
    out = []
    for batch in p["batches"]:
        local = [parallel.local_block(x, mesh) for x in batch]
        state, m = step(state, *local)
        out.append(_metrics(m))
    return {"metrics": out, "eval": first_eval, "grads": grads}


class TinyNet(torch.nn.Module):
    """The JAX class-parallel test's dropout- and BN-free net: ``fc1``
    (tanh) is the feature, ``fc2`` the logits."""

    def __init__(self, params):
        super().__init__()
        k1, k2 = (np.asarray(params[n]["kernel"]) for n in ("fc1", "fc2"))
        self.fc1 = torch.nn.Linear(*k1.shape)
        self.fc2 = torch.nn.Linear(*k2.shape)
        with torch.no_grad():
            for layer, name in ((self.fc1, "fc1"), (self.fc2, "fc2")):
                layer.weight.copy_(torch.from_numpy(
                    np.asarray(params[name]["kernel"]).T.copy()))
                layer.bias.copy_(torch.from_numpy(
                    np.asarray(params[name]["bias"])))

    def embed(self, x):
        return torch.tanh(self.fc1(x.reshape(x.shape[0], -1)))

    def classify(self, feat):
        return self.fc2(feat), feat

    def forward(self, x):
        return self.classify(self.embed(x))


def class_parallel_tiny_job(p):
    """One 2-D (data 2 x model 2) step of the tiny net, its whole weights
    after it, and three scanned steps against three single ones."""
    train = _train()
    mesh = parallel.make_2d_mesh(2)
    specs = train.infer_class_parallel_specs(TinyNet(p["params"]),
                                             p["classes"], "model")
    shards = train.ClassShards(specs, mesh)

    def fresh():
        model = shards.shard_model_(TinyNet(p["params"]))
        return train.create_train_state(
            model, train.OptimizerSpec(lr=0.1, weight_decay=0.0), 0)

    raw = train.make_backbone_train_step(mining_mode="hard",
                                         axis_name="data",
                                         class_axis_name="model")
    step = train.shard_map_step_2d(raw, mesh, specs, has_state_out=True)
    a, pos, lab = (parallel.local_block(x, mesh, "data")
                   for x in p["batch"])
    state, m = step(fresh(), a, pos, lab)
    whole = shards.full_model(state.model)
    out = {"specs": specs, "metrics": _metrics(m),
           "fc1": _np(whole.fc1.weight), "fc2": _np(whole.fc2.weight),
           "fc2_local": tuple(state.model.fc2.weight.shape)}
    seq, losses = fresh(), []
    for i in range(3):
        seq, m = step(seq, *(parallel.local_block(x[i], mesh, "data")
                             for x in p["chunk"]))
        losses.append(float(m["loss"]))
    scanned = train.shard_map_scanned_step_2d(raw, mesh, specs)
    st, ms = scanned(fresh(), *(np.stack([parallel.local_block(
        x[i], mesh, "data") for i in range(3)]) for x in p["chunk"]))
    out.update(seq_losses=losses, scan_losses=_np(ms["loss"]),
               scan_pos_cos=ms["pos_cos"].shape, scan_step=st.step,
               seq_equal_scan=all(torch.equal(u, v) for u, v in zip(
                   seq.model.parameters(), st.model.parameters())))
    return out


def _real_model(p, **kw):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.lightcnn import (
        Dropout,
    )

    model = model_by_name(p["model"], p["classes"],
                          input_hw=(p["size"], p["size"]),
                          params=p.get("params"),
                          batch_stats=p.get("batch_stats"),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu", **kw)
    if p.get("no_dropout"):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


def backbone_parallel_job(p):
    """Backbone train steps of a real net, data-parallel (``model_size``
    0) or class-parallel over a (data, model_size) mesh: each step's
    metrics and gradients (``fc2``'s gathered whole), and the BatchNorm
    running statistics after the last."""
    train = _train()
    model = _real_model(p)
    m_size = p.get("model_size", 0)
    mesh = (parallel.make_2d_mesh(m_size) if m_size
            else parallel.make_mesh())
    shards = None
    if m_size:
        specs = train.infer_class_parallel_specs(model, p["classes"],
                                                 "model")
        shards = train.ClassShards(specs, mesh)
        shards.shard_model_(model)
    state = train.create_train_state(
        model, train.backbone_optimizer("sgd", base_lr=p["lr"],
                                        decay_every_steps=1000), 0)
    grads: list = []
    _keep_grads(state, grads)
    raw = train.make_backbone_train_step(
        mining_mode=p["mode"], margin=p.get("margin", 0.2),
        axis_name="data", class_axis_name="model" if m_size else None)
    step = (train.shard_map_step_2d(raw, mesh, shards.specs,
                                    has_state_out=True) if m_size
            else train.shard_map_step(raw, mesh, has_state_out=True))
    out = []
    for batch in p["batches"]:
        state, m = step(state, *(parallel.local_block(x, mesh, "data")
                                 for x in batch))
        out.append(_metrics(m))
    if m_size:
        group = parallel.axis_group(mesh, "model")
        for g in grads:
            for name in shards.specs:
                g[name] = _np(collectives.gather_rows(
                    torch.from_numpy(g[name]), group))
    stats = (state.model.flax_batch_stats()
             if hasattr(state.model, "flax_batch_stats") else None)
    return {"metrics": out, "grads": grads, "batch_stats": stats}


def gan_dp_job(p):
    """One data-parallel BEGAN-CS step with this rank's ``z``."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.began_cs import (
        AutoencoderDiscriminator,
        Generator,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train.gan import (
        create_gan_state,
        make_began_cs_train_step,
        shard_map_gan_step,
    )

    train = _train()
    size, n, h = p["size"], p["filters"], p["h_dim"]
    gen = Generator(size, 3, n, h).load_flax_params(p["gen_params"])
    disc = AutoencoderDiscriminator(size, 3, n, h).load_flax_params(
        p["disc_params"])
    sgd = train.OptimizerSpec(lr=p["lr"], weight_decay=0.0)
    state = create_gan_state(gen, disc, sgd, sgd, 0)
    mesh = parallel.make_mesh()
    step = shard_map_gan_step(make_began_cs_train_step(
        h_dim=h, mining_mode=p["mode"], triplet_margin=2.0,
        axis_name="data"), mesh)
    z = p["z"][dist.get_rank()]
    state, m = step(state, *(parallel.local_block(x, mesh)
                             for x in p["batch"]), z=z)
    return {"metrics": _metrics(m),
            "disc_grads": {k: _np(q.grad) for k, q in
                           state.discriminator.named_parameters()},
            "gen_grads": {k: _np(q.grad) for k, q in
                          state.generator.named_parameters()}}


def streaming_shards_job(p):
    """The rows ``train_backbone``'s batcher gives this data rank of an
    mmap store."""
    import argparse

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        train_backbone,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        load_image_store_mmap,
    )

    images, labels = load_image_store_mmap(p["store"])
    args = argparse.Namespace(seed=0, shuffle_window=p["window"])
    rank, world = parallel.process_info()
    batcher = train_backbone.make_batcher(images, labels, p["batch"], args,
                                          True, rank, world)
    inner = getattr(batcher, "batcher", batcher)
    seen, sizes = [], []
    for epoch in range(2):
        for a, _, lab in batcher:
            sizes.append(a.shape[0])
            seen.append(np.asarray(lab))
    return {"bounds": (inner.start, inner.stop), "sizes": sizes,
            "labels": np.concatenate(seen), "steps": len(sizes) // 2}


def cli_job(p):
    """CLIs' ``main(argv)`` on every rank (``clis[i]`` runs ``argvs[i]``,
    else ``cli`` runs each); what each returned."""
    import importlib

    out = []
    for i, argv in enumerate(p["argvs"]):
        name = p["clis"][i] if "clis" in p else p["cli"]
        cli = importlib.import_module(
            "improving_face_recognition_performance_using_triplet_loss_"
            f"tpu_torch.cli.{name}")
        result = cli.main(argv)
        if name in ("train_head", "train_backbone"):
            _, hist = result
            out.append([{"train": h.train, "valid": h.valid,
                         "steps": [s["loss"] for s in h.steps]}
                        for h in hist])
        elif name == "train_began":
            out.append(list(result[1]))
        else:
            out.append({k: (v.features, v.preds) for k, v in result.items()})
    return out


def cp_resume_job(p):
    """Class-parallel tiny-net steps under Adam over a 1 x world mesh:
    save after two, continue one (the oracle), restore into a state
    built from other weights, take the same step; the saved file's fc2
    and moments are whole."""
    import os

    train = _train()
    mesh = parallel.make_2d_mesh(dist.get_world_size())
    specs = train.infer_class_parallel_specs(TinyNet(p["params"]),
                                             p["classes"], "model")
    shards = train.ClassShards(specs, mesh)

    def fresh(params):
        model = shards.shard_model_(TinyNet(params))
        return train.create_train_state(model, train.adam(1e-3), 0)

    step = train.shard_map_step_2d(
        train.make_backbone_train_step(mining_mode="hard", axis_name="data",
                                       class_axis_name="model"),
        mesh, specs, has_state_out=True)
    batch = p["batch"]
    state = fresh(p["params"])
    for _ in range(2):
        state, _ = step(state, *batch)
    ckpt = train.Checkpointer(os.path.join(p["tmp"], "ckpt"), shards=shards)
    ckpt.save(2, state)
    dist.barrier()
    cont, cont_m = step(state, *batch)
    zeros = {k: {n: np.zeros_like(v) for n, v in leaf.items()}
             for k, leaf in p["params"].items()}
    restored = ckpt.restore(fresh(zeros))
    restored_step = restored.step
    res, res_m = step(restored, *batch)
    blob = torch.load(os.path.join(p["tmp"], "ckpt", "2", "state.pt"),
                      weights_only=True)
    return {"step": restored_step,
            "loss_equal": bool(torch.equal(res_m["loss"], cont_m["loss"])),
            "params_equal": all(torch.equal(u, v) for u, v in zip(
                res.model.parameters(), cont.model.parameters())),
            "file_fc2": tuple(blob["model"]["fc2.weight"].shape),
            "file_moments": sorted(
                tuple(v.shape) for st in blob["optimizer"]["state"].values()
                for v in st.values() if getattr(v, "ndim", 0) == 2),
            "local_fc2": tuple(res.model.fc2.weight.shape)}


# ----------------------------------------------------------------- serve

def extract_job(p):
    """``extract_features(data_parallel=True)`` and the sharded extract
    function of a net from flax params, f32 and int8."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
        extract_features,
        make_sharded_extract_fn,
    )

    model = _real_model(p)
    out = {}
    for int8 in (False, True):
        feats, _, acc, preds = extract_features(
            model, p["images"], p["labels"], batch_size=p["batch"],
            data_parallel=True, int8=int8)
        out[int8] = (feats, acc, preds)
    logits, feat = make_sharded_extract_fn(model)(
        torch.from_numpy(p["images"][:p["batch"]]))
    out["fn"] = (_np(logits), _np(feat))
    try:
        extract_features(model, p["images"], batch_size=3,
                         data_parallel=True)
    except ValueError as e:
        out["error"] = str(e)
    return out


def gallery_job(p):
    """``match_gallery_sharded`` over a 1-D mesh of every rank."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.gallery import (
        match_gallery_sharded,
    )

    return match_gallery_sharded(p["gallery"], p["queries"], p["sim_th"],
                                 device="cpu")


def _serving_nets(p):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        from_jax_params,
    )

    return (MTCNNDetector(*p["det_params"], device="cpu"),
            from_jax_params(p["params"], device="cpu"))


def pipelines_job(p):
    """Both sharded pipelines over the frames, and the stream-count
    error."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        pipeline,
    )

    det, model = _serving_nets(p)
    kw = dict(p["kw"], device="cpu")
    out = {}
    fn = pipeline.make_sharded_multistream_pipeline(
        det, model, p["gallery"], parallel.make_mesh(), **kw)
    out["sharded"] = _metrics(fn(p["frames"]))
    try:
        fn(p["frames"][:3])
    except ValueError as e:
        out["error"] = str(e)
    mesh = parallel.make_2d_mesh(dist.get_world_size())
    gal_n, rows = pipeline.shard_gallery(p["gallery"], mesh, device="cpu")
    gkw = {k: v for k, v in kw.items() if k != "device"}
    gfn = pipeline.make_gallery_sharded_multistream_pipeline(
        det, model, mesh, device="cpu", **gkw)
    out["gallery_sharded"] = _metrics(gfn(p["frames"], gal_n, rows))
    out["block"] = _np(gal_n)
    try:
        gfn(p["frames"][:3], gal_n, rows)
    except ValueError as e:
        out["gallery_error"] = str(e)
    return out


def device_gallery_job(p):
    """A row-sharded ``DeviceGallery`` through every mutation and a
    doubling, per dtype: each step's rows, capacity, this rank's block
    and the whole gallery."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.device_gallery import (
        DeviceGallery,
    )

    mesh = parallel.make_2d_mesh(dist.get_world_size())
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8)):
        dg = DeviceGallery(dim=p["dim"], capacity=3, initial=p["initial"],
                           mesh=mesh, dtype=dtype, device="cpu")
        trace = []

        def snap():
            trace.append({"rows": dg.rows, "capacity": dg.capacity,
                          "block": _np(dg.gallery_n.float()).copy(),
                          "host": dg.to_host().copy(),
                          "rows_arg": int(dg.rows_arg)})

        snap()
        for v in p["adds"]:
            dg.add(v)
            snap()
        dg.set_row(1, p["adds"][0])
        dg.clear_row(2)
        snap()
        out[name] = trace
    return out


def service_job(p):
    """``PersonGalleryService(mesh=...)`` over one store: cold start,
    enroll, add_face, retire, refresh, each followed by a
    ``match_batch``."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        gallery_service,
        person_store,
    )

    mesh = parallel.make_2d_mesh(dist.get_world_size())
    feats, labels, probes = p["feats"], p["labels"], p["probes"]
    out = []
    with person_store.PersonStore(p["store"], feats.shape[1]) as store:
        svc = gallery_service.PersonGalleryService(
            store, capacity=4, mesh=mesh, device="cpu")

        def who():
            out.append([(r.person.name if r.person else None,
                         round(float(r.similarity), 6), r.fid)
                        for r in svc.match_batch(probes, sim_th=0.5)])

        who()
        out.append(svc.enroll(person_store.Person(name="p3"),
                              list(feats[labels == 3])))
        out.append(svc.add_face(1, feats[labels == 4][0]))
        who()
        out.append(svc.retire_person(2))
        who()
        svc.refresh()
        who()
        out.append((svc.rows, svc._dg.capacity))
    return out
