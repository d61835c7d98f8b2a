"""Tiny forms of the benchmark's configurations and cells, for the CPU
tests: the same code and the same keys at sizes a test run holds."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def serve():
    cfg = _load("configs", "efm342_mtcnn.json")
    cfg["frame_hw"] = [48, 64]
    cfg["embed"]["image_size"] = 32
    cfg["embed"]["num_classes"] = 10
    cfg["gallery_rows"] = 50
    t = _load("workloads", "serve-efm342-s64.json")
    t.update(streams=2, pool_dispatches=4, warmup=1, check_within=2,
             check_dispatches=2, trace_steps=1)
    return cfg, t


def lightcnn29():
    cfg = _load("configs", "lightcnn29.json")
    cfg["input_hw"] = [32, 32]
    cfg["num_classes"] = 40
    return cfg


def extract():
    t = _load("workloads", "extract-lightcnn29-b128.json")
    t.update(batch_size=4, store_rows=8, check_rows=8)
    return lightcnn29(), t


def train():
    t = _load("workloads", "train-lightcnn29-p64.json")
    t.update(pairs=4, identities=6, images_per_identity=2)
    return lightcnn29(), t


CELLS = {"serve": serve, "extract": extract, "train": train}


def cell(kind):
    return copy.deepcopy(CELLS[kind]())
