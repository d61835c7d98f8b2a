"""Pack a class-per-directory image tree into an image store, streaming.

The port's ``pack_dataset``, a copy of the JAX package's (numpy and cv2
only): walk ``input_dir/<class>/*`` in sorted order, decode, convert to
grayscale (or keep RGB with ``--color``) and resize on a cv2 thread pool,
and write a uint8 ``.npz`` store, or with ``--mmap`` stream the crops into
the memory-mapped store (``images.npy`` + ``labels.npy``) with O(batch)
memory. ``--train-frac`` also writes train / test splits by identity, the
first fraction of identities (sorted order) to train. cv2 is imported only
when images are decoded. Runs on the CPU; nothing here touches the card.

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.pack_dataset \\
        tree/ store/ --mmap --train-frac 0.7
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

_DECODE_CHUNK = 512  # images per writer append; bounds resident memory


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_dir", help="class-per-directory image tree")
    p.add_argument("output", help="output .npz path (or directory with "
                                  "--mmap)")
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--color", action="store_true",
                   help="keep RGB (default grayscale, reference channel=1)")
    p.add_argument("--mmap", action="store_true",
                   help="stream into mmap-able .npy store for Celeb1M-scale "
                        "sets (constant RAM)")
    p.add_argument("--train-frac", type=float,
                   help="also write <output>_train/<output>_test splits by "
                        "identity at this fraction")
    p.add_argument("--workers", type=int, default=0,
                   help="decode threads (0 = cpu count; reference uses 14 "
                        "RecordIO preprocess threads)")
    return p


def list_image_tree(input_dir: str) -> tuple[list[tuple[str, int]], list[str]]:
    """(path, class_id) entries in sorted-directory/sorted-file order, plus
    class names. Only directory listings — no image IO."""
    entries, names = [], []
    for cls in sorted(os.listdir(input_dir)):
        cdir = os.path.join(input_dir, cls)
        if not os.path.isdir(cdir):
            continue
        cls_id = len(names)
        names.append(cls)
        for fname in sorted(os.listdir(cdir)):
            entries.append((os.path.join(cdir, fname), cls_id))
    return entries, names


def _make_decoder(image_size: int, color: bool):
    import cv2

    def decode(path: str):
        img = cv2.imread(path)
        if img is None:
            return None
        if color:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[..., None]
        img = cv2.resize(img, (image_size, image_size),
                         interpolation=cv2.INTER_AREA)
        return img[..., None] if img.ndim == 2 else img

    return decode


def iter_decoded(entries, image_size: int, color: bool, workers: int):
    """Yield ``(image_or_None, class_id)`` in entry order, decoding on a
    bounded thread pool (in-flight window = 4x workers, so millions of
    pending futures never accumulate)."""
    decode = _make_decoder(image_size, color)
    workers = workers or min(os.cpu_count() or 4, 16)
    window = 4 * workers
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = []
        it = iter(entries)
        for path, cls_id in it:
            pending.append((ex.submit(decode, path), cls_id))
            if len(pending) >= window:
                fut, cid = pending.pop(0)
                yield fut.result(), cid
        for fut, cid in pending:
            yield fut.result(), cid


class _ChunkedWriter:
    """Buffer decoded images and flush to an ImageStoreWriter per chunk."""

    def __init__(self, writer):
        self.writer = writer
        self._imgs: list = []
        self._labs: list = []

    def add(self, img, label: int) -> None:
        self._imgs.append(img)
        self._labs.append(label)
        if len(self._imgs) >= _DECODE_CHUNK:
            self.flush()

    def flush(self) -> None:
        if self._imgs:
            import numpy as np

            self.writer.append(np.asarray(self._imgs, np.uint8),
                               np.asarray(self._labs, np.int64))
            self._imgs, self._labs = [], []


def pack_tree(input_dir: str, image_size: int, color: bool, workers: int = 0):
    """Small-set path: decode the whole tree into RAM (streamed decode, one
    final materialization). Use ``--mmap`` for large sets."""
    import numpy as np

    entries, names = list_image_tree(input_dir)
    images, labels = [], []
    skipped = 0
    for img, cls_id in iter_decoded(entries, image_size, color, workers):
        if img is None:
            skipped += 1
            continue
        images.append(img)
        labels.append(cls_id)
    if not images:
        raise SystemExit(f"no decodable images under {input_dir}")
    return (np.asarray(images, np.uint8), np.asarray(labels, np.int64),
            names, skipped)


def pack_tree_streaming(
    input_dir: str,
    output: str,
    image_size: int,
    color: bool,
    workers: int = 0,
    train_frac: float | None = None,
) -> tuple[int, int, int]:
    """Stream the tree into mmap store(s) with constant RAM.

    Returns (n_packed, n_classes, n_skipped). With ``train_frac``, the first
    ``frac`` of identities (sorted order = first-seen, slice_celeb1m.py:49-80)
    go to ``<output>_train/``, the rest to ``<output>_test/``, alongside the
    full store at ``output``.
    """
    from ..data.records import ImageStoreWriter

    entries, names = list_image_tree(input_dir)
    if not entries:
        raise SystemExit(f"no class directories under {input_dir}")
    channels = 3 if color else 1
    shape = (image_size, image_size, channels)
    n_train_ids = (int(len(names) * train_frac)
                   if train_frac is not None else None)

    writers = {"all": _ChunkedWriter(ImageStoreWriter(output, shape))}
    if n_train_ids is not None:
        writers["train"] = _ChunkedWriter(
            ImageStoreWriter(output.rstrip("/") + "_train", shape))
        writers["test"] = _ChunkedWriter(
            ImageStoreWriter(output.rstrip("/") + "_test", shape))

    skipped = 0
    for img, cls_id in iter_decoded(entries, image_size, color, workers):
        if img is None:
            skipped += 1
            continue
        writers["all"].add(img, cls_id)
        if n_train_ids is not None:
            split = "train" if cls_id < n_train_ids else "test"
            writers[split].add(img, cls_id)
    for w in writers.values():
        w.flush()
        w.writer.close()

    with open(os.path.join(output, "classes.json"), "w") as f:
        json.dump({"classes": names}, f)
    return writers["all"].writer.count, len(names), skipped


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from ..data.feature_store import split_identities
    from ..data.records import save_image_store

    if args.mmap:
        n, n_cls, skipped = pack_tree_streaming(
            args.input_dir, args.output, args.image_size, args.color,
            workers=args.workers, train_frac=args.train_frac)
        print(f"packed {n} images / {n_cls} identities "
              f"({skipped} skipped) -> {args.output} [streaming mmap]")
        return n, n_cls

    images, labels, names, skipped = pack_tree(
        args.input_dir, args.image_size, args.color, args.workers)
    save_image_store(args.output, images, labels)
    meta_path = os.path.splitext(args.output)[0] + ".classes.json"
    with open(meta_path, "w") as f:
        json.dump({"classes": names}, f)
    print(f"packed {images.shape[0]} images / {len(names)} identities "
          f"({skipped} skipped) -> {args.output}")

    if args.train_frac:
        train_mask, test_mask = split_identities(labels, args.train_frac)
        base = os.path.splitext(args.output)[0]
        save_image_store(base + "_train.npz", images[train_mask],
                         labels[train_mask])
        save_image_store(base + "_test.npz", images[test_mask],
                         labels[test_mask])
        print(f"splits: {int(train_mask.sum())} train / "
              f"{int(test_mask.sum())} test rows (by identity)")
    return images.shape[0], len(names)


if __name__ == "__main__":
    main()
