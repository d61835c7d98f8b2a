"""Live recognition service: queue -> detect -> embed -> match.

The port's own copy of the JAX package's ``serve/recognition.py``:
``embed_fn`` is any callable from a numpy batch to numpy embeddings, in the
port an extractor on the card (``cli/serve_demo.py``).

Reconstruction of the reference's C++ runtime loop (SURVEY.md §3.4):
a capture thread produces frames into the SPSC drop-stale queue
(LFQueue.hpp semantics via the native queue), the recognition loop consumes
the freshest frame, detects/crops the face, extracts the embedding with the
embedding net, and scans the persistent identity store with the AVX matcher
(Compare_Face_DB, Feature.hpp:792-804). Registration walks the native state
machine and enrolls deduped features (Register_DB*, Feature.hpp:453-667).
"""

from __future__ import annotations

import numpy as np

from .native import (NativeFrameQueue, NativeIdentityStore,
                     NativeStateMachine, native_select_representatives)


class RecognitionService:
    """Single-process identification + registration flow over the native
    primitives. ``embed_fn(images [B,H,W,C]) -> [B,D]`` is the embedding net."""

    def __init__(self, embed_fn, store_path: str, dim: int,
                 sim_threshold: float = 0.5, frame_shape=(128, 128, 1)):
        self.embed_fn = embed_fn
        self.store = NativeIdentityStore(store_path, dim)
        self.queue = NativeFrameQueue()
        self.sm = NativeStateMachine()
        self.sim_threshold = sim_threshold
        self.frame_shape = tuple(frame_shape)
        self._frame_len = int(np.prod(self.frame_shape))

    # capture side -------------------------------------------------------
    def push_frame(self, frame: np.ndarray, seq: int = 0) -> None:
        assert frame.shape == self.frame_shape, (frame.shape, self.frame_shape)
        self.queue.produce(frame.astype(np.float32).ravel(), seq)

    # recognition side ---------------------------------------------------
    def identify_latest(self):
        """Consume the freshest frame; returns (name|None, sim, seq)|None."""
        got = self.queue.consume(self._frame_len, remove_old=True)
        if got is None:
            return None
        flat, seq = got
        frame = flat.reshape(self.frame_shape)
        emb = np.asarray(self.embed_fn(frame[None]))[0]
        name, sim = self.store.match(emb, self.sim_threshold)
        return name, sim, seq

    # registration side --------------------------------------------------
    def register(self, name: str, frames: np.ndarray,
                 select_threshold: float = 0.98,
                 dedup_threshold: float = 0.99999) -> int:
        """Walk the enrollment state machine over candidate frames: embed
        all, select diverse representatives (clustering.h capability), and
        register them under ``name``. Returns # of stored features."""
        sm = self.sm
        sm.handle("start_registration")
        sm.handle("name_entered")
        sm.handle("countdown_done")
        embs = np.asarray(self.embed_fn(frames))
        sm.handle("images_acquired")
        selected = native_select_representatives(embs.astype(np.float32),
                                                 select_threshold)
        sm.handle("images_selected")
        sm.handle("details_entered")
        stored = 0
        for idx in selected:
            if self.store.register(name, embs[idx], dedup_threshold) >= 0:
                stored += 1
        sm.handle("feature_stored")
        sm.handle("tick")
        return stored

    def close(self):
        self.store.close()
        self.queue.close()
        self.sm.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
