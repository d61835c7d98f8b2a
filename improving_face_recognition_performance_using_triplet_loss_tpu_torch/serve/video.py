"""Video ingest: cv2 capture thread -> native drop-stale queue.

The port's own copy of the JAX package's ``serve/video.py`` (cv2 and
numpy only).

The reference's camera loop is ``StreamLoop(camera, queue, shutdown)``
(CameraSettings.h:21) — a producer thread pushing frames into the 1P1C
queue while the recognition loop consumes the freshest. ``VideoProducer``
is that thread over ``cv2.VideoCapture`` (device index or a recorded file,
which doubles as the CI fixture), normalizing frames to the service's
grayscale frame shape.
"""

from __future__ import annotations

import threading


class VideoProducer:
    """Producer thread: VideoCapture -> RecognitionService.push_frame.

    Args:
      source: cv2.VideoCapture source — an int camera index or a file path.
      service: a RecognitionService (defines frame_shape and the queue).
      fps_cap: sleep between reads when the source is a file, so a short
        fixture doesn't flood the queue in one scheduler quantum (live
        cameras pace themselves). 0 disables.
      loop: rewind files at EOF until stop() (live-camera simulation).
    """

    def __init__(self, source, service, *, fps_cap: float = 0.0,
                 loop: bool = False):
        self.source = source
        self.service = service
        self.fps_cap = fps_cap
        self.loop = loop
        self.frames_pushed = 0
        self.finished = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _normalize(self, frame):
        import cv2
        import numpy as np

        h, w, c = self.service.frame_shape
        if frame.ndim == 3 and c == 1:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        elif frame.ndim == 3 and c == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)
        if frame.ndim == 2:
            frame = frame[..., None]
        return frame.astype(np.float32) / 255.0

    def _run(self):
        import time

        import cv2

        cap = cv2.VideoCapture(self.source)
        try:
            if not cap.isOpened():
                raise RuntimeError(f"cannot open video source {self.source}")
            while not self._stop.is_set():
                ok, frame = cap.read()
                if not ok:
                    if self.loop and self.frames_pushed:
                        cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                        continue
                    break
                self.service.push_frame(self._normalize(frame),
                                        seq=self.frames_pushed)
                self.frames_pushed += 1
                if self.fps_cap > 0:
                    time.sleep(1.0 / self.fps_cap)
        finally:
            cap.release()
            self.finished.set()

    def start(self) -> "VideoProducer":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def write_test_video(path: str, frames, fps: int = 10) -> int:
    """Encode uint8 frames ([N, H, W] gray or [N, H, W, 3] RGB) into an
    MJPG .avi — the recorded-file CI fixture. Returns frames written."""
    import cv2
    import numpy as np

    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError("cv2.VideoWriter failed to open (MJPG/avi)")
    for f in frames:
        if f.ndim == 2 or f.shape[-1] == 1:
            f = cv2.cvtColor(f.reshape(h, w), cv2.COLOR_GRAY2BGR)
        else:
            f = cv2.cvtColor(f, cv2.COLOR_RGB2BGR)
        vw.write(f)
    vw.release()
    return int(frames.shape[0])
