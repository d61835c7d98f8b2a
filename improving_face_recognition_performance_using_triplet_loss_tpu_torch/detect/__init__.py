"""Face detection: the MTCNN detector with its host cascade, the batched
on-device cascade, dataset alignment, and 68-point ERT landmark
refinement."""

from .pipeline import MTCNNDetector, detect_faces  # noqa: F401
from .ert import (  # noqa: F401
    ShapePredictor,
    mtcnn_ert_detect,
    train_shape_predictor,
)
