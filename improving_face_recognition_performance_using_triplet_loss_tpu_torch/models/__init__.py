"""Models of the port: MTCNN PNet/RNet/ONet, the 342-d EFM symbol ladder
(with the LightCNN building blocks it uses) and the linear triplet head."""

from .efm_symbol import EFMNet342  # noqa: F401
from .heads import LinearHead  # noqa: F401
from .lightcnn import EFMResBlock, FusedStem  # noqa: F401
from .mtcnn import ONet, PNet, RNet  # noqa: F401
