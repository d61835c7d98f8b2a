"""Models of the serving slice: MTCNN PNet/RNet/ONet and the 342-d EFM
symbol ladder (with the LightCNN building blocks it uses)."""

from .efm_symbol import EFMNet342  # noqa: F401
from .lightcnn import EFMResBlock, FusedStem  # noqa: F401
from .mtcnn import ONet, PNet, RNet  # noqa: F401
