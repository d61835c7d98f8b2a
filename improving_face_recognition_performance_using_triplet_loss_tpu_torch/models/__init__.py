"""Models of the port: MTCNN PNet/RNet/ONet, the 342-d EFM symbol ladder,
LightCNN29 and LightCNN9 (with the LightCNN building blocks), DeepFace
(the JAX twin's ladder and the paper's), the BEGAN-CS generator and
autoencoder-discriminator, the linear triplet head, and
``model_by_name``, the embedding-net factory the CLIs share."""

import torch

from .began_cs import (  # noqa: F401
    AutoencoderDiscriminator,
    Decoder,
    Encoder,
    Generator,
)
from .deepface import DeepFace, LocallyConnected2D, build_deepface  # noqa: F401
from .efm_symbol import EFMNet342, build_efmnet342  # noqa: F401
from .heads import LinearHead  # noqa: F401
from .lightcnn import (  # noqa: F401
    EFMConv,
    EFMResBlock,
    FusedStem,
    LightCNN9,
    LightCNN29,
    build_lightcnn9,
    build_lightcnn29,
)
from .mtcnn import ONet, PNet, RNet  # noqa: F401

MODEL_NAMES = ("lightcnn29", "efmnet342", "lightcnn9", "deepface",
               "deepface_cvpr14")
# the nets that take 3 channels at 152x152 in the CLIs
RGB_MODELS = ("deepface", "deepface_cvpr14")


def model_by_name(name: str, num_classes: int, *, input_hw=(128, 128),
                  in_channels: int = 1, dtype: torch.dtype = torch.float32,
                  params: dict | None = None, batch_stats: dict | None = None,
                  share_weights: bool = False,
                  generator: torch.Generator | None = None, device=None):
    """The embedding net ``name`` for ``input_hw`` inputs, ready in eval
    mode on ``device`` (``cuda`` unless given) computing in ``dtype``: the
    port's copy of the JAX package's ``cli/train_backbone.py::
    _model_by_name``, with the weights made here (flax ``params`` and
    ``batch_stats`` loaded, else a random init from ``generator``).
    ``deepface`` (the JAX twin's ladder) and ``deepface_cvpr14`` (the
    paper's, which the JAX package cannot build) take 3 channels at
    152x152 in the CLIs: the caller passes them."""
    kw = dict(params=params, generator=generator, dtype=dtype, device=device)
    if name in RGB_MODELS:
        return build_deepface(num_classes, input_hw=input_hw,
                              in_channels=in_channels, ladder=name, **kw)
    if name == "efmnet342":
        if input_hw[0] != input_hw[1] or in_channels != 1:
            raise ValueError(f"efmnet342 takes square one-channel input, "
                             f"got {tuple(input_hw)} x {in_channels}")
        return build_efmnet342(num_classes, image_size=input_hw[0], **kw)
    if name == "lightcnn9":
        return build_lightcnn9(num_classes, input_hw=input_hw,
                               in_channels=in_channels, **kw)
    if name == "lightcnn29":
        return build_lightcnn29(num_classes, input_hw=input_hw,
                                in_channels=in_channels,
                                share_weights=share_weights,
                                batch_stats=batch_stats, **kw)
    raise ValueError(f"unknown model {name!r}; known: {MODEL_NAMES}")
