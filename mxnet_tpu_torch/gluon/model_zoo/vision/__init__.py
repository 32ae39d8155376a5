"""Vision models by name: counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py`` (``get_model`` :32).

Ported: ResNet v1 and v2 at every depth of ``resnet_spec`` (18, 34, 50,
101, 152). The other families of the JAX package's registry (AlexNet,
DenseNet, Inception v3, MobileNet v1/v2, SqueezeNet, VGG) raise
:class:`MXNetError` by name, and so does ``pretrained=True``: the model
store needs a download.
"""
from ....base import MXNetError
from . import resnet as _r
from .resnet import *  # noqa: F401,F403

_models = {name: getattr(_r, name) for name in _r.__all__
           if name[0].islower() and not name.startswith("get_")}

# the JAX package's other constructors, not ported yet
_NOT_PORTED = (
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "inception_v3", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
    "mobilenet0_25", "mobilenet_v2_1_0", "mobilenet_v2_0_75",
    "mobilenet_v2_0_5", "mobilenet_v2_0_25", "squeezenet1_0",
    "squeezenet1_1", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
    "vgg13_bn", "vgg16_bn", "vgg19_bn")


def get_model(name, **kwargs):
    """Create a model of the zoo by its registry name."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError(f"model {name!r} is not ported to mxnet_tpu_torch "
                         "yet (only the ResNet family); see ROADMAP.md "
                         "section A")
    if name not in _models:
        raise ValueError(
            f"Model {name!r} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)


def get_model_names():
    """The ported constructors' names."""
    return sorted(_models)


__all__ = ["get_model", "get_model_names"] + sorted(_models)
