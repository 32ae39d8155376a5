"""Vision models by name: counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py`` (``get_model`` :32):
one registry over all seven families, AlexNet, DenseNet (121, 161, 169,
201), Inception v3, MobileNet v1 and v2 (four widths each), ResNet v1
and v2 (18, 34, 50, 101, 152), SqueezeNet 1.0 and 1.1 and VGG (11, 13,
16, 19, with and without BatchNorm), with the JAX package's names,
prefixes and parameter names. ``pretrained=True`` raises
:class:`MXNetError`: the model store needs a download.
"""
# submodule imports precede the star imports: ``alexnet`` etc. name both a
# module and a constructor, and the constructor must win here
from . import alexnet as _a
from . import densenet as _d
from . import inception as _i
from . import mobilenet as _m
from . import resnet as _r
from . import squeezenet as _s
from . import vgg as _v
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

_models = {name: getattr(mod, name)
           for mod in (_a, _d, _i, _m, _r, _s, _v) for name in mod.__all__
           if callable(getattr(mod, name)) and name[0].islower()
           and not name.startswith("get_")}


def get_model(name, **kwargs):
    """Create a model of the zoo by its registry name."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"Model {name!r} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)


def get_model_names():
    """The registered constructors' names."""
    return sorted(_models)


__all__ = ["get_model", "get_model_names"] + sorted(_models)
