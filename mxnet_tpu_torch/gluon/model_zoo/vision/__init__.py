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


# MXNet 1.x's registry names of the models the JAX registry names after
# their constructors (``get_model_names()`` stays the JAX list)
_MXNET_NAMES = {"inceptionv3": "inception_v3",
                "squeezenet1.0": "squeezenet1_0",
                "squeezenet1.1": "squeezenet1_1"}
for _w in ("1.0", "0.75", "0.5", "0.25"):
    _MXNET_NAMES["mobilenet" + _w] = "mobilenet" + _w.replace(".", "_")
    _MXNET_NAMES["mobilenetv2_" + _w] = "mobilenet_v2_" + _w.replace(".", "_")


def get_model(name, **kwargs):
    """Create a model of the zoo by its registry name, or by MXNet 1.x's
    name for it (``inceptionv3``, ``mobilenet1.0``, ``mobilenetv2_0.5``,
    ``squeezenet1.1``, ...)."""
    name = name.lower()
    name = _MXNET_NAMES.get(name, name)
    if name not in _models:
        raise ValueError(
            f"Model {name!r} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)


def get_model_names():
    """The registered constructors' names."""
    return sorted(_models)


__all__ = ["get_model", "get_model_names"] + sorted(_models)
