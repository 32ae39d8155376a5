"""AlexNet: counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``
(the same stage table, prefixes and parameter names; its two Dropout
layers draw from ``mx.random``'s generator in train mode).
``pretrained=True`` raises :class:`MXNetError`: the weights would need a
download."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from .resnet import refuse_pretrained

__all__ = ["AlexNet", "alexnet"]

# (channels, kernel, stride, pad, pool-after?) per conv stage
_CONV_STAGES = [
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, True),
]
_FC_UNITS = (4096, 4096)


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            for ch, k, s, p, pool in _CONV_STAGES:
                feats.add(nn.Conv2D(ch, kernel_size=k, strides=s,
                                    padding=p, activation="relu"))
                if pool:
                    feats.add(nn.MaxPool2D(pool_size=3, strides=2))
            feats.add(nn.Flatten())
            for units in _FC_UNITS:
                feats.add(nn.Dense(units, activation="relu"))
                feats.add(nn.Dropout(0.5))
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        refuse_pretrained()
    return net
