"""DenseNet 121/161/169/201: counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py`` (the same BN-ReLU-Conv
motif, dense layers concatenated on the channels with ``Concat``,
prefixes and parameter names). ``pretrained=True`` raises
:class:`MXNetError`."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from .resnet import refuse_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


def _bn_relu_conv(seq, channels, kernel, padding=0):
    """The pre-activation motif every DenseNet component is made of."""
    seq.add(nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(channels, kernel_size=kernel, padding=padding,
                      use_bias=False))


class _DenseLayer(HybridBlock):
    """Bottleneck (1x1 then 3x3) producing `growth_rate` new channels,
    concatenated onto its input."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        body = nn.HybridSequential(prefix="")
        _bn_relu_conv(body, bn_size * growth_rate, kernel=1)
        _bn_relu_conv(body, growth_rate, kernel=3, padding=1)
        if dropout:
            body.add(nn.Dropout(dropout))
        self.body = body

    def hybrid_forward(self, F, x):
        return F.invoke("Concat", x, self.body(x), dim=1)


class DenseNet(HybridBlock):
    """Densely connected CNN: stem, alternating dense blocks and
    halving transitions, BN-ReLU head."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            feats.add(nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                                padding=3, use_bias=False),
                      nn.BatchNorm(), nn.Activation("relu"),
                      nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            channels = num_init_features
            last = len(block_config) - 1
            for i, n_layers in enumerate(block_config):
                block = nn.HybridSequential(prefix=f"stage{i + 1}_")
                with block.name_scope():
                    for _ in range(n_layers):
                        block.add(_DenseLayer(growth_rate, bn_size, dropout))
                feats.add(block)
                channels += n_layers * growth_rate
                if i != last:
                    trans = nn.HybridSequential(prefix="")
                    _bn_relu_conv(trans, channels // 2, kernel=1)
                    trans.add(nn.AvgPool2D(pool_size=2, strides=2))
                    feats.add(trans)
                    channels //= 2
            feats.add(nn.BatchNorm(), nn.Activation("relu"),
                      nn.AvgPool2D(pool_size=7), nn.Flatten())
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (stem channels, growth rate, layers per dense block)
densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def get_densenet(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config, **kwargs)
    if pretrained:
        refuse_pretrained()
    return net


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
