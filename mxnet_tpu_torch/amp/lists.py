"""AMP's op lists, the JAX package's (``mxnet_tpu/amp/lists.py``; MXNet
1.x ``python/mxnet/contrib/amp/lists/symbol_fp16.py``), over the
registry's canonical op names:

* ``TARGET_OPS``: the products (convolution, dense, RNN, matrix
  products), always cast to the target dtype (MXNet's FP16_FUNCS);
* ``FP32_OPS``: ops that lose accuracy in half precision (the softmax
  family, norms, reductions, exp and log), cast to float32
  (FP32_FUNCS);
* ``WIDEST_OPS``: elementwise ops of several inputs, cast to the widest
  input dtype (WIDEST_TYPE_CASTS).
"""

TARGET_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "RNN",
    "dot", "batch_dot",
]

FP32_OPS = [
    "softmax", "log_softmax", "SoftmaxActivation", "SoftmaxOutput",
    "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm",
    "L2Normalization", "norm", "mean", "sum", "nansum", "prod", "nanprod",
    "exp", "expm1", "log", "log10", "log2", "log1p",
    "CTCLoss", "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput", "smooth_l1", "MakeLoss",
]

WIDEST_OPS = [
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "broadcast_hypot", "add_n", "maximum", "minimum", "where",
]
