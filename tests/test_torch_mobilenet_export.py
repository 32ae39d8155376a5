"""MobileNet v2's exported graph on the CPU against the JAX package: its
ReLU6 (``HybridLambda`` over ``clip``) exports as ``clip`` nodes, the
symbol JSON and the parameters load in the JAX package and evaluate to
the port's outputs, and the JAX graph loads back into the port.
Tolerance: float32, rtol 1e-4 and atol 1e-5 (a deep stack of
convolutions summed in other orders)."""
import json
import os
import tempfile

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
TOL = dict(rtol=1e-4, atol=1e-5)


def test_mobilenet_v2_exports_clip_and_its_json_crosses_both_ways():
    x = np.random.RandomState(3).randn(1, 3, 32, 32).astype(np.float32)
    with mx.name.NameManager():
        net = vision.mobilenet_v2_0_25(classes=10, prefix="mnv2_")
    net.initialize(mx.init.Xavier(), ctx=CPU)
    want = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    with tempfile.TemporaryDirectory() as d:
        with mx.name.NameManager():
            net.export(os.path.join(d, "m"))
        text = open(os.path.join(d, "m-symbol.json")).read()
        ops = [n["op"] for n in json.loads(text)["nodes"]]
        # the stem, two in each of the 17 bottlenecks, the last conv
        assert ops.count("clip") == 1 + 2 * 17 + 1
        jsym = jmx.sym.load_json(text)
        params = mx.nd.load(os.path.join(d, "m-0000.params"), ctx=CPU)
    args = {k.split(":", 1)[1]: v.asnumpy() for k, v in params.items()}
    got = jsym.eval_with(dict({k: jmx.nd.array(v) for k, v in args.items()},
                              data=jmx.nd.array(x))).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    back = mx.sym.load_json(jsym.tojson())
    again = back.eval_with(dict({k: mx.nd.array(v, ctx=CPU)
                                 for k, v in args.items()},
                                data=mx.nd.array(x, ctx=CPU))).asnumpy()
    np.testing.assert_allclose(again, want, **TOL)
