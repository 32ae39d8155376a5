#!/usr/bin/env python3
"""Where the memory of a captured forward goes, on one NVIDIA card.

    python3 tools/capture_memory.py [--batch 128] [--chain 16]

Each case builds a forward, runs it eagerly under ``torch.no_grad()``
(peak bytes allocated above what was live before, after
``reset_peak_memory_stats``), then captures it through the port's
compile service (``mxnet_tpu_torch.compile.jit``) and prints the bytes
the capture left behind: allocated (live blocks, the graph's included)
and held beyond allocated once the allocator's unused cached blocks are
released (mostly the graph's private pool). Cases:

* ``conv_chain``, ``bn_chain``, ``relu_chain``: ``--chain`` copies of one
  op on a (batch, 64, 56, 56) bfloat16 tensor, each output the next
  one's input (a 3x3 convolution through cuDNN, BatchNorm in inference,
  ReLU). If a capture reused the memory of tensors that died during it,
  as the eager run does, the graph keeps about two tensors; if it did
  not, about ``--chain``.
* ``resnet50_v1_bf16``: ``chip_smoke.py``'s resnet50_v1_infer_bf16 net
  (bfloat16, batch ``--batch``, 224 x 224), hybridized.

Prints one JSON line per case, then the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import compile as compile_service  # noqa: E402


def _held():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved() - torch.cuda.memory_allocated()


def measure(name, fn, x):
    """Eager peak of ``fn(x)``, then what capturing it left behind."""
    alloc0, _ = _held()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = fn(x)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - alloc0
    del out
    alloc0, pool0 = _held()
    jitted = compile_service.jit(fn, site="capture_memory", token=(name,))
    out = jitted(x)
    alloc1, pool1 = _held()
    return {"case": name, "input_bytes": x.numel() * x.element_size(),
            "output_bytes": out.numel() * out.element_size(),
            "eager_peak_bytes": eager_peak,
            "captured_allocated_bytes": alloc1 - alloc0,
            "captured_pool_bytes": pool1 - pool0,
            "captures": jitted.stats()["captures"]}


def chains(batch, n, dev):
    x = torch.randn(batch, 64, 56, 56, device=dev, dtype=torch.bfloat16)
    w = torch.randn(64, 64, 3, 3, device=dev, dtype=torch.bfloat16) * 0.05
    stats = [torch.rand(64, device=dev) + 0.5 for _ in range(4)]

    def conv_chain(t):
        for _ in range(n):
            t = torch.nn.functional.conv2d(t, w, padding=1)
        return t

    def bn_chain(t):
        for _ in range(n):
            t = torch.nn.functional.batch_norm(t, *stats, training=False)
        return t

    def relu_chain(t):
        for _ in range(n):
            t = torch.relu(t) * 0.5
        return t

    return [(f.__name__, f, x) for f in (conv_chain, bn_chain, relu_chain)]


def resnet(batch, dev):
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model("resnet50_v1", classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
                   generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")
    x = torch.rand(batch, 3, 224, 224, device=dev).to(torch.bfloat16)
    net(mx.nd.NDArray(x))  # resolve the deferred shapes

    def forward(t):
        return net(mx.nd.NDArray(t))._data

    return "resnet50_v1_bf16", forward, x


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--chain", type=int, default=16)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("capture_memory: needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for case in chains(args.batch, args.chain, dev) + [
            resnet(args.batch, dev)]:
        print(json.dumps(measure(*case)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    sys.exit(main())
