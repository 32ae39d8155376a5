#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions. No usable card is an error: the script exits non-zero and
   prints no result.
2. build: compiles every kernel source in ``mxnet_tpu_torch/csrc`` with
   ``nvcc`` (all at once), and prints the build seconds and ptxas's
   register and shared-memory report.
3. flash: holds the flash-attention kernel against its plain PyTorch
   version on the serving shape and on ragged, cross-attention and other
   head-dim shapes, float32 and bfloat16, causal and not; then times the
   kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only: the port never calls it) at the serving shape.
4. serve: the BERT-class classifier of
   ``examples/gluon/transformer_finetune.py`` at BERT-base width (vocab
   30522, units 768, FFN 3072, 12 heads, 12 layers, seq 128, 2 classes;
   random float32 weights from ``numpy.random.RandomState(0)``) behind
   ``ServedModel.from_block`` + ``ModelServer`` on the default bucket
   ladder. Requests of 1-8 rows come from several threads; every answer
   is checked against the same rows run alone through the block, two
   rows against a CPU copy of the model, and the flash kernel's launch
   count against 12 x batches.
5. profile: one batch per bucket on the host clock, and a
   ``torch.profiler`` window over bucket-32 batches (device time by
   kernel group, device busy share).

Then the ``{"kernels": [...]}`` line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failure is an
exception and a non-zero exit.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels, serving
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.kernels import build, flash

BERT_BASE = {"vocab": 30522, "units": 768, "hidden": 3072, "heads": 12,
             "layers": 12, "seq_len": 128, "num_classes": 2}
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores, 700 W part
H100_BYTES_S = 3.35e12    # HBM3
F32_TOL = 2e-5  # the kernel reassociates the softmax normaliser across k tiles
BF16_TOL = 2e-2  # the plain version rounds scores and probabilities to bf16
SERVE_TOL = 1e-4  # float32 logits; cuBLAS may pick another algorithm per batch size
CPU_TOL = 1e-3    # float32 logits after 12 layers, CPU vs card summation order


def build_encoder(args, mx, nn, contrib_nn):
    """``examples/gluon/transformer_finetune.py:build_encoder``, verbatim."""
    enc = nn.HybridSequential(prefix="encoder_")
    with enc.name_scope():
        enc.add(contrib_nn.SparseEmbedding(args.vocab, args.units))
        for _ in range(args.layers):
            enc.add(contrib_nn.TransformerEncoderCell(
                args.units, args.hidden, args.heads))
    return enc


def build_classifier(mx, cfg):
    """The example's ``Classifier`` (encoder, first-token pooling through
    ``slice_axis`` + ``Flatten``, ``Dense(tanh)``, ``Dense(classes)``)
    built from package ``mx``'s blocks; ``cfg`` holds the
    ``BERT_BASE`` keys."""
    nn, contrib_nn = mx.gluon.nn, mx.gluon.contrib.nn
    args = type("Args", (), dict(cfg))

    class Classifier(nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.encoder = build_encoder(args, mx, nn, contrib_nn)
                self.pool = nn.Dense(args.units, activation="tanh",
                                     flatten=False)
                self.out = nn.Dense(args.num_classes)

        def hybrid_forward(self, F, tokens):
            h = self.encoder(tokens)
            # BERT-style pooling over the first position
            first = F.invoke("slice_axis", h, axis=1, begin=0, end=1)
            return self.out(self.pool(F.invoke("Flatten", first)))

    return Classifier()


def classifier_shapes(cfg):
    """Structural parameter name -> shape of ``build_classifier(cfg)``."""
    u, hdn = cfg["units"], cfg["hidden"]
    shapes = {"encoder.0.weight": (cfg["vocab"], u)}
    for i in range(1, cfg["layers"] + 1):
        c = f"encoder.{i}."
        for ln in ("ln1", "ln2"):
            shapes[c + ln + ".gamma"] = (u,)
            shapes[c + ln + ".beta"] = (u,)
        for d in ("query", "key", "value", "proj"):
            shapes[c + f"attn.{d}.weight"] = (u, u)
            shapes[c + f"attn.{d}.bias"] = (u,)
        shapes[c + "ffn1.weight"] = (hdn, u)
        shapes[c + "ffn1.bias"] = (hdn,)
        shapes[c + "ffn2.weight"] = (u, hdn)
        shapes[c + "ffn2.bias"] = (u,)
    shapes["pool.weight"] = (u, u)
    shapes["pool.bias"] = (u,)
    shapes["out.weight"] = (cfg["num_classes"], u)
    shapes["out.bias"] = (cfg["num_classes"],)
    return shapes


def random_params(cfg, seed):
    """Xavier-uniform weights, small random biases, LayerNorm gains near
    1, as float32 numpy arrays from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in classifier_shapes(cfg).items():
        if name.endswith("gamma"):
            a = 1.0 + 0.1 * rs.standard_normal(shape)
        elif len(shape) == 1:
            a = 0.02 * rs.standard_normal(shape)
        else:
            scale = math.sqrt(3.0 / ((shape[0] + shape[1]) / 2.0))
            a = rs.uniform(-scale, scale, shape)
        out[name] = a.astype(np.float32)
    return out


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi}
    emit({"phase": "device", **dev, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return dev


def phase_build():
    t0 = time.perf_counter()
    report = build.build_all(force=True)
    wall = time.perf_counter() - t0
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name, "seconds": r["seconds"],
              "ptxas": ptxas})
    emit({"phase": "build", "kernels": sorted(report), "wall_s": wall})


def attention_bound_ms(q, k, causal, dtype_flops):
    """Least time for one attention call: each of q, k, v, o moved once
    over HBM, or the multiply-adds of the unmasked score pairs (QK^T and
    PV, 2 FLOP each) at the card's peak for the input type."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * q.element_size()
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * pairs * d
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / dtype_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_flash():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(b, h, sq, sk, d, dtype):
        return [torch.randn((b, h, s, d), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for s in (sq, sk, sk)]

    cases = [((32, 12, 128, 128, 64), dt, c)
             for dt in (torch.float32, torch.bfloat16) for c in (False, True)]
    cases += [((8, 12, 100, 100, 64), torch.float32, False),
              ((8, 12, 100, 100, 64), torch.float32, True),
              ((4, 12, 128, 256, 64), torch.float32, False),
              ((4, 8, 128, 128, 128), torch.float32, False),
              ((4, 8, 128, 128, 128), torch.bfloat16, True),
              ((2, 4, 96, 80, 40), torch.float32, True),
              ((2, 4, 64, 64, 256), torch.float32, False),
              ((2, 4, 48, 48, 512), torch.float32, True)]
    slice_err = None
    for (b, h, sq, sk, d), dtype, causal in cases:
        q, k, v = qkv(b, h, sq, sk, d, dtype)
        scale = 1.0 / math.sqrt(d)
        got = flash.flash_forward(q, k, v, scale, causal)
        torch.cuda.synchronize()
        want = flash.flash_attention_plain(q, k, v, scale, causal)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        diff = (got.float() - want.float()).abs()
        max_abs = diff.max().item()
        max_rel = (diff / want.float().abs().clamp_min(1e-6)).max().item()
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        emit({"phase": "flash", "shape": [b, h, sq, sk, d],
              "dtype": str(dtype).replace("torch.", ""), "causal": causal,
              "max_abs_err": max_abs, "max_rel_err": max_rel,
              "rtol_atol": tol, "ok": ok})
        if not ok:
            raise AssertionError(f"flash kernel disagrees with the plain "
                                 f"version at {(b, h, sq, sk, d)} {dtype} "
                                 f"causal={causal}: max abs err {max_abs}")
        if (b, h, sq, sk, d) == (32, 12, 128, 128, 64) and \
                dtype == torch.float32 and not causal:
            slice_err = max_abs

    q, k, v = qkv(32, 12, 128, 128, 64, torch.float32)
    scale = 0.125
    kernel_ms = cuda_ms(lambda: flash.flash_forward(q, k, v, scale, False))
    plain_ms = cuda_ms(
        lambda: flash.flash_attention_plain(q, k, v, scale, False))
    library_ms = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v, scale=scale))
    bound_ms, bound_by = attention_bound_ms(q, k, False, H100_F32_FLOPS)
    timing = {"shape": [32, 12, 128, 128, 64], "dtype": "float32",
              "causal": False, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "max_abs_err": slice_err}
    emit({"phase": "flash_timing", **timing})
    return timing


def phase_serve(smi):
    cfg = BERT_BASE
    t0 = time.perf_counter()
    weights = random_params(cfg, seed=0)
    n_params = sum(a.size for a in weights.values())
    clf = build_classifier(mx, cfg)
    clf.initialize(mx.init.Zero())          # the card: the default context
    load_jax_params(clf, weights)
    t_weights = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    model = serving.ServedModel.from_block("bert_base_sst2", clf,
                                           example_shape=(cfg["seq_len"],))
    server = serving.ModelServer(serving.ModelContainer([model])).start()
    warm = server.warmup()

    rs = np.random.RandomState(1)
    n_threads, per_thread = 4, 12
    payloads = [[rs.randint(0, cfg["vocab"], (rs.randint(1, 9),
                                              cfg["seq_len"]))
                 .astype(np.float32) for _ in range(per_thread)]
                for _ in range(n_threads)]
    futures = [[None] * per_thread for _ in range(n_threads)]

    def client(i):
        for j, x in enumerate(payloads[i]):
            futures[i][j] = server.submit(model.name, x)

    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise RuntimeError("a client thread did not finish submitting")
    answers = [[f.result(timeout=300) for f in row] for row in futures]
    wall = time.perf_counter() - t_start
    launches = kernels.launch_counts()["flash_attention"]
    stats = server.stats()["models"][model.name]
    peak = torch.cuda.max_memory_allocated()
    if not server.drain(timeout=60):
        raise RuntimeError("server did not drain")

    rows = sum(x.shape[0] for row in payloads for x in row)
    if stats["completed"] != n_threads * per_thread or stats["failed"]:
        raise AssertionError(f"not every request was answered: {stats}")
    if launches != cfg["layers"] * stats["batches"]:
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg['layers']} x {stats['batches']} batches")

    max_err = 0.0
    for row_p, row_a in zip(payloads, answers):
        for x, got in zip(row_p, row_a):
            if got.shape != (x.shape[0], cfg["num_classes"]) or \
                    not np.isfinite(got).all():
                raise AssertionError(f"bad answer {got.shape}")
            with torch.inference_mode():
                want = clf(mx.nd.array(x)).asnumpy()
            max_err = max(max_err, float(np.abs(got - want).max()))
            np.testing.assert_allclose(got, want, rtol=SERVE_TOL,
                                       atol=SERVE_TOL)

    # the same model on the CPU, through the plain attention
    with mx.cpu():
        ref = build_classifier(mx, cfg)
        ref.initialize(mx.init.Zero())
        load_jax_params(ref, weights)
        x = payloads[0][0][:2]
        with torch.inference_mode():
            want = ref(mx.nd.array(x)).asnumpy()
    got = answers[0][0][:2]
    cpu_err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL)

    emit({"phase": "serve", "card": smi, "params": int(n_params),
          "weights_s": t_weights, "warmup": warm["models"][model.name],
          "requests": stats["completed"], "rows": rows,
          "batches": stats["batches"],
          "bucket_census": stats["bucket_census"],
          "fill_ratio": stats["batch_fill_ratio"],
          "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
          "rows_per_s": rows / wall, "wall_s": wall,
          "max_memory_allocated": peak, "flash_launches": launches,
          "max_abs_err_vs_block": max_err, "max_abs_err_vs_cpu": cpu_err})
    return launches, model


def _kernel_group(name):
    low = name.lower()
    for group, keys in (("flash_attention", ("flash_fwd_kernel",)),
                        ("gemm", ("gemm", "cutlass", "sm90_xmma", "cublas")),
                        ("layer_norm", ("layer_norm",)),
                        ("activations", ("gelu", "tanh")),
                        ("copy", ("memcpy", "copy"))):
        if any(k in low for k in keys):
            return group
    return "other"


def phase_profile(model, smi, reps=3):
    """Where a served batch's time goes: host-clock ms of one batch per
    bucket (``ServedModel.run``, which waits for the answer), then a
    ``torch.profiler`` window over ``reps`` bucket-32 batches: device
    time by kernel group and the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bucket_ms = {}
    for b in model.buckets:
        x = model.host_batch(b)
        model.run(x)
        t0 = time.perf_counter()
        for _ in range(reps):
            model.run(x)
        bucket_ms[b] = (time.perf_counter() - t0) * 1e3 / reps
    x = model.host_batch(model.max_bucket)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model.run(x)
        window_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels_us = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        us = e.self_device_time_total / reps
        kernels_us[e.key] = kernels_us.get(e.key, 0.0) + us
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
    device_ms = sum(groups.values()) / 1e3
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "card": smi, "bucket_ms": bucket_ms,
          "bucket": model.max_bucket, "window_ms_per_batch": window_ms / reps,
          "device_ms_per_batch": device_ms if groups else "not measured",
          "device_busy_share": device_ms * reps / window_ms
          if groups else "not measured",
          "device_us_by_group": groups,
          "top_kernels_us": [[k[:80], v] for k, v in top]})


def main():
    dev = phase_device()
    phase_build()
    timing = phase_flash()
    launches, model = phase_serve(dev["nvidia_smi"])
    phase_profile(model, dev["nvidia_smi"])
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/kernels/flash.py:38",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
