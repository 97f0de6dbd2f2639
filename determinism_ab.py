"""Which work of the U-Net train step is not deterministic on the card,
and what the deterministic step costs.

    python3 determinism_ab.py

The step of chip_smoke.py's phase 6 (TrainConfig defaults with 10
classes: s2d 2 at width 64, 256 px RGB, batch 32), at bf16 and fp32:

1. ops that have no deterministic implementation in PyTorch
   (``torch.use_deterministic_algorithms(True, warn_only=True)`` over one
   step, with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA
   starts);
2. each conv shape of the step, forward and backward twice on the same
   seeded inputs with cuDNN's default algorithms (benchmark off, TF32
   off at fp32, as the step runs them): the shapes whose input gradient
   (dgrad) or weight gradient (wgrad) differ between the two backward
   passes, and the device kernels that run only without cuDNN's
   deterministic switch (torch.profiler over one step each way);
3. two runs of 3 steps from one state dict, as the Trainer runs them
   (cuDNN's deterministic algorithms) and with the switch left off:
   whether the losses and parameters are bitwise equal;
4. the step's CUDA-event time with and without the switch, in turns
   (off, on, on, off).

Needs one CUDA card; prints one JSON object as its last line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("determinism_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from dl_image_segmentation_tpu_torch.train import TrainConfig, Trainer
    from dl_image_segmentation_tpu_torch.train import trainer as tr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    rng = np.random.RandomState(0)
    X = rng.randint(0, 256, (32, 256, 256, 3)).astype(np.float32)
    Y = rng.randint(0, 10, (32, 256, 256)).astype(np.int32)
    Y[:, :20] = 255
    real_flags = tr._forward_flags

    @contextlib.contextmanager
    def flags_switch_off(fp32, deterministic=False):
        with real_flags(fp32):
            yield

    def trainer(precision, deterministic=True, bs=32):
        tr._forward_flags = real_flags if deterministic else flags_switch_off
        return Trainer(TrainConfig(num_classes=10, precision=precision,
                                   batch_size=bs))

    out = {"card": smi}
    for precision in ("bf16", "fp32"):
        row = out[precision] = {}
        fp32 = precision == "fp32"
        # 1. ops with no deterministic implementation
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t = trainer(precision, bs=4)
            t.train_step(X[:4], Y[:4])
            torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        row["ops_without_deterministic_implementation"] = sorted(
            {str(w.message).split(".")[0][:160] for w in caught
             if "deterministic" in str(w.message)})
        # 2. conv shapes of one step, each backward twice
        shapes = []
        real_conv = F.conv2d

        def record(x, w, b=None, stride=1, padding=0, *a, **kw):
            key = (tuple(x.shape), tuple(w.shape), x.dtype, stride, padding)
            if key not in shapes:
                shapes.append(key)
            return real_conv(x, w, b, stride, padding, *a, **kw)
        F.conv2d = record
        try:
            t.train_step(X[:4], Y[:4])
        finally:
            F.conv2d = real_conv
        # the shapes at the step's batch of 32 (recorded at batch 4)
        step_shapes = [((32,) + xs[1:], ws, dtype, stride, padding)
                       for xs, ws, dtype, stride, padding in shapes]
        t = trainer(precision, deterministic=False)
        x, y = t.place_batch(X, Y)
        nondet = []
        for xs, ws, dtype, stride, padding in step_shapes:
            g = torch.Generator(device="cuda").manual_seed(1)
            xi = torch.randn(xs, generator=g, device="cuda").to(dtype)
            wi = torch.randn(ws, generator=g, device="cuda").to(dtype)
            go = None
            grads = []
            for _ in range(2):
                a = xi.clone().requires_grad_()
                b = wi.clone().requires_grad_()
                with real_flags(fp32):
                    yv = F.conv2d(a, b, None, stride, padding)
                    if go is None:
                        go = torch.randn(yv.shape, generator=g,
                                         device="cuda").to(dtype)
                    yv.backward(go)
                grads.append((a.grad, b.grad))
            (da, wa), (db, wb) = grads
            bad = [n for n, u, v in (("dgrad", da, db), ("wgrad", wa, wb))
                   if not torch.equal(u, v)]
            if bad:
                nondet.append({"x": list(xs), "w": list(ws),
                               "stride": stride, "padding": padding,
                               "differs": bad})
        row["conv_shapes"] = len(step_shapes)
        row["nondeterministic_convs"] = nondet
        row["kernels_only_without_switch"] = kernels_only_without(
            trainer, precision, x, y)
        # 3. two runs of 3 steps, with and without the switch
        for name, det in (("switch_on", True), ("switch_off", False)):
            first = trainer(precision, det)
            state = {k: v.detach().clone()
                     for k, v in first.model.state_dict().items()}
            runs = []
            for _ in range(2):
                t = trainer(precision, det)
                t.model.load_state_dict(state)
                xd, yd = t.place_batch(X, Y)
                losses = [t.train_step(xd, yd)["loss"] for _ in range(3)]
                runs.append((losses, {n: p.detach().clone()
                                      for n, p in t.state.params.items()}))
            (l1, p1), (l2, p2) = runs
            row[f"two_runs_bitwise_{name}"] = l1 == l2 and all(
                torch.equal(p1[n], p2[n]) for n in p1)
            row[f"params_differing_{name}"] = sum(
                not torch.equal(p1[n], p2[n]) for n in p1)
            del first, t, runs
            torch.cuda.empty_cache()
        # 4. step time in turns
        times = {"switch_off": [], "switch_on": []}
        for name in ("switch_off", "switch_on", "switch_on", "switch_off"):
            t = trainer(precision, name == "switch_on")
            xd, yd = t.place_batch(X, Y)
            times[name].append(step_ms(t, xd, yd))
            del t, xd, yd
            torch.cuda.empty_cache()
        row["step_ms"] = times
        off, on = (float(np.mean(times[k]))
                   for k in ("switch_off", "switch_on"))
        row["cost"] = on / off - 1.0
        print(precision, json.dumps(row), flush=True)
    tr._forward_flags = real_flags
    print(json.dumps(out))
    return 0


def step_ms(t, x, y, reps=10) -> float:
    import torch
    for _ in range(3):
        t.train_step_async(x, y)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        t.train_step_async(x, y)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernels_only_without(trainer, precision, x, y):
    """Device kernels of one step that run only with cuDNN's
    deterministic switch off, and only with it on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for det in (False, True):
        t = trainer(precision, det)
        t.train_step_async(x, y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t.train_step_async(x, y)
            torch.cuda.synchronize()
        names[det] = {e.key[:90] for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA}
        del t
    return {"off_only": sorted(names[False] - names[True]),
            "on_only": sorted(names[True] - names[False])}


if __name__ == "__main__":
    sys.exit(main())
