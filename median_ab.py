"""Builds of the masked-median kernel, alone, in one process on one
NVIDIA GPU.

    python3 median_ab.py OTHER.cu [OTHER2.cu ...]

builds each OTHER.cu (an earlier csrc/masked_median.cu with the same C
interface, e.g. from ``git show REV:dl_image_segmentation_tpu_torch/
csrc/masked_median.cu``) and the checkout's csrc/masked_median.cu
("this"), one nvcc each, started together, with the port's flags. At
each shape of chip_smoke.py's median cases it checks every build
bitwise against the plain version and times each alone (chip_smoke.py's
CUDA graph of bare launches, rotating over input copies that exceed the
L2) in turns: the others in order, this, this, the others in reverse.
Prints one JSON line per case and the card's name and power limit;
exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main(argv) -> int:
    import torch
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("median_ab: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dl_image_segmentation_tpu_torch import _build, kernels
    from dl_image_segmentation_tpu_torch.ops import compositing as oc

    src, signatures = kernels.SOURCES["masked_median"]
    paths = {os.path.splitext(os.path.basename(p))[0]: p for p in argv}
    paths["this"] = os.path.join(kernels.CSRC, src)
    cmd = kernels._cmd()
    started = {k: _build.start(cmd, p) for k, p in paths.items()
               if not os.path.exists(_build.output_path(p, cmd))}
    for k, p in paths.items():
        out = (_build.finish(*started[k]) if k in started
               else _build.output_path(p, cmd))
        with open(out + ".log") as f:
            n, spilled = cs.spills(f.read())
        print(f"{k}: {p} built; {n} kernels, spilling: {spilled}",
              flush=True)
    libs = {k: _build.load(cmd, p, signatures) for k, p in paths.items()}

    def launcher(lib):
        def launch(stack, valid, med, any_valid):
            S, H, W, B = stack.shape
            kernels.check(lib.masked_median_launch(
                stack.data_ptr(), oc._KERNEL_DTYPES[stack.dtype],
                valid.data_ptr(), med.data_ptr(), any_valid.data_ptr(), S,
                H * W * B, B, kernels.stream_ptr(stack.device)),
                "masked_median")
        return launch

    for S, H, W, B, _ in cs.MEDIAN_CASES:
        stack, valid = cs.median_case(S, H, W, B, seed=S + H)
        ref = oc.masked_median(stack, valid)
        bare = {}
        for k, lib in libs.items():
            bare[k], outs = cs.rotating_median_launches(stack, valid,
                                                        launcher(lib))
            for _ in outs:
                bare[k]()
            torch.cuda.synchronize()
            if not all(torch.equal(m, ref[0]) and torch.equal(a, ref[1])
                       for m, a in outs):
                raise AssertionError(f"{k} S={S} {H}x{W}x{B}: differs from "
                                     f"the plain version")
        n = len(outs) * max(1, 20 // len(outs))
        times = {k: [] for k in libs}
        order = list(paths)
        for k in order + order[::-1]:
            times[k].append(cs.graph_ms(bare[k], n=n))
        print(json.dumps({"case": f"S={S} {H}x{W}x{B} uint16",
                          "input_copies": len(outs), "equal": True,
                          "ms_alone": times}), flush=True)
        del stack, valid, ref, bare, outs
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
