"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where there is no CUDA device; run them on the GPU with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from dl_image_segmentation_tpu_torch import kernels
from dl_image_segmentation_tpu_torch.ops import compositing as oc

rz = importlib.import_module("dl_image_segmentation_tpu_torch.ops.rasterize")

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("S,dtype", [(1, np.uint16), (10, np.uint16),
                                     (73, np.uint16), (128, np.uint16),
                                     (5, np.float32)])
def test_masked_median_kernel_equals_plain(S, dtype):
    _need_card()
    rng = np.random.RandomState(S)
    stack = torch.from_numpy((rng.rand(S, 17, 19, 3) * 4000).astype(dtype))
    valid = torch.from_numpy(rng.rand(S, 17, 19) > 0.4)
    valid[:, 0, 0] = False
    before = kernels.MASKED_MEDIAN.count
    got = oc.masked_median_kernel(stack.cuda(), valid.cuda())
    ref = oc.masked_median(stack, valid)
    assert kernels.MASKED_MEDIAN.count == before + 1
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])
    with pytest.raises(ValueError):
        oc.masked_median_kernel(stack.cuda()[:, :, :, 0], valid.cuda())


@pytest.mark.parametrize("n,all_touched", [(30, True), (30, False),
                                           (90, True)])
def test_burn_kernels_equal_plain(n, all_touched):
    _need_card()
    rng = np.random.RandomState(n)
    feats = []
    for v in range(1, n + 1):
        c = rng.rand(2) * 60 + 10
        k = rng.randint(3, 40)
        ang = np.sort(rng.rand(k) * 2 * np.pi)
        rad = (rng.rand(k) * 0.5 + 0.5) * (rng.rand() * 12 + 1)
        feats.append(([np.stack([c[0] + rad * np.cos(ang),
                                 c[1] + rad * np.sin(ang)], 1)], v,
                       (float(v % 7), 70.0)))
    e, v, w = rz.pack_features(feats)
    ref = rz._rasterize_torch(*(torch.from_numpy(x) for x in (e, v)), 255.0,
                              80, 90, all_touched, torch.from_numpy(w))
    ec, vc, wc = (torch.from_numpy(x).cuda() for x in (e, v, w))
    dense = rz.burn_dense(ec, vc, wc, 255.0, 80, 90, all_touched)
    cnt, tab = rz._bin_features(e, w, 80, 90, *rz.BURN_BLOCK)
    binned = rz.burn_binned(ec, vc, wc, torch.from_numpy(cnt).cuda(),
                            torch.from_numpy(tab).cuda(), 255.0, 80, 90,
                            all_touched)
    assert torch.equal(dense.cpu(), ref) and torch.equal(binned.cpu(), ref)
