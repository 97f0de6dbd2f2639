"""Writes ``tests/data/world_losses.npz``: the JAX package's ``Trainer``
on a 2x2 mesh of 4 virtual CPU devices, 3 steps of each regime of
``tests/test_torch_parallel.py:FROM_JAX`` from the same flax init
(``jax_init``) and the same seeded global batches
(``parallel/dryrun.py:seeded_batches``) as the port's world there. The
file holds, per regime, the 3 losses and the regime's config as JSON, so
that the test sees a config that moved since the file was written.

For the regimes of ``ONE_DEVICE`` the losses held are the JAX Trainer's
on one device, and its 2x2 losses are kept beside them as
``<regime>.jax_2x2``: there the JAX package's spatial step does not
compute what its own one-device step computes (spatial SegFormer-lite:
the losses of steps 2 and 3 are 1.1% and 2.7% off, while its 2x2 step
without ``spatial`` agrees with one device to 5e-6).

Run from the root of the repository, where the JAX package is:

    python tests/data/make_world_losses.py

The parameters are placed as the JAX ``Trainer._init_state`` places them
(``param_shardings``, with TP off under ``spatial``), the optimizer state
replicated.
"""

from __future__ import annotations

import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "data", "world_losses.npz")
ONE_DEVICE = ("spatial_segformer",)


def world_losses(name, cfg, init, batches, n=2):
    """3 steps of the JAX Trainer on an n x n mesh of the virtual devices
    from ``init``."""
    import jax
    import jax.numpy as jnp
    from dl_image_segmentation_tpu.parallel import sharding as jsharding
    from dl_image_segmentation_tpu.train import trainer as jtrainer
    config = jtrainer.TrainConfig(**cfg)
    mesh = jsharding.make_mesh(n_data=n, n_model=n,
                               devices=jax.devices()[:n * n])
    init_state = jtrainer.Trainer._init_state
    jtrainer.Trainer._init_state = lambda self: None
    try:
        t = jtrainer.Trainer(config, mesh=mesh)
    finally:
        jtrainer.Trainer._init_state = init_state
    p_sh = jsharding.param_shardings(
        mesh, init, tp_min_features=(1 << 30) if config.spatial else 256,
        fsdp=config.fsdp)
    params = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x), s), init, p_sh)
    rep = jsharding.replicated_sharding(mesh)
    t.state = jtrainer.TrainState(
        params, jax.device_put(t.tx.init(params), rep),
        jax.device_put(jnp.zeros((), jnp.int32), rep))
    losses = [t.train_step(x, y)["loss"] for x, y in batches]
    print(f"{name}: {losses}")
    return losses


def main() -> int:
    import jax
    import numpy as np
    sys.path.insert(0, ROOT)
    jax.config.update("jax_platforms", "cpu")
    from dl_image_segmentation_tpu_torch.parallel.dryrun import \
        seeded_batches
    from tests.test_torch_parallel import CONFIGS, FROM_JAX, jax_init
    out = {}
    for name in FROM_JAX:
        cfg = CONFIGS[name]
        init, batches = jax_init(name), seeded_batches(cfg, 3, 0)
        out[name] = np.asarray(world_losses(name, cfg, init, batches),
                               np.float64)
        if name in ONE_DEVICE:
            out[f"{name}.jax_2x2"] = out[name]
            one = dict(cfg, n_model=1, spatial=False)
            out[name] = np.asarray(world_losses(name + " (one device)", one,
                                                init, batches, n=1),
                                   np.float64)
        out[f"{name}.config"] = np.asarray(json.dumps(cfg, sort_keys=True))
    np.savez(OUT, **out)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
