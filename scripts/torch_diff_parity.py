#!/usr/bin/env python3
"""How close the PyTorch port's differentiable path is to the JAX one, on
the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_diff_parity.py

For each scene of ``tests/test_torch_diff.py`` (``CASES``: one random 6^3
brick, the same with an opaque-tail LUT whose rays saturate at alpha
exactly 1, a log-scaled, normalised and soft-clipped one, one whose rays
partly miss, and eight bricks side by side) it prints the largest
difference between the port and the jitted JAX function: the layers' and
the image's colours, the depths, and the gradients of a randomly weighted
image loss with respect to data and LUT over max |g_JAX|, and with
respect to eye, basis and field of view over the sum of their terms'
magnitudes (from ``jax.jacfwd``) and over max |g_JAX|; beside each, the
same measure between JAX's own eager and jitted gradients.  Runs on the CPU only; it needs
both packages, so not on a machine without JAX.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from amrvolumerenderer_tpu import diff as jdiff  # noqa: E402
from amrvolumerenderer_torch import diff  # noqa: E402
import test_torch_diff as cases  # noqa: E402

ARGNUMS = (0, 4, 6, 7, 8, 9, 10)  # data, LUT, eye, forward, right, up, fov
NAMES = ("data", "LUT", "eye", "forward", "right", "up", "fov")


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    for name, (args, static) in cases.CASES.items():
        layers = jax.jit(jdiff.render_layers_diff, static_argnames=tuple(static))
        jc, jd = (np.asarray(v) for v in layers(*args, **static))
        tc, td = (v.numpy() for v in diff.render_layers_diff(*cases.port(args),
                                                             **static))
        ji = np.asarray(jdiff.render_image_diff_jit(*args, **static))
        ti = cases.port_image(args, static).numpy()
        finite = np.isfinite(jd)
        same = bool(np.array_equal(finite, np.isfinite(td)))
        depth = float(np.abs(td[finite] - jd[finite]).max()) if finite.any() else 0.0

        w = np.random.default_rng(7).uniform(
            0, 1, size=(static["width"] * static["height"], 4)).astype(np.float32)

        def loss(*picked):
            full = list(args)
            for i, v in zip(ARGNUMS, picked):
                full[i] = v
            return jnp.sum(jdiff.render_image_diff(*full, **static) * w)

        picked = [jnp.asarray(args[i]) for i in ARGNUMS]
        grad = jax.grad(loss, argnums=tuple(range(len(ARGNUMS))))
        jit_g = [np.asarray(g) for g in jax.jit(grad)(*picked)]
        eager_g = [np.asarray(g) for g in grad(*picked)]
        port_g = cases.port_grads(args, static, w, ARGNUMS)

        def image(*camera):
            full = list(args)
            for i, v in zip(ARGNUMS[2:], camera):
                full[i] = v
            return jdiff.render_image_diff(*full, **static)

        jac = jax.jit(jax.jacfwd(image, argnums=tuple(range(5))))(*picked[2:])
        rows, naive = [], []
        for k, label in enumerate(NAMES):
            largest = np.abs(jit_g[k]).max()
            if k < 2:
                scale = largest
            else:
                column = np.asarray(jac[k - 2]).reshape(*w.shape, -1)
                scale = np.abs(column * w[..., None]).sum(axis=(0, 1))
                scale = scale.reshape(np.shape(jit_g[k]))
                naive.append(f"{label} {np.abs(port_g[k] - jit_g[k]).max() / largest:.3g}"
                             f" ({np.abs(eager_g[k] - jit_g[k]).max() / largest:.3g})")
            rows.append(f"{label} {float((np.abs(port_g[k] - jit_g[k]) / scale).max()):.3g}"
                        f" ({float((np.abs(eager_g[k] - jit_g[k]) / scale).max()):.3g})")
        print(f"{name}: layers max |diff| {np.abs(tc - jc).max():.3g}, image "
              f"{np.abs(ti - ji).max():.3g}, depth {depth:.3g}, non-finite depth "
              f"pattern same {same}; gradients, port vs jit (JAX eager vs jit), "
              f"over max |g| (data, LUT) or the sum of the terms (camera): "
              + ", ".join(rows) + "; camera over max |g|: " + ", ".join(naive),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
