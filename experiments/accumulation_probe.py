"""Why the reference's ``test_gradient_accumulation_equivalence`` fails.

Runs the reference's own case (qwen3-0.6b smoke config, batch 4 x 16,
``clip_norm=0``, ``accum_steps`` 1 against 2) with SGD in place of AdamW,
then locates AdamW's largest difference and the gradient there:

  PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/accumulation_probe.py

Prints, per optimizer, the largest parameter difference between the two
steps and whether it passes the test's ``atol=2e-5``; for AdamW the
gradient at the worst element, and the largest differences where |g| is
above and below 1e-6.
"""

import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from test_archs import _batch_for  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.models.config import smoke_config  # noqa: E402
from repro.train.optim import adamw, sgd  # noqa: E402
from repro.train.train_step import init_state, make_train_step  # noqa: E402


def steps(cfg, opt, batch):
    s0 = init_state(cfg, jax.random.PRNGKey(0), opt)
    one, _ = jax.jit(make_train_step(cfg, opt, accum_steps=1,
                                     clip_norm=0.0))(s0, batch)
    two, _ = jax.jit(make_train_step(cfg, opt, accum_steps=2,
                                     clip_norm=0.0))(s0, batch)
    return s0, one, two


def worst_leaf(a, b):
    flat = jax.tree_util.tree_flatten_with_path(a.params)[0]
    worst = (0.0, None)
    for (path, x), y in zip(flat, jax.tree.leaves(b.params)):
        d = float(np.max(np.abs(np.asarray(x, np.float32)
                                - np.asarray(y, np.float32))))
        worst = max(worst, (d, jax.tree_util.keystr(path)))
    return worst


def main():
    cfg = smoke_config(get_config("qwen3-0.6b"))
    batch = _batch_for(cfg, b=4, s=16)
    for name, opt in (("sgd lr 1e-3", sgd(lr=1e-3)),
                      ("sgd lr 1e-2", sgd(lr=1e-2)),
                      ("adamw lr 1e-3", adamw(lr=1e-3))):
        s0, one, two = steps(cfg, opt, batch)
        d, where = worst_leaf(one, two)
        print(f"{name}: max |param diff| {d:.3e} at {where}; passes "
              f"atol=2e-5: {d <= 2e-5}")
    grad = jax.grad(lambda p, b: tfm.loss_fn(p, cfg, b)[0])
    g1 = grad(s0.params, batch)
    half = jax.tree.map(lambda x: x.reshape((2, 2) + x.shape[1:]), batch)
    g2 = jax.tree.map(lambda u, v: (u + v) / 2,
                      *[grad(s0.params, jax.tree.map(lambda x: x[i], half))
                        for i in (0, 1)])
    gap = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
              for x, y in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)))
    print(f"gradients, one batch against two microbatches: max |diff| "
          f"{gap:.3e}")
    x = np.asarray(g1["layers"]["w_gate"])
    y = np.asarray(g2["layers"]["w_gate"])
    d = np.abs(np.asarray(one.params["layers"]["w_gate"])
               - np.asarray(two.params["layers"]["w_gate"]))
    i = int(np.argmax(d))
    big = np.abs(x) > 1e-6
    print(f"adamw, w_gate: worst diff {d.flat[i]:.3e} where g is "
          f"{x.flat[i]:.4e} (one batch) and {y.flat[i]:.4e} (two); "
          f"|g| > 1e-6: max diff {d[big].max():.3e}; |g| <= 1e-6: "
          f"{int((~big).sum())} elements, max diff {d[~big].max():.3e}")


if __name__ == "__main__":
    main()
