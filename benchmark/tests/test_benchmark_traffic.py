"""The traffic generator: one seed gives the same inputs, every seed the
same sizes."""

import numpy as np
import torch

from benchmark.harness import core
from benchmark.harness import traffic as gen

TRAIN = {**core.load_json(f"{core.BENCH_DIR}/traffic/train.json"),
         "pool_rays": 3000}
RENDER = {**core.load_json(f"{core.BENCH_DIR}/traffic/render.json"),
          "width": 40, "height": 30}
CPU = torch.device("cpu")


def test_train_pool_is_deterministic_for_a_seed():
    big = 2**31 + 12345
    a, b = gen.train_pool(TRAIN, big, CPU), gen.train_pool(TRAIN, big, CPU)
    c = gen.train_pool(TRAIN, big + 1, CPU)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape and a[k].dtype == c[k].dtype
        assert len(a[k]) == TRAIN["pool_rays"]
    assert not np.array_equal(a["rays_o"], c["rays_o"])


def test_train_pool_aims_at_the_ball():
    p = gen.train_pool(TRAIN, 5, CPU)
    r = np.linalg.norm(p["rays_o"], axis=-1)
    np.testing.assert_allclose(r, TRAIN["origin_radius"], rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(p["viewdirs"], axis=-1), 1.0,
                               rtol=1e-5)
    # the closest approach to the centre is about target_std
    t = -(p["rays_o"] * p["viewdirs"]).sum(-1, keepdims=True)
    miss = np.linalg.norm(p["rays_o"] + t * p["viewdirs"], axis=-1)
    assert np.median(miss) < 3 * TRAIN["target_std"]
    assert set(np.unique(p["em_modes"])) == {0, 1}
    assert p["rgbs"].min() >= 0 and p["rgbs"].max() <= 1


def test_render_views_same_set_in_another_order():
    a, b = gen.render_views(RENDER, 7), gen.render_views(RENDER, 7)
    c = gen.render_views(RENDER, 8)
    assert len(a) == RENDER["n_views"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["rays_d"], y["rays_d"])
        assert x["em_mode"] == y["em_mode"]
        assert x["rays_o"].shape == (40 * 30, 3)
    key = lambda vs: sorted(tuple(np.round(v["rays_o"][0], 5)) for v in vs)
    assert key(a) == key(c)
    assert [tuple(v["rays_o"][0]) for v in a] != \
        [tuple(v["rays_o"][0]) for v in c]
    # every camera looks at the centre
    for v in a:
        mid = v["viewdirs"].reshape(30, 40, 3)[15, 20]
        o = v["rays_o"][0]
        np.testing.assert_allclose(mid, -o / np.linalg.norm(o), atol=0.05)
