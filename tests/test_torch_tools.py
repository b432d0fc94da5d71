"""The port's small tools against the JAX package's: the budget advisor
(``scan``'s arrays and the printed report, on one ``metrics.jsonl``),
``posenc`` and ``freqs``, the image functions ``remove_gamma_curve``,
``mse2psnr`` and ``tensor2img``; and a ``TraceCapture`` writing a Chrome
trace on the CPU (the spans and counters: ``test_torch_profiling.py``)."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.ops import encoding as jenc
from esrnerf_tpu.ops import image as jimg
from esrnerf_tpu_torch.ops import encoding as tenc
from esrnerf_tpu_torch.ops import image as timg
from esrnerf_tpu_torch.scripts import budget_advisor as tadv
from esrnerf_tpu_torch.utils import profiling as tprof
from test_torch_common import REPO

pytestmark = pytest.mark.quick


def _jax_advisor():
    spec = importlib.util.spec_from_file_location(
        "jax_budget_advisor", os.path.join(REPO, "scripts/budget_advisor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_dir(tmp_path):
    """A log dir with a ``metrics.jsonl`` as a run writes it: an LTS run
    whose first step overflows the secondary march, eval rows without the
    keys, and one truncated line."""
    rng = np.random.default_rng(0)
    rows = []
    for step in range(40):
        r = {"step": step, "train/metric/srgb/MSE": float(rng.random())}
        r.update({f"train/metric/etc/{k}": float(v) for k, v in (
            ("k1_frac", rng.uniform(0.3, 0.7)),
            ("k2_frac", rng.uniform(0.01, 0.3)),
            ("k1_frac_2nd", 1.0003 if step == 0 else rng.uniform(0.5, 0.7)),
            ("k2_frac_2nd", rng.uniform(0.05, 0.34)),
            ("overflow", 3e-4 if step == 0 else 0.0))})
        rows.append(json.dumps(r))
        if step % 10 == 9:
            rows.append(json.dumps({"step": step,
                                    "test_nv/metric/srgb/PSNR": 21.5}))
    d = tmp_path / "logs" / "fine.LTS"
    d.mkdir(parents=True)
    (d / "metrics.jsonl").write_text("\n".join(rows) + '\n{"step": 4')
    # a fine run with the primary keys only and a tight k1
    f = tmp_path / "logs" / "fine.Fine"
    f.mkdir()
    (f / "metrics.jsonl").write_text("\n".join(json.dumps(
        {"step": s, "train/metric/etc/k1_frac": 0.7 + 0.02 * s,
         "train/metric/etc/k2_frac": 0.07, "train/metric/etc/overflow": 0.0})
        for s in range(5)))
    return tmp_path / "logs"


def test_budget_advisor_matches_jax(run_dir, capsys, monkeypatch):
    jadv = _jax_advisor()
    path = str(run_dir / "fine.LTS" / "metrics.jsonl")
    got, want = tadv.scan(path), jadv.scan(path)
    assert got.keys() == want.keys() and len(got) == 5
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tadv.HEADROOM == jadv.HEADROOM == 1.3

    for args in ([str(run_dir)], [path], [str(run_dir / "none")]):
        monkeypatch.setattr("sys.argv", ["budget_advisor.py", *args])
        rc_j = jadv.main()
        out_j = capsys.readouterr().out
        rc_t = tadv.main(args)
        out_t = capsys.readouterr().out
        assert (rc_t, out_t) == (rc_j, out_j), args
    tadv.main([path])
    out = capsys.readouterr().out
    assert "OVERFLOW seen (max 0.0003)" in out
    assert "GROW: budget overflowed" in out


@pytest.mark.parametrize("n_freqs,include", [(0, True), (0, False), (4, True),
                                             (5, False)])
def test_posenc_matches_jax(n_freqs, include):
    """sin/cos of the same float32 products (XLA's and ATen's sin differ
    in the last bits at arguments up to 2^4 * 3): atol 1e-6."""
    x = np.random.default_rng(n_freqs).uniform(-3, 3, (7, 5, 3)).astype(
        np.float32)
    want = np.asarray(jenc.posenc(jnp.asarray(x), n_freqs, include))
    got = tenc.posenc(torch.from_numpy(x), n_freqs, include).numpy()
    assert got.shape == want.shape == (7, 5, tenc.posenc_dim(3, n_freqs,
                                                            include))
    assert tenc.posenc_dim(3, n_freqs, include) == jenc.posenc_dim(
        3, n_freqs, include)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tenc.freqs(6).numpy(),
                                  np.asarray(jenc.freqs(6)))


def test_image_functions_match_jax():
    """``remove_gamma_curve`` within 1e-6 relative (pow in two libraries),
    ``mse2psnr`` within 1e-6 relative, ``tensor2img`` bitwise, on both
    sides of the piecewise breakpoints."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-0.1, 1.2, 4096),
                        [0.0, 0.04045, 0.0404, 0.0405, 1.0, -0.01]]
                       ).astype(np.float32)
    np.testing.assert_allclose(
        timg.remove_gamma_curve(torch.from_numpy(x)).numpy(),
        np.asarray(jimg.remove_gamma_curve(jnp.asarray(x))), rtol=1e-6,
        atol=1e-9)
    lin = rng.uniform(0, 1, 512).astype(np.float32)
    back = timg.remove_gamma_curve(timg.apply_gamma_curve(
        torch.from_numpy(lin))).numpy()
    np.testing.assert_allclose(back, lin, rtol=1e-5, atol=1e-7)
    mse = rng.uniform(1e-5, 0.1, 64).astype(np.float32)
    np.testing.assert_allclose(timg.mse2psnr(torch.from_numpy(mse)).numpy(),
                               np.asarray(jimg.mse2psnr(jnp.asarray(mse))),
                               rtol=1e-6)
    assert abs(float(timg.mse2psnr(0.01)) - 20.0) < 1e-5
    for arr in (x.reshape(-1, 2), torch.from_numpy(x)):
        got = timg.tensor2img(arr)
        want = jimg.tensor2img(np.asarray(arr))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    """Steps 2 and 3 of 6 traced on the CPU under the JAX package's keys;
    no key, no trace."""
    cfg = {"system": {"profile_dir": str(tmp_path / "prof"),
                      "profile_from": 2, "profile_steps": 2}}
    cap = tprof.TraceCapture(cfg)
    x = torch.randn(64, 64)
    for step in range(6):
        cap.step(step)
        with torch.profiler.record_function(f"step{step}"):
            x = torch.tanh(x @ x)
    cap.close()
    assert cap.path == str(tmp_path / "prof" / "trace_2.json")
    with open(cap.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"step2", "step3"} <= names and not {"step1", "step4"} & names
    off = tprof.TraceCapture({"system": {}})
    for step in range(12):
        off.step(step)
    off.close()
    assert off.path is None and off.start == 10 and off.n == 5
