"""The port's two native host decoders against their plain Python versions,
PIL and the JAX package: the PNG row unfilter (``csrc/png_unfilter.cpp``
behind ``utils/png.py``) and the PIZ Huffman decoder (``csrc/piz.cpp``
behind ``utils/piz.py``). Both are bitwise. Neither falls back to Python
when its library cannot be built: the read raises."""

import numpy as np
import pytest
from PIL import Image

from esrnerf_tpu.utils import exr as jexr
from esrnerf_tpu.utils import piz as jpiz
from esrnerf_tpu_torch.ops import kernels
from esrnerf_tpu_torch.utils import exr, piz, png

pytestmark = pytest.mark.quick


@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_unfilter_native_matches_plain_and_pil(ftype, C, tmp_path):
    """Each filter type alone and all five in turn, 1-4 bytes a pixel, odd
    widths (1, 7, 33): the native unfilter, the plain one and PIL decode the
    same bytes, the image that was filtered."""
    rng = np.random.default_rng(C)
    for W in (1, 7, 33):
        H = 11
        img = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
        img[:4] = np.linspace(0, 255, W).astype(np.uint8)[None, :, None]
        path = str(tmp_path / f"f{W}.png")
        types = np.arange(H) % 5 if ftype == "mixed" else np.full(H, ftype)
        png.write(path, img, filters=types)
        raw = png._filter_rows(img.reshape(H, W * C), C, types)
        assert set(raw[:, 0]) == ({0, 1, 2, 3, 4} if ftype == "mixed"
                                  else {ftype})
        native = png._unfilter(raw, H, W * C, C)
        np.testing.assert_array_equal(native, png._unfilter_plain(
            raw, H, W * C, C))
        got = png.read(path)
        np.testing.assert_array_equal(got, img[..., 0] if C == 1 else img)
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


def test_unfilter_rejects_a_bad_filter_type():
    raw = np.zeros((3, 1 + 6), np.uint8)
    raw[2, 0] = 7
    for fn in (png._unfilter, png._unfilter_plain):
        with pytest.raises(ValueError, match="bad filter type 7 in row 2"):
            fn(raw, 3, 6, 3)


def _smooth(h, w, c, seed):
    """A smooth image on a 1/64 grid, so that PIZ codes every chunk (an
    incompressible chunk is stored raw)."""
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    chans = [np.sin(6 * xx + k + seed) * yy + 0.1 * k for k in range(c)]
    return (np.round(np.stack(chans, -1) * 128) / 64).astype(np.float32)


@pytest.mark.parametrize("half", [True, False])
def test_huf_native_matches_plain_and_jax(half, tmp_path, monkeypatch):
    """PIZ chunks of EXRs written by both packages' writers: the native
    Huffman decode, the port's Python one and the JAX package's Python one
    give the same symbols, and both packages read the images back bitwise
    to what was written."""
    monkeypatch.setattr(jpiz, "_NATIVE", False)  # the JAX Python decoder
    img = _smooth(70, 45, 3, int(half))
    want = img.astype(np.float16).astype(np.float32) if half else img
    chunks, native = [], piz.huf_uncompress

    def capture(data, n_out):
        chunks.append((bytes(data), n_out))
        return native(data, n_out)

    monkeypatch.setattr(piz, "huf_uncompress", capture)
    for writer in (exr.imwrite, jexr.imwrite):
        path = str(tmp_path / f"{writer.__module__}.exr")
        writer(path, img, half=half, compression="piz")
        n = len(chunks)
        np.testing.assert_array_equal(exr.imread(path)[..., :3], want)
        assert len(chunks) > n  # chunks coded, not stored raw
        np.testing.assert_array_equal(jexr.imread(path)[..., :3], want)
    for data, n_out in chunks:
        got = native(data, n_out)
        np.testing.assert_array_equal(got, piz._huf_uncompress_plain(
            data, n_out))
        np.testing.assert_array_equal(got, jpiz.huf_uncompress(data, n_out))


def test_huf_native_on_long_codes_and_runs():
    """A skewed alphabet (codes longer than the 14-bit table) and long
    runs of one symbol (the run-length pseudo-symbol)."""
    rng = np.random.default_rng(3)
    sym = np.concatenate([
        np.minimum(rng.geometric(0.05, 30000), 4000),
        np.full(3000, 17), rng.integers(0, 65535, 200)]).astype(np.uint16)
    data = piz.huf_compress(sym)
    np.testing.assert_array_equal(piz.huf_uncompress(data, len(sym)), sym)
    np.testing.assert_array_equal(
        piz._huf_uncompress_plain(data, len(sym)), sym)
    with pytest.raises(ValueError, match="native huffman decode failed"):
        piz.huf_uncompress(data, len(sym) + 1)


@pytest.mark.parametrize("name", ["png_unfilter", "piz"])
def test_decoder_build_failure_raises(name, tmp_path, monkeypatch):
    """A missing source or one that does not compile makes the read raise;
    nothing falls back to the Python loop."""
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    path = str(tmp_path / "a.png")
    png.write(path, img)
    exr_path = str(tmp_path / "a.exr")
    exr.imwrite(exr_path, _smooth(32, 45, 3, 0), half=True, compression="piz")
    read = (lambda: png.read(path)) if name == "png_unfilter" else \
        (lambda: exr.imread(exr_path))

    monkeypatch.delitem(kernels._libs, name, raising=False)
    monkeypatch.setitem(kernels.HOST_SOURCES, name, "missing.cpp")
    with pytest.raises(FileNotFoundError):
        read()

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setitem(kernels.HOST_SOURCES, name, "broken.cpp")
    monkeypatch.setattr(kernels, "CSRC", str(src))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        read()
    assert name not in kernels._libs
