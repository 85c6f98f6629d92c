"""``ModelHandler.preprocess`` of encoded image bytes: the JAX handler
decodes them with ``cv2.imdecode`` then BGR -> RGB, the port with
``runtime.decode_bytes`` (Pillow for JPEG, its native decoder for PNG and
BMP). Both handlers' ``preprocess`` alone (no exported engine) on the same
seeded JPEG, PNG and BMP bytes, written with Pillow: the ``images`` arrays
within 1e-5 of max |ref| (the resize is float32 in both), the decoded
pixels equal; ``cv2.imdecode`` applies a JPEG's EXIF orientation, and so
does the port."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from aloception_tpu.export.production.model_handler import \
    ModelHandler as JaxHandler
from aloception_tpu_torch.export.production.model_handler import ModelHandler
from aloception_tpu_torch.runtime import decode_bytes

HW = (48, 64)


def encoded(img: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def seeded(seed, hw=(37, 53)):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, hw + (3,), np.uint8)


@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "BMP"])
def test_preprocess_of_bytes_equals_jax(fmt):
    imgs = [seeded(1), seeded(2, (80, 60))]
    batch = [encoded(im, fmt) for im in imgs]
    want = JaxHandler(input_size=HW).preprocess(batch)
    got = ModelHandler(input_size=HW).preprocess(batch)
    ref = np.asarray(want["images"])
    assert got["images"].shape == ref.shape
    err = np.abs(got["images"].numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    assert (got["mask"].numpy() == np.asarray(want["mask"])).all()
    for b in batch:
        pixels = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
        assert (decode_bytes(b).numpy() == pixels[..., ::-1]).all()


def test_bytes_follow_imdecodes_exif_orientation():
    img = seeded(3, (20, 30))
    exif = Image.Exif()
    exif[0x0112] = 6
    data = encoded(img, "JPEG", exif=exif.tobytes())
    pixels = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert pixels.shape == (30, 20, 3)        # cv2 turned it
    assert (decode_bytes(data).numpy() == pixels[..., ::-1]).all()


def test_bytes_and_arrays_preprocess_alike():
    img = seeded(4)
    handler = ModelHandler(input_size=HW)
    a = handler.preprocess([encoded(img, "PNG")])["images"]
    b = handler.preprocess([img])["images"]
    assert (a == b).all()
